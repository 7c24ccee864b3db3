"""Selection / filter with stream compaction.

Capability parity with the reference's selection kernel
(reference Experiments/selection.mlir:32-157): evaluate a predicate over a
column and densely compact the passing rows.

The reference's 3-step SIMT pattern — per-thread count over strided elements
(:71-80), single-threaded in-block prefix sum (:88-122), atomic global block
offset (:115), then a scatter pass (:139-153) — collapses into ONE
single-operand i32 sort: pack the fail bit above the row id
(fail << 30 | id) and sort; passing rows float to the front in id order
(compaction IS a stable partition) and the id is recovered with one mask.
No atomics and no block decomposition.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpujoin.core.table import Table
from tpujoin.utils.shapes import round_up


@jax.jit
def filter_count(mask: jax.Array) -> jax.Array:
    """Count phase: exact number of passing rows (the selection analogue of
    the reference's count+prefix pass)."""
    return jnp.sum(mask.astype(jnp.int32))


_FAIL_BIT = 1 << 30   # above any row id; keeps packed values positive i32


@functools.partial(jax.jit, static_argnames=("capacity",))
def filter_materialize(mask: jax.Array, capacity: int):
    """Compact the row ids of passing rows into [capacity] (pad = -1).

    Compaction by ONE single-operand i32 sort of (fail_bit << 30 | id):
    passing rows sort to the front, already in ascending-id order because
    the id occupies the low key bits (a stable partition for free).

    Rows beyond ``capacity`` are dropped (the drivers size capacity from
    filter_count / the returned total, so nothing is silently lost).
    """
    n = mask.shape[0]
    assert n < _FAIL_BIT, "row ids must fit below the fail bit"
    ids = jnp.arange(n, dtype=jnp.int32)
    packed = jnp.where(mask, ids, ids + jnp.int32(_FAIL_BIT))
    s = jax.lax.sort(packed, is_stable=False)   # packed values distinct
    total = jnp.sum(mask.astype(jnp.int32))
    if capacity <= n:
        s = jax.lax.slice_in_dim(s, 0, capacity)
    else:
        s = jnp.pad(s, (0, capacity - n),
                    constant_values=np.int32(_FAIL_BIT))
    t = jnp.arange(capacity, dtype=jnp.int32)
    out = jnp.where(t < total, s & jnp.int32(_FAIL_BIT - 1), -1)
    return out, total


def filter_table(
    table: Table,
    predicate,
    column: str,
    *,
    pad_multiple: int = 1 << 16,
    return_numpy: bool = False,
):
    """Filter driver (replaces @main of selection.mlir:159-195): returns the
    passing rows of ``table`` as a new exact-size Table.

    ``predicate`` is an elementwise jnp function over the column, e.g.
    ``lambda v: v < 80.0`` (the reference's hard-coded predicate at
    selection.mlir:61). With the count known, the passing ids are
    compacted by :func:`filter_materialize` at a bucketed capacity.
    """
    mask = predicate(table[column])
    total = int(filter_count(mask))
    if total == 0:
        empty = Table({n: jnp.empty((0,), c.dtype) for n, c in table.columns.items()})
        return (empty.to_numpy() if return_numpy else empty)
    ids, _ = filter_materialize(mask, round_up(total, pad_multiple))
    out = table.gather(ids[:total])
    if return_numpy:
        return {n: np.asarray(c) for n, c in out.columns.items()}
    return out


@functools.partial(jax.jit, static_argnames=("capacity",))
def filter_device(values: jax.Array, threshold, capacity: int):
    """Single-jit fixed-capacity filter: ids of rows with value < threshold
    (the reference's exact workload, selection.mlir:61) + exact count."""
    mask = values < threshold
    return filter_materialize(mask, capacity)
