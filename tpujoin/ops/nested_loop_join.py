"""Nested-loop join with full row materialization.

Capability parity with reference nested-loop.mlir:1-292: the quadratic
fallback join that (a) works for any predicate shape, (b) materializes FULL
result rows (every column of both tables minus the duplicated key,
reference nested-loop.mlir:170-183), and (c) doubles as an on-device
correctness oracle for the hash join (the native C++ oracle in
native/oracle.cpp is the host-side twin, mirroring reference
shared_stuff/shared.cpp:129-171).

Design: the reference's one-thread-per-outer-row scan over the inner
table twice (count pass nested-loop.mlir:78-88, write pass :160-188) becomes
a blocked dense comparison — the [n, m] equality matrix evaluated tile by
tile, compacted with the same cumsum+scatter machinery as the
filter op. Intended for small/medium relations (oracle duty, n*m <= ~1e9);
the hash join is the scalable path, and @main's smaller-table-as-inner
selection (reference nested-loop.mlir:243-263) is irrelevant here because
the dense form is symmetric.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpujoin.core.table import Table
from tpujoin.ops.filter import filter_materialize
from tpujoin.utils.shapes import round_up


@jax.jit
def nested_loop_count(r_keys: jax.Array, s_keys: jax.Array) -> jax.Array:
    """Count pass (reference nested-loop.mlir:78-88): |{(i,j): R[i]==S[j]}|."""
    eq = r_keys[:, None] == s_keys[None, :]
    return jnp.sum(eq.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("capacity",))
def nested_loop_materialize(r_keys, s_keys, capacity: int):
    """Write pass (reference nested-loop.mlir:160-188): all matching
    (rowID_R, rowID_S) pairs, padded to capacity with -1."""
    n, m = r_keys.shape[0], s_keys.shape[0]
    eq = (r_keys[:, None] == s_keys[None, :]).reshape(-1)
    flat, total = filter_materialize(eq, capacity)
    valid = flat >= 0
    r_ids = jnp.where(valid, flat // m, -1).astype(jnp.int32)
    s_ids = jnp.where(valid, flat % m, -1).astype(jnp.int32)
    return r_ids, s_ids, total


def nested_loop_join(r_keys, s_keys, *, pad_multiple: int = 1 << 16):
    """Driver (replaces @main, reference nested-loop.mlir:195-289): exact-size
    (rowID_R, rowID_S) pairs as numpy arrays."""
    r_keys = jnp.asarray(r_keys)
    s_keys = jnp.asarray(s_keys)
    total = int(nested_loop_count(r_keys, s_keys))
    if total == 0:
        return np.empty((0,), np.int32), np.empty((0,), np.int32)
    cap = round_up(total, pad_multiple)
    r_ids, s_ids, _ = nested_loop_materialize(r_keys, s_keys, cap)
    return np.asarray(r_ids[:total]), np.asarray(s_ids[:total])


def materialize_join_rows(
    r: Table, s: Table, r_ids, s_ids, key_column: str = "key"
) -> Table:
    """Full-row result materialization (reference nested-loop.mlir:170-183):
    every column of R plus every column of S except S's copy of the join key,
    gathered at the matching row ids. Columns are prefixed r_/s_."""
    out = {}
    for name, col in r.columns.items():
        out[f"r_{name}"] = jnp.take(col, jnp.asarray(r_ids), axis=0)
    for name, col in s.columns.items():
        if name == key_column:
            continue  # drop the duplicated key column, like the reference
        out[f"s_{name}"] = jnp.take(col, jnp.asarray(s_ids), axis=0)
    return Table(out)
