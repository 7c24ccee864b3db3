"""Key sort — the engine's foundational primitive.

The reference has no sort (its hash table is a linked list built with
atomics); here the sort IS the hash table: hash_join.build sorts the build
side so bucket lookups become binary search over contiguous runs. Radix sort
is also one of the extension operators BASELINE.json names ("radix sort,
hash aggregate").

Single-device sort defers to ``jax.lax.sort`` — XLA's own sort, which
hands large one-key sorts to the GPU's library radix sort. The
radix machinery lives in :mod:`tpujoin.ops.radix` (digit histogram +
stable reorder), which is what distribution uses for partitioning.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from tpujoin.core.table import Table


@jax.jit
def sort_with_ids(keys: jax.Array):
    """Stable-sort keys ascending; returns (sorted_keys, permutation i32)."""
    ids = jnp.arange(keys.shape[0], dtype=jnp.int32)
    return jax.lax.sort((keys, ids), num_keys=1)


def sort_by_key(table: Table, key_column: str = "key") -> Table:
    """Sort all columns of a table by one key column (stable)."""
    keys = table[key_column]
    others = [n for n in table.column_names if n != key_column]
    operands = (keys,) + tuple(table[n] for n in others)
    sorted_ops = jax.lax.sort(operands, num_keys=1)
    out = {key_column: sorted_ops[0]}
    out.update(dict(zip(others, sorted_ops[1:])))
    return Table(out)
