"""tpujoin — vectorized query-execution engine in JAX.

A brand-new engine covering the capability surface of the reference project
``deveshv-99/mlir-HashJoin`` (single-GPU MLIR hash join / nested-loop join /
selection over columnar i32 data; reference README.md:1,
projectDescription.md:3-4) re-designed as vectorized XLA dataflow:

- every operator is a vectorized, atomics-free dataflow program (sort / scan /
  scatter/gather ops) instead of the reference's SIMT linked-list
  chaining with device atomics (reference join_v1.mlir:213-249);
- exact-size result allocation is done with a count phase + exclusive cumsum
  (the analogue of the reference's @countRows + prefix-sum kernels,
  join_v1.mlir:280-426);
- correctness is gated on exact output-multiset parity with a native C++
  oracle (the analogue of reference shared_stuff/shared.cpp:129-171);
- scale-out is hash partitioning + all-to-all shuffle over a jax.sharding
  Mesh (the reference is single-GPU; distribution is the extension required
  by BASELINE.json).
"""

from tpujoin.core.table import Table
from tpujoin.core.config import JoinConfig, PRESETS
from tpujoin.ops.hash_join import hash_join, HashJoinTable
from tpujoin.ops.merge_join import (
    anti_join,
    left_outer_join,
    merge_join,
    merge_join_rle,
    semi_join,
)
from tpujoin.ops.table_join import join_tables
from tpujoin.ops.multi_join import hash_join_multi, join_with_pushdown
from tpujoin.ops.filter import filter_table
from tpujoin.ops.nested_loop_join import nested_loop_join
from tpujoin.ops.aggregate import group_by_agg, group_by_count
from tpujoin.ops.sort import sort_by_key
from tpujoin.parallel.shuffle_join import distributed_hash_join

__all__ = [
    "Table",
    "JoinConfig",
    "PRESETS",
    "hash_join",
    "HashJoinTable",
    "merge_join",
    "merge_join_rle",
    "semi_join",
    "anti_join",
    "left_outer_join",
    "join_tables",
    "hash_join_multi",
    "join_with_pushdown",
    "filter_table",
    "nested_loop_join",
    "group_by_count",
    "group_by_agg",
    "sort_by_key",
    "distributed_hash_join",
]

__version__ = "0.1.0"
