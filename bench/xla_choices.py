#!/usr/bin/env python
"""The plain-XLA choices the engine makes, timed on the GPU at 100M rows,
and how each of its sorts lowers there.

1. ``jnp.searchsorted`` method (scan, scan_unrolled, sort) for the count
   phase's rank lookup: sorted queries (v2, shuffle join) and unsorted
   queries (v1); the winner is ops.hash_join.SEARCH_METHOD.
2. Compaction of the count state to its matched rows (the RLE result):
   exclusive cumsum + dropping scatter vs the 3-operand sort on the
   masked lower bound.
3. Run expansion: packed markers + cummax (ops.hash_join.expand) vs a
   searchsorted of every output slot over the run offsets.
4. For every sort site: whether XLA hands it to CUB's radix sort (a
   ``__cub$DeviceRadixSort`` custom call) or keeps a sort HLO.

Run: python bench/xla_choices.py [--rows N]. One JSON line per result;
times are medians of 5 after one warmup, each call synced with
block_until_ready.
"""
from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpujoin.ops import aggregate, filter as flt, hash_join as hj  # noqa: E402
from tpujoin.ops import merge_join as mj, multi_join  # noqa: E402
from tpujoin.ops.hash_join import expand  # noqa: E402
from tpujoin.ops.radix import radix_sort  # noqa: E402
from tpujoin.parallel import shuffle_join as sj, skew  # noqa: E402
from tpujoin.parallel.mesh import make_mesh  # noqa: E402
from tpujoin.utils.hw import enable_compile_cache, require_gpu  # noqa: E402
from tpujoin.utils.timing import time_fn  # noqa: E402

METHODS = ("scan", "scan_unrolled", "sort")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timed(name, fn, *args, extra=None, **static):
    st = time_fn(functools.partial(fn, **static), *args, warmup=1, iters=5)
    emit(name=name, seconds=st.seconds, **(extra or {}))


@functools.partial(jax.jit, static_argnames=("method",))
def _ranks(sorted_keys, queries, method):
    lo = jnp.searchsorted(sorted_keys, queries, side="left", method=method)
    hi = jnp.searchsorted(sorted_keys, queries, side="right", method=method)
    return lo, hi - lo


@functools.partial(jax.jit, static_argnames=("k_cap",))
def _compact_scatter(state, k_cap):
    return mj._compact(state, k_cap)


@functools.partial(jax.jit, static_argnames=("k_cap",))
def _compact_sort(state, k_cap):
    mlo = jnp.where(state.counts > 0, state.lo, jnp.int32(0x7FFFFFFF))
    mlo_s, cnt_s, sid_s = jax.lax.sort(
        (mlo, state.counts, state.probe_ids), num_keys=1, is_stable=False)
    lo_s = jnp.where(cnt_s > 0, mlo_s, 0)
    return tuple(jax.lax.slice_in_dim(a, 0, k_cap)
                 for a in (lo_s, cnt_s, sid_s))


@functools.partial(jax.jit, static_argnames=("capacity",))
def _expand_markers(lo, counts, capacity):
    return expand(lo, counts, capacity)


@functools.partial(jax.jit, static_argnames=("capacity", "method"))
def _expand_search(lo, counts, capacity, method):
    offsets = jnp.cumsum(counts) - counts
    t = jnp.arange(capacity, dtype=jnp.int32)
    row = jnp.searchsorted(offsets, t, side="right", method=method) - 1
    row = jnp.clip(row, 0, counts.shape[0] - 1).astype(jnp.int32)
    return row, jnp.take(lo, row) + t - jnp.take(offsets, row)


def lowering(name, fn, *specs):
    text = jax.jit(fn).lower(*specs).compile().as_text()
    cub = len(re.findall(r'custom_call_target="[^"]*cub[^"]*"', text,
                         flags=re.I))
    sorts = len(re.findall(r"= [^=\n]* sort\(", text))
    emit(name=f"lowering/{name}", cub_sort_calls=cub, sort_hlo_ops=sorts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=100_000_000)
    args = ap.parse_args()
    require_gpu("bench/xla_choices.py")
    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit(name="device", kind=jax.devices()[0].device_kind, nvidia_smi=smi)
    run(args.rows)


def run(n: int):
    kb, kp = jax.random.split(jax.random.PRNGKey(0))
    bk = jax.random.randint(kb, (n,), 1, 1_000_000_001, jnp.int32)
    pk = jax.random.randint(kp, (n,), 1, 1_000_000_001, jnp.int32)
    ht = hj.build(bk)
    spk = jnp.sort(pk)
    jax.block_until_ready((ht, spk))

    # 1. searchsorted methods
    for method in METHODS:
        timed(f"ranks/sorted_queries/{method}", _ranks, ht.sorted_keys, spk,
              method=method)
        timed(f"ranks/unsorted_queries/{method}", _ranks, ht.sorted_keys,
              pk, method=method)
    del spk

    # 2. compaction of the low-selectivity count state
    state, total, nonzero = mj.probe_count(ht, pk)
    total, nonzero = int(total), int(nonzero)
    k_cap = -(-nonzero // (1 << 16)) * (1 << 16)
    emit(name="count_state", rows=n, nonzero=nonzero, total=total)
    # the sort is unstable: probe rows of one key may come out permuted,
    # so the two agree as a multiset of (lo, count, probe id) rows
    a, b = (np.stack([np.asarray(x[:nonzero]) for x in c], axis=1)
            for c in (_compact_scatter(state, k_cap),
                      _compact_sort(state, k_cap)))
    same = bool(np.array_equal(a[np.lexsort(a.T[::-1])],
                               b[np.lexsort(b.T[::-1])]))
    del a, b
    timed("compact/cumsum_scatter", _compact_scatter, state, k_cap=k_cap,
          extra={"agree": same})
    timed("compact/sort3_masked_lo", _compact_sort, state, k_cap=k_cap)

    # 3. run expansion, low selectivity (capacity << rows) and the 1B-pair
    # high-selectivity shape (capacity >> rows)
    cap = -(-total // (1 << 20)) * (1 << 20)
    timed("expand/low_sel/markers", _expand_markers, state.lo, state.counts,
          capacity=cap)
    for method in METHODS:
        timed(f"expand/low_sel/search_{method}", _expand_search, state.lo,
              state.counts, capacity=cap, method=method)
    del state
    hk = jax.random.randint(kb, (n // 10,), 1, 100_001, jnp.int32)
    hp = jax.random.randint(kp, (n // 10,), 1, 100_001, jnp.int32)
    hht = hj.build(hk)
    hstate, htotal, _ = mj.probe_count(hht, hp)
    hcap = -(-int(htotal) // (1 << 20)) * (1 << 20)
    timed("expand/high_sel/markers", _expand_markers, hstate.lo,
          hstate.counts, capacity=hcap, extra={"pairs": int(htotal)})
    timed(f"expand/high_sel/search_{hj.SEARCH_METHOD}", _expand_search,
          hstate.lo, hstate.counts, capacity=hcap, method=hj.SEARCH_METHOD)
    del hht, hstate, ht

    # 4. sort lowering at the real shapes (compile only, no allocation)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    bool_ = jax.ShapeDtypeStruct((n,), jnp.bool_)
    lowering("hash_join.build", hj.build, i32)
    lowering("hash_join.probe_count(v1)",
             lambda k, p: hj.probe_count(hj.build(k), p), i32, i32)
    lowering("merge_join.probe_count(v2)",
             lambda k, p: mj.probe_count(hj.build(k), p), i32, i32)
    lowering("merge_join._match_partition",
             lambda k, p: mj._match_partition(mj.probe_count(
                 hj.build(k), p)[0]), i32, i32)
    lowering("compact/sort3_masked_lo",
             lambda k, p: _compact_sort(mj.probe_count(hj.build(k), p)[0],
                                        n // 8), i32, i32)
    lowering("aggregate.group_count", aggregate.group_count, i32)
    lowering("aggregate.group_agg_materialize(num_keys=2)",
             lambda k, v: aggregate.group_agg_materialize(k, v, n // 8),
             i32, i32)
    lowering("filter.filter_materialize", lambda m: flt.filter_materialize(
        m, n // 2), bool_)
    lowering("filter.filter_device", lambda v: flt.filter_device(
        v, 80.0, n // 2), f32)
    lowering("multi_join._push_sort2", lambda h, m: multi_join._push_sort2(
        h, m, n // 2, np.int32(0x7FFFFFFE)), i32, bool_)
    lowering("multi_join._push_sort3", lambda h, m: multi_join._push_sort3(
        h, m, n // 2, np.int32(0x7FFFFFFE)), i32, bool_)
    lowering("radix.radix_sort", radix_sort, i32)
    mesh = make_mesh(1)
    lowering("shuffle_join(presorted, 1 card)",
             sj.make_shuffle_join_presorted_fn(mesh, n, n, n // 8),
             i32, i32, i32, i32, jax.ShapeDtypeStruct((0,), jnp.int32))
    lowering("shuffle_join.splitter_stats(1 card)",
             sj.make_splitter_stats_fn(mesh), i32, i32, i32, i32)
    lowering("skew.make_skew_join_fn(1 card)",
             skew.make_skew_join_fn(mesh, n, n, 4096, 4096, n // 8),
             i32, i32, i32, i32)


if __name__ == "__main__":
    main()
