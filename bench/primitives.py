#!/usr/bin/env python
"""Microbenchmarks of the primitives the join engine is built from, on the
attached GPU. Informs kernel design: what is fast and what is slow among
dense streams, sorts, gathers, scatters and searchsorted methods.

Run: python bench/primitives.py [--small]
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpujoin.utils.hw import (enable_compile_cache, hbm_peak_gbps,  # noqa: E402
                              require_gpu)
from tpujoin.utils.timing import time_fn  # noqa: E402


def report(name, stat, nbytes):
    gbps = nbytes / stat.seconds / 1e9
    print(json.dumps({
        "bench": name, "seconds": stat.seconds, "gbps": gbps,
        "hbm_frac": gbps / hbm_peak_gbps(),
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    require_gpu("bench/primitives.py")
    enable_compile_cache()
    N = 10_000_000 if args.small else 100_000_000
    M = N // 10

    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    data = jax.random.randint(k1, (N,), 1, 1 << 30, dtype=jnp.int32)
    idx = jax.random.randint(k2, (M,), 0, N, dtype=jnp.int32)
    idx_sorted = jnp.sort(idx)
    queries = jax.random.randint(k3, (M,), 1, 1 << 30, dtype=jnp.int32)
    jax.block_until_ready((data, idx, idx_sorted, queries))

    # E0: dense elementwise pass (upper bound sanity)
    f = jax.jit(lambda x: x + 1)
    report("dense_add_N", time_fn(f, data), N * 8)

    # E1: XLA gather, random vs sorted(local) indices
    g = jax.jit(lambda d, i: jnp.take(d, i))
    report("gather_random_M_from_N", time_fn(g, data, idx), M * 8 + N * 4)
    report("gather_sorted_M_from_N", time_fn(g, data, idx_sorted), M * 8 + N * 4)

    # E2: scatter M into N
    s = jax.jit(lambda d, i, v: d.at[i].set(v, mode="drop"))
    vals = jnp.ones((M,), jnp.int32)
    report("scatter_random_M_into_N", time_fn(s, data, idx, vals), M * 8 + N * 4)

    # E3: sort throughput
    srt1 = jax.jit(lambda x: jax.lax.sort(x))
    report("sort_keys_N", time_fn(srt1, data), N * 4)
    ids = jnp.arange(N, dtype=jnp.int32)
    srt2 = jax.jit(lambda x, i: jax.lax.sort((x, i), num_keys=1))
    report("sort_keyval_N", time_fn(srt2, data, ids), N * 8)
    small = data[:M]
    report("sort_keys_M", time_fn(srt1, small), M * 4)

    # E4: searchsorted variants
    sorted_data = jax.lax.sort(data)
    jax.block_until_ready(sorted_data)
    for method in ("sort", "compare_all", "scan_unrolled"):
        if method == "compare_all" and N > 1_000_000:
            continue  # O(N*M) memory
        ss = jax.jit(functools.partial(
            jnp.searchsorted, side="left", method=method))
        try:
            report(f"searchsorted_{method}_M_in_N",
                   time_fn(ss, sorted_data, queries), (N + M) * 4)
        except Exception as e:  # noqa: BLE001
            print(f"searchsorted_{method}: {type(e).__name__}", file=sys.stderr)

    # E5: cumsum
    c = jax.jit(lambda x: jnp.cumsum(x))
    report("cumsum_N", time_fn(c, data), N * 8)


if __name__ == "__main__":
    main()
