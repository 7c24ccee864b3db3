#!/usr/bin/env python
"""Distributed shuffle-join scaling bench (BASELINE.json configs 4-5).

Measures shuffle-join rows/s at mesh sizes 1, 2, 4, ... and reports
weak-scaling efficiency (rows/s per device vs 1 device). One process drives
every card of the host; XLA hands ``all_to_all``/``all_gather``/``psum``
to NCCL. On a machine without GPUs pass --emulate N to exercise the
identical code path on N virtual CPU devices (sharding + collectives
compile and execute; absolute times are not hardware-meaningful but the
path is).

Multi-process bootstrap: call
``tpujoin.parallel.multihost.initialize(coordinator_address, num_processes,
process_id)`` before running; the mesh then spans all processes' devices
and the same code runs unchanged.

Output: one JSON line per mesh size + a summary line with scaling
efficiency.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--emulate", type=int, default=None,
                    help="force N virtual CPU devices")
    ap.add_argument("--rows-per-device", type=int, default=1 << 20)
    ap.add_argument("--key-max", type=int, default=1 << 20)
    ap.add_argument("--skew", action="store_true")
    ap.add_argument("--verify", action="store_true")
    args = ap.parse_args()

    if args.emulate:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={args.emulate}"
        ).strip()

    import jax

    if args.emulate:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from tpujoin import oracle
    from tpujoin.parallel.mesh import make_mesh
    from tpujoin.parallel.shuffle_join import distributed_hash_join
    from tpujoin.utils.hw import enable_compile_cache, require_gpu
    from tpujoin.utils.timing import time_fn

    if not args.emulate:
        require_gpu("bench/dist_bench.py without --emulate")
    enable_compile_cache()
    dev = jax.devices()[0]
    ndev_all = len(jax.devices())
    mesh_sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev_all]
    results = []
    for nd in mesh_sizes:
        rows = args.rows_per_device * nd
        rng = np.random.default_rng(0)
        rk = rng.integers(1, args.key_max + 1, rows).astype(np.int32)
        sk = rng.integers(1, args.key_max + 1, rows).astype(np.int32)
        mesh = make_mesh(nd)
        expected = rows * rows // args.key_max + 1
        # time_fn handles warmup (compile); the driver returns host numpy
        # arrays, so the median wall time is the end-to-end figure
        stat = time_fn(
            lambda: distributed_hash_join(rk, sk, mesh=mesh,
                                          expected_matches=expected,
                                          skew=args.skew),
            name=f"shuffle_join_mesh{nd}", rows=rows)
        r_ids, s_ids = distributed_hash_join(
            rk, sk, mesh=mesh, expected_matches=expected, skew=args.skew)
        dt = stat.seconds
        rps = rows / dt
        rec = {"mesh": nd, "rows": rows, "seconds": dt, "rows_per_sec": rps,
               "rows_per_sec_per_device": rps / nd}
        if args.verify:
            rec["oracle"] = int(oracle.check_join(rk, sk, r_ids, s_ids))
        results.append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)

    base = results[0]["rows_per_sec_per_device"]
    eff = results[-1]["rows_per_sec_per_device"] / base if base else 0.0
    summary = {
        "metric": "shuffle_join_weak_scaling_efficiency",
        "value": eff,
        "unit": f"frac (1->{mesh_sizes[-1]} devices)",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": ndev_all},
    }
    if args.emulate:
        # N virtual devices time-share 2 host cores: wall-clock efficiency
        # here measures host contention, not the algorithm. The honest
        # emulated artifact is oracle=1 at every mesh size; suppress the
        # vs-target ratio so this line cannot be misquoted.
        summary["environment"] = "emulated-cpu-contention-bound"
        summary["vs_baseline"] = None
    else:
        summary["vs_baseline"] = eff / 0.7   # BASELINE.json target: >= 70%
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
