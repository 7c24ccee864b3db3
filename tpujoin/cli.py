"""Command-line driver: the engine's analogue of the reference's
``make join_v1`` / ``./run_test.sh <query>`` entry points (reference
makefile:9-14, run_test.sh:19-33) — one subcommand per workload, with the
reference @main's observable contract: per-phase timing lines, the result
count, and the oracle success flag (reference join_v1.mlir:596-632).

    python -m tpujoin.cli join_v1    --build-rows 1000000 --probe-rows 1000000
    python -m tpujoin.cli join_v2    ...      (same engine; see note below)
    python -m tpujoin.cli selection  --rows 1000000 --threshold 80
    python -m tpujoin.cli nested_loop --build-rows 2000 --probe-rows 2000
    python -m tpujoin.cli aggregate  --rows 1000000
    python -m tpujoin.cli distributed --build-rows 100000 --probe-rows 100000

join_v2 note: the reference's v2 is a *probe-kernel* optimization (shared
-memory result staging, join_v2.mlir:442-605) with identical semantics to
v1. join_v1 runs the engine's v1 (searchsorted) probe and join_v2 its
sort-merge probe; both produce the same multiset.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _timed(label: str, fn, *args, **kwargs):
    # block_until_ready before reading the clock: without it the bracket
    # would time the dispatch, not the device work (the pitfall of the
    # reference's async-region timer brackets, reference run_test.sh:24 +
    # shared.cpp:10-31)
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    dt = time.perf_counter() - t0
    print(f"[{label}] {dt * 1e6:.0f} microseconds", flush=True)
    return out


def _gen_keys(n: int, key_min: int, key_max: int, seed: int,
              distribution: str = "uniform"):
    import jax
    from tpujoin.core import datagen

    k = jax.random.PRNGKey(seed)
    return datagen.make_keys(k, n, key_min, key_max, distribution)


def cmd_join(args, variant: str):
    import jax
    import jax.numpy as jnp
    from tpujoin.ops import hash_join as hj
    from tpujoin.ops import merge_join as mj
    from tpujoin import oracle
    from tpujoin.utils.shapes import round_up

    bk = _gen_keys(args.build_rows, args.key_min, args.key_max, args.seed,
                   args.distribution)
    pk = _gen_keys(args.probe_rows, args.key_min, args.key_max, args.seed + 1,
                   args.distribution)
    jax.block_until_ready((bk, pk))

    if args.how != "inner":
        fn = {"left": mj.left_outer_join, "semi": mj.semi_join,
              "anti": mj.anti_join}[args.how]
        out = _timed(args.how, lambda: fn(np.asarray(bk), np.asarray(pk)))
        rows = len(out[0]) if isinstance(out, tuple) else len(out)
        print(f"result rows: {rows}", flush=True)
        return 0

    ht = _timed("build", lambda: hj.build(bk))
    if variant == "join_v2":
        # v2 = the sort-merge probe pipeline (same semantics as v1,
        # re-engineered hot path — the engine's analogue of the reference's
        # join_v1 -> join_v2 optimization step)
        state, total_a, _ = _timed("count", lambda: mj.probe_count(ht, pk))
        total = int(total_a)
        print(f"result rows: {total}", flush=True)
        cap = round_up(total, 1 << 20)
        r_ids, s_ids, _, fits = _timed(
            "probe", lambda: mj.probe_materialize(ht, state, cap))
        assert bool(fits), "materialize capacity undersized"
    else:
        lo, counts = _timed("count", lambda: hj.probe_count(ht, pk))
        total = int(jnp.sum(counts))
        print(f"result rows: {total}", flush=True)  # cf. join_v1.mlir:596-597
        cap = round_up(total, 1 << 20)
        r_ids, s_ids, _, fits = _timed(
            "probe", lambda: hj.probe_materialize(ht, lo, counts, cap))
        assert bool(fits), "materialize capacity undersized"
    if args.verify:
        ok = oracle.check_join(np.asarray(bk), np.asarray(pk),
                               np.asarray(r_ids[:total]),
                               np.asarray(s_ids[:total]))
        print(f"success: {ok}", flush=True)  # cf. join_v1.mlir:632
        return 0 if ok == 1 else 1
    return 0


def cmd_selection(args):
    import jax
    import jax.numpy as jnp
    from tpujoin.ops import filter as flt

    k = __import__("jax").random.PRNGKey(args.seed)
    vals = jax.random.uniform(k, (args.rows,), jnp.float32, 0.0, 160.0)
    vals.block_until_ready()
    ids, total = _timed(
        "selection",
        lambda: flt.filter_device(
            vals, args.threshold,
            capacity=max(64, 1 << (args.rows - 1).bit_length())))
    total = int(total)
    print(f"result rows: {total}", flush=True)
    if args.verify:
        expected = int((np.asarray(vals) < args.threshold).sum())
        ok = 1 if expected == total and bool(
            (np.asarray(vals)[np.asarray(ids[:total])] < args.threshold).all()
        ) else 0
        print(f"success: {ok}", flush=True)
        return 0 if ok else 1
    return 0


def cmd_nested_loop(args):
    import jax
    from tpujoin.ops.nested_loop_join import nested_loop_join
    from tpujoin import oracle

    bk = np.asarray(_gen_keys(args.build_rows, args.key_min, args.key_max,
                              args.seed))
    pk = np.asarray(_gen_keys(args.probe_rows, args.key_min, args.key_max,
                              args.seed + 1))
    r_ids, s_ids = _timed("nested_loop",
                          lambda: nested_loop_join(bk, pk))
    print(f"result rows: {len(r_ids)}", flush=True)
    if args.verify:
        ok = oracle.check_join(bk, pk, r_ids, s_ids, nested=True)
        print(f"success: {ok}", flush=True)
        return 0 if ok == 1 else 1
    return 0


def cmd_aggregate(args):
    from tpujoin.ops.aggregate import group_by_count
    from tpujoin import oracle

    keys = np.asarray(_gen_keys(args.rows, args.key_min, args.key_max,
                                args.seed, args.distribution))
    gk, gc = _timed("aggregate", lambda: group_by_count(keys))
    print(f"groups: {len(gk)}", flush=True)
    if args.verify:
        ok_k, ok_c = oracle.group_by_count(keys)
        ok = 1 if (np.array_equal(gk, ok_k) and np.array_equal(gc, ok_c)) else 0
        print(f"success: {ok}", flush=True)
        return 0 if ok else 1
    return 0


def cmd_distributed(args):
    from tpujoin.parallel.mesh import make_mesh
    from tpujoin.parallel.shuffle_join import distributed_hash_join
    from tpujoin import oracle

    bk = np.asarray(_gen_keys(args.build_rows, args.key_min, args.key_max,
                              args.seed, args.distribution))
    pk = np.asarray(_gen_keys(args.probe_rows, args.key_min, args.key_max,
                              args.seed + 1, args.distribution))
    mesh = make_mesh(args.devices)
    skew = args.skew or args.distribution == "zipf"
    r_ids, s_ids = _timed(
        "shuffle_join",
        lambda: distributed_hash_join(bk, pk, mesh=mesh, skew=skew),
    )
    print(f"result rows: {len(r_ids)}  devices: {mesh.devices.size}", flush=True)
    if args.verify:
        ok = oracle.check_join(bk, pk, r_ids, s_ids)
        print(f"success: {ok}", flush=True)
        return 0 if ok == 1 else 1
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpujoin",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, rows=False):
        p.add_argument("--key-min", type=int, default=1)
        p.add_argument("--key-max", type=int, default=1_000_000_000)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--distribution", default="uniform",
                       choices=["uniform", "zipf"])
        p.add_argument("--verify", action="store_true")
        if rows:
            p.add_argument("--rows", type=int, default=1_000_000)
        else:
            p.add_argument("--build-rows", type=int, default=1_000_000)
            p.add_argument("--probe-rows", type=int, default=1_000_000)

    for name in ("join_v1", "join_v2"):
        p = sub.add_parser(name, help="chained equi-join workload")
        common(p)
        p.add_argument("--how", default="inner",
                       choices=["inner", "left", "semi", "anti"])
    common(sub.add_parser("nested_loop", help="nested-loop join workload"))
    p = sub.add_parser("selection", help="filter + stream compaction")
    common(p, rows=True)
    p.add_argument("--threshold", type=float, default=80.0)
    common(sub.add_parser("aggregate", help="group-by count"), rows=True)
    p = sub.add_parser("distributed", help="shuffle join over the device mesh")
    common(p)
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--skew", action="store_true",
                   help="heavy-hitter splitting (auto-enabled for zipf)")

    args = ap.parse_args(argv)
    if args.cmd in ("join_v1", "join_v2"):
        return cmd_join(args, args.cmd)
    return {
        "selection": cmd_selection,
        "nested_loop": cmd_nested_loop,
        "aggregate": cmd_aggregate,
        "distributed": cmd_distributed,
    }[args.cmd](args)


if __name__ == "__main__":
    from tpujoin.utils.hw import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
