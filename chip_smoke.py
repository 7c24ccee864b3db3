#!/usr/bin/env python
"""Smoke test of the join engine on the GPU: each phase drives one user
entry point at the reference's real sizes, twice, and checks the second
result exactly against the plain reference (the native oracle, NumPy, or
the full-coverage checksums of tpujoin.utils.verify).

    python chip_smoke.py               # one card: six phases
    python chip_smoke.py --four-cards  # the shuffle join on four cards only

Every compared value is an integer id, a count or an exact 64-bit sum, and
the filter predicate is one f32 comparison; no matrix product is involved,
so TF32 does not apply and every comparison is exact equality.

Per phase it prints the wall time of the first call (compiles included)
and of the second, the device memory peak so far (``memory_stats()``),
and PASS or FAIL. The last stdout line is one JSON object naming the
device; it is printed only when every phase passed. Without a GPU the
script exits non-zero before running anything.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

from tpujoin import oracle
from tpujoin.core import datagen
from tpujoin.core.config import PRESETS
from tpujoin.utils import hw


def _peak_bytes() -> int:
    return max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
               for d in jax.local_devices())


def run_phase(name: str, call, check) -> bool:
    """Call ``call`` twice, then ``check`` its second result; print one
    line. An exception fails the phase (the traceback goes to stderr) and
    the remaining phases still run."""
    try:
        t0 = time.perf_counter()
        out = jax.block_until_ready(call())
        first = time.perf_counter() - t0
        out = None
        t0 = time.perf_counter()
        out = jax.block_until_ready(call())
        second = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok = bool(check(out))
        check_s = time.perf_counter() - t0
        detail = (f"first {first:.3f} s (with compile), second "
                  f"{second:.3f} s, check {check_s:.1f} s")
    except Exception:  # noqa: BLE001 — reported as FAIL, never swallowed
        traceback.print_exc()
        ok, detail = False, "raised"
    out = None
    gc.collect()
    print(f"phase {name}: {detail}, device peak so far {_peak_bytes()} B: "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    return ok


def _keys(cfg, seed_offset=0):
    rng_r, rng_s = jax.random.split(jax.random.PRNGKey(cfg.seed + seed_offset))
    bk = datagen.make_keys(rng_r, cfg.build_rows, cfg.key_min, cfg.key_max,
                           cfg.distribution, cfg.zipf_s)
    pk = datagen.make_keys(rng_s, cfg.probe_rows, cfg.key_min, cfg.key_max,
                           cfg.distribution, cfg.zipf_s)
    return jax.block_until_ready((bk, pk))


def phase_low_selectivity() -> bool:
    from tpujoin.ops.hash_join import hash_join
    from tpujoin.ops.merge_join import merge_join

    bk, pk = _keys(PRESETS["ref_low_selectivity"])
    bk_np, pk_np = np.asarray(bk), np.asarray(pk)

    def check(out):
        r, s = out
        return oracle.check_join(bk_np, pk_np, r, s) == 1

    ok = run_phase("ref_low_selectivity/merge_join (v2) 100M x 100M",
                   lambda: merge_join(bk, pk), check)
    ok &= run_phase("ref_low_selectivity/hash_join (v1) 100M x 100M",
                    lambda: hash_join(bk, pk), check)
    return ok


def phase_high_selectivity() -> bool:
    import bench

    cfg = PRESETS["ref_high_selectivity"]

    def check(out):
        d, verify = out
        d.update(verify())
        print(f"  result_rows {d['result_rows']} pairs_checked "
              f"{d.get('pairs_checked')}", flush=True)
        return d["verified"] and d.get("pairs_checked") == d["result_rows"]

    # run_join_dense is bench_join_dense with its verification handed
    # back, so the check covers the timed run's own result
    return run_phase("ref_high_selectivity/bench_join_dense 10M x 10M",
                     lambda: bench.run_join_dense(cfg), check)


def phase_zipf() -> bool:
    from tpujoin.ops.merge_join import merge_join_rle

    bk, pk = _keys(PRESETS["zipf_skew"])
    bk_np, pk_np = np.asarray(bk), np.asarray(pk)

    def check(out):
        pid, lo, cnt, sbi = out
        print(f"  RLE rows {len(pid)} pairs "
              f"{int(cnt.astype(np.int64).sum())}", flush=True)
        return oracle.check_join_rle(bk_np, pk_np, sbi, pid, lo, cnt) == 1

    return run_phase("zipf_skew/merge_join_rle 10M x 10M",
                     lambda: merge_join_rle(bk, pk), check)


def phase_aggregate(rows: int = 100_000_000) -> bool:
    from tpujoin.ops.aggregate import group_by_agg

    keys = datagen.make_keys(jax.random.PRNGKey(0), rows, 1, rows // 10)
    vals = datagen.make_keys(jax.random.PRNGKey(1), rows, 0, 1_000_000)
    keys_np, vals_np = np.asarray(keys), np.asarray(vals)

    def check(out):
        print(f"  groups {len(out[0])}", flush=True)
        return oracle.check_group_agg(keys_np, vals_np, *out)

    return run_phase("aggregate/group_by_agg 100M rows",
                     lambda: group_by_agg(keys, vals), check)


def phase_filter(rows: int = 100_000_000) -> bool:
    from tpujoin.core.table import Table
    from tpujoin.ops.filter import filter_table

    vals = jax.random.uniform(jax.random.PRNGKey(0), (rows,), jnp.float32,
                              0.0, 160.0)
    table = Table({"v": vals, "id": jnp.arange(rows, dtype=jnp.int32)})
    v_np = np.asarray(vals)

    def check(out):
        ids = out["id"]
        return (len(ids) == int((v_np < 80.0).sum())
                and bool((v_np[ids] < 80.0).all())
                and bool((np.diff(ids) > 0).all())
                and np.array_equal(out["v"], v_np[ids]))

    return run_phase(
        "filter/filter_table 100M rows",
        lambda: filter_table(table, lambda v: v < 80.0, "v",
                             return_numpy=True), check)


def phase_multi_join(rows: int = 100_000_000) -> bool:
    from bench import multi_join_expected
    from tpujoin.core.table import Table
    from tpujoin.ops.multi_join import hash_join_multi, join_with_pushdown

    ks = jax.random.split(jax.random.PRNGKey(7), 6)
    r = Table({"k1": datagen.make_keys(ks[0], rows, 1, 100_000),
               "k2": datagen.make_keys(ks[1], rows, 1, 10_000),
               "v": datagen.make_keys(ks[2], rows, 0, 1000)})
    s = Table({"k1": datagen.make_keys(ks[3], rows, 1, 100_000),
               "k2": datagen.make_keys(ks[4], rows, 1, 10_000),
               "v": datagen.make_keys(ks[5], rows, 0, 1000)})
    cols = {f"{side}{c}": np.asarray(t[c]) for side, t in (("r", r), ("s", s))
            for c in ("k1", "k2", "v")}

    def checker(pushdown: bool):
        def check(out):
            r_ids, s_ids = out
            ok = bool((cols["rk1"][r_ids] == cols["sk1"][s_ids]).all()
                      and (cols["rk2"][r_ids] == cols["sk2"][s_ids]).all())
            keep = {}
            if pushdown:
                ok &= bool((cols["rv"][r_ids] < 500).all()
                           and (cols["sv"][s_ids] < 500).all())
                keep = {"r_keep": r["v"] < 500, "s_keep": s["v"] < 500}
            pairs = (r_ids.astype(np.int64) << 32) | s_ids
            expected = int(multi_join_expected(r["k1"], r["k2"], s["k1"],
                                               s["k2"], **keep))
            print(f"  rows {len(r_ids)} expected {expected}", flush=True)
            # valid pairs, none repeated, and as many as the reference
            # counts: the exact pair set
            return (ok and len(np.unique(pairs)) == len(pairs)
                    and len(pairs) == expected)
        return check

    ok = run_phase("multi_join/hash_join_multi 100M x 100M",
                   lambda: hash_join_multi(r, s, ["k1", "k2"]),
                   checker(False))
    ok &= run_phase(
        "multi_join/join_with_pushdown 100M x 100M",
        lambda: join_with_pushdown(
            r, s, ["k1", "k2"], r_pred=lambda v: v < 500, r_pred_col="v",
            s_pred=lambda v: v < 500, s_pred_col="v"), checker(True))
    return ok


def _exchange_placement(mesh, rk, sk):
    """One presorted shuffle-join step on row-sharded inputs, as
    distributed_hash_join runs it: per card, the device it ran on and the
    share of its result's probe ids that started on another card."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpujoin.parallel.mesh import ROW_AXIS
    from tpujoin.parallel.shuffle_join import (
        _coarse_cap, make_shuffle_join_presorted_fn, make_splitter_stats_fn)

    ndev = mesh.shape[ROW_AXIS]
    ids = np.arange(len(rk), dtype=np.int32)
    shard = NamedSharding(mesh, P(ROW_AXIS))
    args = [jax.device_put(x, shard) for x in (rk, ids, sk, ids)]
    *sorted_, maxes = make_splitter_stats_fn(mesh)(*args)
    maxes = np.asarray(maxes)
    fn = make_shuffle_join_presorted_fn(
        mesh, _coarse_cap(int(maxes[0])), _coarse_cap(int(maxes[1])),
        -(-len(rk) // ndev))
    _, s_out, totals, _ = fn(*sorted_)
    totals = np.asarray(totals)
    per_card = len(sk) // ndev
    out = []
    for d, sh in enumerate(sorted(s_out.addressable_shards,
                                  key=lambda x: x.index[0].start)):
        got = np.asarray(sh.data)[:totals[d]]
        out.append((sh.device.id, float(np.mean(got // per_card != d))))
    return out


def _placement_ok(out, ndev) -> bool:
    for dev, moved in out:
        print(f"  card {dev}: {moved:.3f} of its result's probe rows came "
              f"from other cards", flush=True)
    return (len({dev for dev, _ in out}) == ndev
            and all(moved > 0.5 for _, moved in out))


def _skew_routing_ok(out, exp) -> bool:
    _, _, totals, ovf = out
    pairs = int(np.asarray(totals).sum())
    print(f"  replicated rows per card at most: build {ovf[3]}, probe "
          f"{ovf[4]}; pairs {pairs} expected {exp[0]}", flush=True)
    return pairs == exp[0] and ovf[3] + ovf[4] > 0


# a key far out in the Zipf tail, planted on more build rows than one
# card's fair share so the skew path's default threshold makes it heavy
HEAVY_KEY = 999_999_999


def four_card_phases(rows_per_card: int = 100_000_000) -> bool:
    """The shuffle join on every local card: plain, skew splitting and the
    pipelined exchange, each checked against the NumPy expectation by the
    order-invariant multiset checksum (pairs_checked == result_rows); the
    exchange's placement and the skew step's replica telemetry; then the
    six-program dry run."""
    from tpujoin.parallel.skew import run_skew_join
    import __graft_entry__
    from tpujoin.parallel.mesh import make_mesh
    from tpujoin.parallel.shuffle_join import distributed_hash_join
    from tpujoin.utils.verify import (expected_multiset_sum_pairs,
                                      host_join_expectation)

    ndev = len(jax.devices())
    mesh = make_mesh(ndev)
    n = rows_per_card * ndev
    key = jax.random.PRNGKey(11)
    kr, ks, kz = jax.random.split(key, 3)
    rk = np.asarray(datagen.uniform_keys(kr, n, 1, 1_000_000_000))
    sk = np.asarray(datagen.uniform_keys(ks, n, 1, 1_000_000_000))
    # skew: a Zipf(1.0) probe against the uniform build (a Zipf build too
    # would make ~10^14 pairs at this size), with HEAVY_KEY planted on
    # every third build row up to just over one card's share and on one
    # probe row per card: the build rows of HEAVY_KEY are sprayed across
    # the cards and its probe rows replicated to every card
    sz = np.array(datagen.zipf_keys(kz, n, 1, 1_000_000_000, 1.0))
    rk_heavy = rk.copy()
    rk_heavy[::3][:rows_per_card + n // 100] = HEAVY_KEY
    sz[::rows_per_card] = HEAVY_KEY
    t0 = time.perf_counter()
    exp_uniform = host_join_expectation(rk, sk)
    exp_skew = host_join_expectation(rk_heavy, sz)
    print(f"host expectations: uniform {exp_uniform[0]} pairs, skew "
          f"{exp_skew[0]} pairs, {time.perf_counter() - t0:.1f} s",
          flush=True)

    def checker(exp):
        def check(out):
            r_ids, s_ids = out
            got = (len(r_ids), expected_multiset_sum_pairs(r_ids, s_ids))
            print(f"  result_rows {got[0]} expected {exp[0]} "
                  f"pairs_checked {got[0] if got == exp else 0}", flush=True)
            return got == exp
        return check

    ok = run_phase(f"shuffle_join/exchange placement {ndev} cards",
                   lambda: _exchange_placement(mesh, rk, sk),
                   lambda out: _placement_ok(out, ndev))
    ok &= run_phase(f"shuffle_join/uniform {ndev} cards x {rows_per_card}",
                   lambda: distributed_hash_join(rk, sk, mesh=mesh),
                   checker(exp_uniform))
    ok &= run_phase(f"shuffle_join/skew zipf1.0 {ndev} cards x "
                    f"{rows_per_card}",
                    lambda: distributed_hash_join(rk_heavy, sz, mesh=mesh,
                                                  skew=True),
                    checker(exp_skew))
    ok &= run_phase(f"shuffle_join/skew routing {ndev} cards x "
                    f"{rows_per_card}",
                    lambda: run_skew_join(rk_heavy, sz, mesh=mesh,
                                          slack=2.0),
                    lambda out: _skew_routing_ok(out, exp_skew))
    ok &= run_phase(f"shuffle_join/pipeline_chunks=2 {ndev} cards x "
                    f"{rows_per_card}",
                    lambda: distributed_hash_join(rk, sk, mesh=mesh,
                                                  pipeline_chunks=2),
                    checker(exp_uniform))
    ok &= run_phase(f"dryrun_multichip({ndev})",
                    lambda: __graft_entry__.dryrun_multichip(ndev),
                    lambda _: True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the shuffle join across four cards")
    args = ap.parse_args()
    hw.require_gpu("chip_smoke.py")
    ndev = len(jax.devices())
    if args.four_cards and ndev != 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {ndev}")
    cache = hw.enable_compile_cache()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {line}", flush=True)
    dev = jax.devices()[0]
    print(f"jax {jax.__version__}, {ndev} x {dev.device_kind}, "
          f"HBM peak {hw.hbm_peak_gbps(dev)} GB/s, compile cache {cache}, "
          f"oracle {'native' if oracle.have_native() else 'numpy'}",
          flush=True)

    if args.four_cards:
        ok = four_card_phases()
    else:
        ok = True
        for phase in (phase_low_selectivity, phase_high_selectivity,
                      phase_zipf, phase_aggregate, phase_filter,
                      phase_multi_join):
            ok &= phase()
    if not ok:
        print("chip_smoke: FAIL", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": ndev}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
