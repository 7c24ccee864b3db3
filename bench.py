#!/usr/bin/env python
"""Benchmark driver: hash-join throughput vs the reference's published bar.

By default (on a GPU; without one it exits non-zero) this benchmarks BOTH
reference configs
(join-performances.md:1-24) and VERIFIES each result against the oracle —
the reference checks every run (shared.cpp:167-171, join_v1.mlir:628-632),
so the captured benchmark artifact proves speed AND parity:

  ref_low_selectivity   100M x 100M, keys 1..1e9  => ~10M pairs; full
                        native multiset oracle on the materialized pairs
  ref_high_selectivity  10M x 10M, keys 1..100k   => ~1B pairs; native
                        RLE oracle on the factorized result + sampled
                        window checks of the materialized pair columns

Headline metric (printed as ONE JSON line on stdout): probe rows/s on the
low-selectivity config vs the reference's ~8.3M rows/s (~12 s total,
join-performances.md:11). The same line carries a ``configs`` object with
both configs' phase times, materialized totals, per-config vs_ref, and
``verified`` flags. Per-phase detail goes to stderr.

Usage: python bench.py [--config NAME] [--no-verify] [--scale F]

Only an explicit ``--config`` (or ``--rows`` for ``--op``) run may use the
CPU, as the tests do.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpujoin.core.config import PRESETS, JoinConfig
from tpujoin.core import datagen
from tpujoin.ops import hash_join as hj_mod
from tpujoin.utils import hw
from tpujoin.utils.hw import hbm_peak_gbps
from tpujoin.utils.shapes import round_up
from tpujoin.utils.timing import time_fn

# the reference's own published GPU probe throughput on this workload
# (join-performances.md:11: 1e8 probe rows / ~12 s)
REFERENCE_PROBE_ROWS_PER_SEC = 8.3e6


def eprint(*a):
    print(*a, file=sys.stderr, flush=True)


# ---- full-coverage verification of materialized ~1B-pair results ----
#
# The reference's oracle gate checks EVERY pair of every run
# (shared.cpp:154-171). Full coverage here is split: (1) the factorized
# RLE form is fully checked by the native oracle — that IS the join;
# (2) every materialized slot is covered by device-reduced 64-bit
# checksums compared against host-side streaming recomputation. The
# machinery lives in tpujoin.utils.verify (shared with the distributed
# checks); aliases below keep this module's historical names.

from tpujoin.utils.verify import (  # noqa: E402
    VERIFY_WINDOW as _VERIFY_WINDOW,
    expected_checksums as _expected_checksums,
    multiset_checksum as _multiset_checksum,
    window_checksums as _window_checksums,
)


# per-config cache of the oracle-verified RLE form + its host-derived
# checksums, so the v1 entry of the benchmark matrix can verify its
# differently-ordered 1B-pair output against the SAME verified expectation
# without recomputing the ~1-minute host expansion
_RLE_CACHE: dict = {}


def _verify_dense(bk, pk, ht, state, k_cap, nonzero, mat, total,
                  cache_name: str = "") -> bool:
    """Parity gate for ~1B-pair results: native RLE oracle on the full
    factorized result (every run checked against the recomputed join),
    then full-coverage window checksums of the materialized pair columns
    against the verified RLE form — pairs_checked == result_rows, the
    reference's every-pair gate (shared.cpp:154-171)."""
    from tpujoin import oracle
    from tpujoin.ops import merge_join as mj_mod

    sid, lo, cnt = mj_mod.probe_rle(ht, state, k_cap)
    sid = np.asarray(sid[:nonzero])
    lo = np.asarray(lo[:nonzero])
    cnt = np.asarray(cnt[:nonzero])
    rle_ok = oracle.check_join_rle(
        np.asarray(bk), np.asarray(pk), np.asarray(ht.sorted_ids),
        sid, lo, cnt) == 1
    eprint(f"RLE oracle parity: {'PASS' if rle_ok else 'FAIL'}")

    # full-coverage materialization check vs the (just verified) RLE form
    r_ids, s_ids, total_dev = mat()
    cap = r_ids.shape[0]
    num_windows = cap // _VERIFY_WINDOW
    got_hi, got_lo = _window_checksums(r_ids, s_ids,
                                       jnp.asarray(total_dev), num_windows)
    got_hi, got_lo = np.asarray(got_hi), np.asarray(got_lo)
    src = np.asarray(ht.sorted_ids)
    exp_hi, exp_lo, msum = _expected_checksums(src, sid, lo, cnt, total,
                                               num_windows)
    if rle_ok:
        _RLE_CACHE[cache_name] = {"total": total, "msum": msum}
    bad = int((got_hi != exp_hi).sum() + (got_lo != exp_lo).sum())
    win_ok = bad == 0
    eprint(f"materialized full-coverage parity ({num_windows} windows, "
           f"{total} pairs checked): {'PASS' if win_ok else 'FAIL'}"
           + ("" if win_ok else f" ({bad} window mismatches)"))
    return bool(rle_ok and win_ok)


def bench_join_dense(cfg: JoinConfig, verify: bool) -> dict:
    """High-selectivity configs (result >> memory comfort, e.g. the
    reference's 10Mx10M / ~1B-pair workload, join-performances.md:3-6):
    benchmark the factorized (RLE) result — the engine's native exact form —
    AND the full 1B-pair materialization (the reference holds it in 8.5 GB
    of GPU memory, join-performances.md:5)."""
    out, check = run_join_dense(cfg)
    if verify:
        out.update(check())
    return out


def run_join_dense(cfg: JoinConfig):
    """The timed part of :func:`bench_join_dense`. Returns (out, check):
    ``check()`` verifies this run's own count state and materialization
    and returns {"verified", "pairs_checked"} (the latter only when the
    pairs were materialized)."""
    from tpujoin.ops import merge_join as mj_mod

    rng_r, rng_s = jax.random.split(jax.random.PRNGKey(cfg.seed))
    bk = datagen.make_keys(rng_r, cfg.build_rows, cfg.key_min, cfg.key_max,
                           cfg.distribution, cfg.zipf_s)
    pk = datagen.make_keys(rng_s, cfg.probe_rows, cfg.key_min, cfg.key_max,
                           cfg.distribution, cfg.zipf_s)
    jax.block_until_ready((bk, pk))

    build_stat = time_fn(hj_mod.build, bk, name="build", rows=cfg.build_rows)
    ht = hj_mod.build(bk)
    count_stat = time_fn(mj_mod.probe_count, ht, pk, name="count",
                         rows=cfg.probe_rows)
    state, total_a, nonzero_a = mj_mod.probe_count(ht, pk)
    total, nonzero = int(total_a), int(nonzero_a)
    k_cap = round_up(nonzero, 1 << 20)
    # RLE compaction is the identity when every probe row matched
    all_matched = nonzero == cfg.probe_rows
    rle_stat = time_fn(lambda: mj_mod.probe_rle(ht, state, k_cap,
                                                all_matched=all_matched),
                       name="rle_result", rows=nonzero)

    # pair materialization only when the full result fits HBM (Zipf-skew
    # workloads reach ~10^11 pairs — the factorized RLE result above IS
    # the exact join then; the reference cannot run those at all)
    materializable = total <= (1 << 30) + (1 << 28)
    mat_stat = mat = None
    if materializable:
        cap = round_up(total, 1 << 20)

        def mat():
            return mj_mod.probe_materialize(ht, state, cap)[:3]

        mat_stat = time_fn(mat, name="materialize_pairs", rows=total,
                           bytes_touched=cap * 8)
    for st in (build_stat, count_stat, rle_stat, mat_stat):
        if st is not None:
            eprint(json.dumps(st.as_dict()))

    def check() -> dict:
        if materializable:
            verified = _verify_dense(bk, pk, ht, state, k_cap, nonzero,
                                     mat, total, cache_name=cfg.name)
            # every materialized pair is covered by the window checksums
            return {"verified": verified,
                    "pairs_checked": total if verified else 0}
        from tpujoin import oracle
        sid, lo, cnt = mj_mod.probe_rle(ht, state, k_cap)
        verified = oracle.check_join_rle(
            np.asarray(bk), np.asarray(pk), np.asarray(ht.sorted_ids),
            np.asarray(sid[:nonzero]), np.asarray(lo[:nonzero]),
            np.asarray(cnt[:nonzero])) == 1
        eprint(f"RLE oracle parity: {'PASS' if verified else 'FAIL'}")
        return {"verified": verified}

    probe_seconds = count_stat.seconds + rle_stat.seconds
    dev = jax.devices()[0]
    out = {
        "engine": "v2-rle",
        "config": cfg.name,
        "device": getattr(dev, "device_kind", str(dev)),
        "build_rows": cfg.build_rows,
        "probe_rows": cfg.probe_rows,
        "result_rows": total,
        "build_seconds": build_stat.seconds,
        "count_seconds": count_stat.seconds,
        "materialize_seconds": rle_stat.seconds,
        "total_seconds": build_stat.seconds + probe_seconds,
        "probe_rows_per_sec": cfg.probe_rows / probe_seconds,
        "hbm_peak_gbps": hbm_peak_gbps(dev),
        "verified": None,
    }
    if mat_stat is not None:
        out.update({
            "pair_expansion_rows_per_sec": total / mat_stat.seconds,
            "pair_materialize_seconds": mat_stat.seconds,
            "total_seconds_materialized": (build_stat.seconds
                                           + count_stat.seconds
                                           + mat_stat.seconds),
        })
    return out, check


def _rle_expectation(cfg: JoinConfig, bk, pk) -> dict:
    """Oracle-verified {total, msum} for the config's full pair multiset,
    derived from the v2 RLE form (cached when the v2 entry of the matrix
    ran first; recomputed + natively oracle-checked otherwise)."""
    if cfg.name in _RLE_CACHE:
        return _RLE_CACHE[cfg.name]
    from tpujoin import oracle
    from tpujoin.ops import merge_join as mj_mod

    ht = hj_mod.build(bk)
    state, total_a, nonzero_a = mj_mod.probe_count(ht, pk)
    total, nonzero = int(total_a), int(nonzero_a)
    k_cap = round_up(nonzero, 1 << 20)
    sid, lo, cnt = mj_mod.probe_rle(ht, state, k_cap)
    sid = np.asarray(sid[:nonzero])
    lo = np.asarray(lo[:nonzero])
    cnt = np.asarray(cnt[:nonzero])
    assert oracle.check_join_rle(
        np.asarray(bk), np.asarray(pk), np.asarray(ht.sorted_ids),
        sid, lo, cnt) == 1, "RLE oracle failed while building expectation"
    nw = (total + _VERIFY_WINDOW - 1) // _VERIFY_WINDOW
    _, _, msum = _expected_checksums(np.asarray(ht.sorted_ids), sid, lo,
                                     cnt, total, nw)
    _RLE_CACHE[cfg.name] = {"total": total, "msum": msum}
    return _RLE_CACHE[cfg.name]


def bench_join_dense_v1(cfg: JoinConfig, verify: bool,
                        num_chunks: int = 4,
                        cap_bucket: int = 1 << 28,
                        rle_only: bool = False) -> dict:
    """v1 (searchsorted engine) on high-selectivity configs: the probe
    side streams in chunks (the v1 driver's documented bounded-result
    streaming) because the XLA searchsorted expansion allocates sort temps
    ~2x the result width — a single ~1B-slot materialization plus temps
    exceeds HBM, where the reference holds its 8.5 GB result wholesale
    (join-performances.md:5). Every produced pair is verified via the
    order-invariant multiset checksum against the RLE expectation
    (pairs_checked == result_rows); v1 emits pairs in unsorted-probe
    order, so the position-sensitive window checksums don't apply."""
    rng_r, rng_s = jax.random.split(jax.random.PRNGKey(cfg.seed))
    bk = datagen.make_keys(rng_r, cfg.build_rows, cfg.key_min, cfg.key_max,
                           cfg.distribution, cfg.zipf_s)
    pk = datagen.make_keys(rng_s, cfg.probe_rows, cfg.key_min, cfg.key_max,
                           cfg.distribution, cfg.zipf_s)
    jax.block_until_ready((bk, pk))

    build_stat = time_fn(hj_mod.build, bk, name="build",
                         rows=cfg.build_rows, iters=1)
    ht = hj_mod.build(bk)

    if rle_only:
        # v1's factorized answer alone (the default-matrix cell); the
        # dense chunked materialization runs behind --engine v1
        rle_stat = time_fn(lambda: hj_mod.probe_count(ht, pk),
                           name="v1_rle", rows=cfg.probe_rows,
                           warmup=1, iters=3)
        lo_f, cnt_f = hj_mod.probe_count(ht, pk)
        total = int(jnp.sum(cnt_f.astype(jnp.int64)))
        rle_verified = None
        if verify:
            from tpujoin import oracle
            rle_verified = oracle.check_join_rle(
                np.asarray(bk), np.asarray(pk), np.asarray(ht.sorted_ids),
                np.arange(cfg.probe_rows, dtype=np.int32),
                np.asarray(lo_f), np.asarray(cnt_f)) == 1
            eprint(f"v1 RLE oracle parity: "
                   f"{'PASS' if rle_verified else 'FAIL'}")
        dev = jax.devices()[0]
        return {
            "engine": "v1-rle",
            "config": cfg.name,
            "device": getattr(dev, "device_kind", str(dev)),
            "build_rows": cfg.build_rows,
            "probe_rows": cfg.probe_rows,
            "result_rows": total,
            "build_seconds": build_stat.seconds,
            "rle_result_seconds": rle_stat.seconds,
            "total_seconds": build_stat.seconds + rle_stat.seconds,
            "total_seconds_rle": build_stat.seconds + rle_stat.seconds,
            "probe_rows_per_sec": cfg.probe_rows / rle_stat.seconds,
            "rle_verified": rle_verified,
            "hbm_peak_gbps": hbm_peak_gbps(dev),
            "verified": rle_verified,
        }

    chunk = cfg.probe_rows // num_chunks
    assert chunk * num_chunks == cfg.probe_rows
    count_secs = mat_secs = 0.0
    grand_total = 0
    acc = 0
    seen_caps: set = set()
    for ci in range(num_chunks):
        start = ci * chunk
        pk_c = jax.lax.slice_in_dim(pk, start, start + chunk)
        st = time_fn(lambda: hj_mod.probe_count(ht, pk_c),
                     warmup=1 if ci == 0 else 0, iters=1,
                     name=f"count[{ci}]")
        count_secs += st.seconds
        lo, counts = hj_mod.probe_count(ht, pk_c)
        total_c = int(jnp.sum(counts))
        grand_total += total_c
        # coarse capacity bucket: all chunks of a uniform config share one
        # compiled materialize executable
        cap_c = round_up(max(total_c, 1), cap_bucket)
        st2 = time_fn(lambda: hj_mod.probe_materialize(
            ht, lo, counts, cap_c, probe_base=start),
            warmup=0 if cap_c in seen_caps else 1, iters=1,
            name=f"materialize[{ci}]")
        seen_caps.add(cap_c)
        mat_secs += st2.seconds
        if verify:
            r_c, s_c, t_c, fits = hj_mod.probe_materialize(
                ht, lo, counts, cap_c, probe_base=start)
            assert bool(fits)
            hi, lo32 = _multiset_checksum(r_c, s_c, t_c,
                                          cap_c // _VERIFY_WINDOW)
            acc = (acc + ((int(hi) << 32) | int(lo32))) % (1 << 64)

    verified = None
    if verify:
        exp = _rle_expectation(cfg, bk, pk)
        verified = grand_total == exp["total"] and acc == exp["msum"]
        eprint(f"v1 multiset checksum over {grand_total} pairs "
               f"({num_chunks} chunks): {'PASS' if verified else 'FAIL'}")

    # v1 factorized (RLE) result: probe_count's (lo, counts) in probe
    # order IS the run-length join — zero expansion cost (the v2 analogue
    # is the rle_result phase). Timed on the full unchunked probe;
    # RLE-oracle-verified under --verify.
    rle_stat = time_fn(lambda: hj_mod.probe_count(ht, pk), name="v1_rle",
                       rows=cfg.probe_rows, warmup=1, iters=3)
    rle_total = build_stat.seconds + rle_stat.seconds
    rle_verified = None
    if verify:
        from tpujoin import oracle
        lo_f, cnt_f = hj_mod.probe_count(ht, pk)
        rle_verified = oracle.check_join_rle(
            np.asarray(bk), np.asarray(pk), np.asarray(ht.sorted_ids),
            np.arange(cfg.probe_rows, dtype=np.int32), np.asarray(lo_f),
            np.asarray(cnt_f)) == 1
        eprint(f"v1 RLE oracle parity: {'PASS' if rle_verified else 'FAIL'}")

    total_seconds = build_stat.seconds + count_secs + mat_secs
    eprint(json.dumps({"phase": "v1_dense", "build": build_stat.seconds,
                       "count": count_secs, "materialize": mat_secs,
                       "chunks": num_chunks}))
    dev = jax.devices()[0]
    out = {
        "engine": "v1",
        "config": cfg.name,
        "device": getattr(dev, "device_kind", str(dev)),
        "build_rows": cfg.build_rows,
        "probe_rows": cfg.probe_rows,
        "result_rows": grand_total,
        "build_seconds": build_stat.seconds,
        "count_seconds": count_secs,
        "materialize_seconds": mat_secs,
        "total_seconds": total_seconds,
        "total_seconds_materialized": total_seconds,
        "probe_rows_per_sec": cfg.probe_rows / (count_secs + mat_secs),
        "probe_chunks": num_chunks,
        "rle_result_seconds": rle_stat.seconds,
        "total_seconds_rle": rle_total,
        "rle_verified": rle_verified,
        "hbm_peak_gbps": hbm_peak_gbps(dev),
        "verified": verified,
    }
    if verified:
        out["pairs_checked"] = grand_total
    return out


def bench_join(cfg: JoinConfig, verify: bool, engine: str = "v2") -> dict:
    from tpujoin.ops import merge_join as mj_mod

    if cfg.expected_matches > 2.5e8:
        if engine == "v2":
            return bench_join_dense(cfg, verify)
        return bench_join_dense_v1(cfg, verify,
                                   rle_only=(engine == "v1-rle"))

    rng_r, rng_s = jax.random.split(jax.random.PRNGKey(cfg.seed))
    bk = datagen.make_keys(rng_r, cfg.build_rows, cfg.key_min, cfg.key_max,
                           cfg.distribution, cfg.zipf_s)
    pk = datagen.make_keys(rng_s, cfg.probe_rows, cfg.key_min, cfg.key_max,
                           cfg.distribution, cfg.zipf_s)
    jax.block_until_ready((bk, pk))

    # ---- phase timings (median of 3, fully synchronized) ----
    build_stat = time_fn(hj_mod.build, bk, name="build",
                         rows=cfg.build_rows,
                         bytes_touched=cfg.build_rows * 4 * 4)
    ht = hj_mod.build(bk)

    if engine.startswith("v1"):
        count_stat = time_fn(
            hj_mod.probe_count, ht, pk, name="count", rows=cfg.probe_rows,
            bytes_touched=(cfg.build_rows + cfg.probe_rows) * 4 * 4)
        lo, counts = hj_mod.probe_count(ht, pk)
        total = int(jnp.sum(counts))
        cap = round_up(total, cfg.result_pad_multiple)
        mat_stat = time_fn(
            lambda: hj_mod.probe_materialize(ht, lo, counts, cap),
            name="materialize", rows=total,
            bytes_touched=cfg.probe_rows * 8 + cap * 8 * 3)

        def materialize():
            return hj_mod.probe_materialize(ht, lo, counts, cap)
    else:
        count_stat = time_fn(
            mj_mod.probe_count, ht, pk, name="count", rows=cfg.probe_rows,
            bytes_touched=(cfg.build_rows + cfg.probe_rows * 3) * 4)
        state, total_a, _ = mj_mod.probe_count(ht, pk)
        total = int(total_a)
        cap = round_up(total, cfg.result_pad_multiple)

        def materialize():
            return mj_mod.probe_materialize(ht, state, cap)

        mat_stat = time_fn(materialize, name="materialize", rows=total,
                           bytes_touched=cfg.probe_rows * 12 + cap * 8 * 2)

    probe_seconds = count_stat.seconds + mat_stat.seconds
    total_seconds = build_stat.seconds + probe_seconds

    for st in (build_stat, count_stat, mat_stat):
        eprint(json.dumps(st.as_dict()))

    verified = None
    if verify:
        from tpujoin import oracle
        r_ids, s_ids, _, fits = materialize()
        assert bool(fits), "materialize capacity undersized"
        verified = oracle.check_join(
            np.asarray(bk), np.asarray(pk),
            np.asarray(r_ids[:total]), np.asarray(s_ids[:total])) == 1
        eprint(f"oracle multiset parity: {'PASS' if verified else 'FAIL'}")

    dev = jax.devices()[0]
    return {
        # below the dense-path threshold "v1-rle" runs the plain v1
        # engine (the factorized cell only exists at ~1B-pair scale)
        "engine": "v1" if engine.startswith("v1") else engine,
        "config": cfg.name,
        "device": getattr(dev, "device_kind", str(dev)),
        "build_rows": cfg.build_rows,
        "probe_rows": cfg.probe_rows,
        "result_rows": total,
        "build_seconds": build_stat.seconds,
        "count_seconds": count_stat.seconds,
        "materialize_seconds": mat_stat.seconds,
        "total_seconds": total_seconds,
        "probe_rows_per_sec": cfg.probe_rows / probe_seconds,
        "hbm_peak_gbps": hbm_peak_gbps(dev),
        "verified": verified,
    }


def bench_aggregate(rows: int, key_max: int, verify: bool) -> dict:
    """Hash aggregate (group-by count) — BASELINE.json config 3."""
    from tpujoin.ops import aggregate as agg

    keys = datagen.make_keys(jax.random.PRNGKey(0), rows, 1, key_max)
    jax.block_until_ready(keys)
    count_stat = time_fn(agg.group_count, keys, name="agg_count", rows=rows,
                         bytes_touched=rows * 8)
    ngroups = int(agg.group_count(keys))
    cap = round_up(ngroups, 1 << 20)

    def mat():
        return agg.group_materialize(keys, cap)

    mat_stat = time_fn(mat, name="agg_materialize", rows=rows,
                       bytes_touched=rows * 12 + cap * 8)
    # value-aggregate path: per-group (count, sum, min, max)
    vals = datagen.make_keys(jax.random.PRNGKey(1), rows, 0, 1_000_000)
    jax.block_until_ready(vals)

    def agg_mat():
        return agg.group_agg_materialize(keys, vals, cap)
    agg_stat = time_fn(agg_mat, name="agg_values", rows=rows,
                       bytes_touched=rows * 16 + cap * 24)
    for st in (count_stat, mat_stat, agg_stat):
        eprint(json.dumps(st.as_dict()))
    verified = None
    if verify:
        from tpujoin import oracle
        gk, gc, _ = mat()
        ok, oc = oracle.group_by_count(np.asarray(keys))
        verified = (np.array_equal(np.asarray(gk[:ngroups]), ok)
                    and np.array_equal(np.asarray(gc[:ngroups]), oc))
        eprint(f"aggregate oracle parity: {'PASS' if verified else 'FAIL'}")
        # value-path parity vs a numpy recompute (sum/min/max per group)
        gk2, gc2, (gs_hi, gs_lo), gmin, gmax, _ = agg_mat()
        sl = slice(0, ngroups)
        sums = ((np.asarray(gs_hi[sl]).astype(np.int64) << 32)
                | np.asarray(gs_lo[sl]).astype(np.int64))
        agg_ok = oracle.check_group_agg(
            np.asarray(keys), np.asarray(vals), np.asarray(gk2[sl]),
            np.asarray(gc2[sl]), sums, np.asarray(gmin[sl]),
            np.asarray(gmax[sl]))
        verified = verified and agg_ok
        eprint(f"aggregate value-path parity: "
               f"{'PASS' if agg_ok else 'FAIL'}")
    secs = count_stat.seconds + mat_stat.seconds
    return {"op": "aggregate", "rows": rows, "groups": ngroups,
            "total_seconds": secs, "rows_per_sec": rows / secs,
            "agg_values_seconds": agg_stat.seconds,
            "agg_values_rows_per_sec": rows / agg_stat.seconds,
            "verified": verified}


def bench_filter(rows: int, verify: bool) -> dict:
    """Selection + stream compaction (reference selection.mlir workload)."""
    from tpujoin.ops import filter as flt

    vals = jax.random.uniform(jax.random.PRNGKey(0), (rows,), jnp.float32,
                              0.0, 160.0)
    jax.block_until_ready(vals)
    cap = round_up(rows // 2 + rows // 8, 1 << 20)

    def run():
        return flt.filter_device(vals, 80.0, capacity=cap)

    stat = time_fn(run, name="filter", rows=rows, bytes_touched=rows * 12)
    eprint(json.dumps(stat.as_dict()))
    verified = None
    if verify:
        ids, total = run()
        total = int(total)
        v = np.asarray(vals)
        ids_np = np.asarray(ids[:total])
        verified = (total == int((v < 80.0).sum())
                    and bool((v[ids_np] < 80.0).all())
                    and bool((np.diff(ids_np) > 0).all()))
        eprint(f"filter parity: {'PASS' if verified else 'FAIL'}")
    return {"op": "filter", "rows": rows, "total_seconds": stat.seconds,
            "rows_per_sec": rows / stat.seconds, "verified": verified}


def bench_multi_join(rows: int, verify: bool) -> dict:
    """Multi-column equi-join (+ filter pushdown) — BASELINE.json config 2.

    The join is timed device-resident — the reference's own result memcpy
    sits outside its timers (join_v1.mlir:614-615 after endTimer). The
    pushdown variant (a host driver) is reported as wall time."""
    from tpujoin.core.table import Table
    from tpujoin.ops import multi_join as mjn

    ks = jax.random.split(jax.random.PRNGKey(7), 6)
    r = Table({"k1": datagen.make_keys(ks[0], rows, 1, 100_000),
               "k2": datagen.make_keys(ks[1], rows, 1, 10_000),
               "v": datagen.make_keys(ks[2], rows, 0, 1000)})
    s = Table({"k1": datagen.make_keys(ks[3], rows, 1, 100_000),
               "k2": datagen.make_keys(ks[4], rows, 1, 10_000),
               "v": datagen.make_keys(ks[5], rows, 0, 1000)})
    jax.block_until_ready((r.columns, s.columns))

    st = time_fn(lambda: mjn.hash_join_multi(r, s, ["k1", "k2"],
                                             return_numpy=False),
                 name="multi_join", rows=rows)
    join_secs = st.seconds
    out_r, out_s, total2 = mjn.hash_join_multi(r, s, ["k1", "k2"],
                                               return_numpy=False)

    stp = time_fn(lambda: mjn.join_with_pushdown(
        r, s, ["k1", "k2"],
        r_pred=lambda v: v < 500, r_pred_col="v",
        s_pred=lambda v: v < 500, s_pred_col="v",
        return_numpy=False), name="pushdown_join", rows=rows)
    push_secs = stp.seconds
    _, _, push_rows = mjn.join_with_pushdown(
        r, s, ["k1", "k2"],
        r_pred=lambda v: v < 500, r_pred_col="v",
        s_pred=lambda v: v < 500, s_pred_col="v", return_numpy=False)
    eprint(json.dumps(st.as_dict()))
    eprint(json.dumps(stp.as_dict()))

    verified = None
    if verify:
        r_ids = np.asarray(out_r[:total2])
        s_ids = np.asarray(out_s[:total2])
        k1r, k2r = np.asarray(r["k1"]), np.asarray(r["k2"])
        k1s, k2s = np.asarray(s["k1"]), np.asarray(s["k2"])
        pair_ok = bool((k1r[r_ids] == k1s[s_ids]).all()
                       and (k2r[r_ids] == k2s[s_ids]).all())
        expected = int(multi_join_expected(r["k1"], r["k2"], s["k1"],
                                           s["k2"]))
        verified = pair_ok and expected == total2
        eprint(f"multi-join parity: {'PASS' if verified else 'FAIL'} "
               f"(rows {total2} expected {expected})")
    detail = {"op": "multi_join", "rows": rows, "result_rows": total2,
              "join_seconds": join_secs, "pushdown_seconds": push_secs,
              "pushdown_result_rows": push_rows,
              "total_seconds": join_secs,
              "rows_per_sec": rows / join_secs, "verified": verified}
    return detail


@jax.jit
def multi_join_expected(k1r, k2r, k1s, k2s, r_keep=None, s_keep=None):
    """Exact size of the two-column equi-join, computed on the device by a
    plain sort + searchsorted over packed 64-bit keys. Rows whose
    ``*_keep`` mask is False take no part (filter pushdown)."""
    with jax.enable_x64(True):
        cr = (k1r.astype(jnp.int64) << 32) | k2r.astype(jnp.int64)
        cs = (k1s.astype(jnp.int64) << 32) | k2s.astype(jnp.int64)
        # dropped rows get keys below the i32 pair domain, distinct per side
        if r_keep is not None:
            cr = jnp.where(r_keep, cr, jnp.int64(-(1 << 62)))
        if s_keep is not None:
            cs = jnp.where(s_keep, cs, jnp.int64(-(1 << 62) - 1))
        crs = jnp.sort(cr)
        hi = jnp.searchsorted(crs, cs, side="right")
        lo = jnp.searchsorted(crs, cs, side="left")
        return jnp.sum(hi - lo)


def bench_sort(rows: int) -> dict:
    """Key+payload sort — the primitive under build and probe phases."""
    from tpujoin.ops.sort import sort_with_ids

    keys = datagen.make_keys(jax.random.PRNGKey(0), rows, 1, 1 << 30)
    jax.block_until_ready(keys)
    stat = time_fn(sort_with_ids, keys, name="sort_keyval", rows=rows,
                   bytes_touched=rows * 16)
    eprint(json.dumps(stat.as_dict()))
    return {"op": "sort", "rows": rows, "total_seconds": stat.seconds,
            "rows_per_sec": rows / stat.seconds}


# ---- summary line ----
#
# The summary is ONE JSON line on stdout, printed and flushed after every
# completed config so a killed run still ends in a valid (truncated)
# summary; floats are rounded and separators compacted, with a
# reduced-key fallback, keeping the line under 1900 bytes.

_COMPLETED: dict = {}
_VERIFY_FLAG = [True]

# per-config reference bars (join-performances.md): low-selectivity
# v1 ~12 s / v2 ~12.5 s; high-selectivity (materialized) v1 ~2 s /
# v2 ~1.5 s — each engine row is compared against ITS OWN engine's bar.
# NOTE: these bars time the reference's MATERIALIZED result;
# vs_ref_rle divides them by the factorized RLE time, a different result
# form (the summary carries ref_bar_is_materialized=true for this).
_HIGH_BAR = {"v1": 2.0, "v1-rle": 2.0, "v2": 1.5, "v2-rle": 1.5}


def _round5(x):
    if isinstance(x, float):
        return float(f"{x:.5g}")
    if isinstance(x, dict):
        return {k: _round5(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_round5(v) for v in x]
    return x


_CFG_KEYS = ("engine", "op", "result_rows", "build_seconds",
             "count_seconds", "materialize_seconds", "total_seconds",
             "probe_rows_per_sec", "rows_per_sec", "join_seconds",
             "pushdown_seconds", "pushdown_result_rows",
             "probe_chunks", "verified", "pairs_checked")
_CFG_KEYS_MIN = ("engine", "op", "result_rows", "total_seconds",
                 "total_seconds_materialized", "vs_ref_materialized",
                 "total_seconds_rle", "verified", "pairs_checked")


def _config_entry(c: dict, keys) -> dict:
    out = {k: c[k] for k in keys if k in c}
    if "pair_materialize_seconds" in c:
        out["pair_materialize_seconds"] = c["pair_materialize_seconds"]
    if "total_seconds_materialized" in c:
        out["total_seconds_materialized"] = c["total_seconds_materialized"]
        out["vs_ref_materialized"] = (_HIGH_BAR.get(c.get("engine"), 1.5)
                                      / c["total_seconds_materialized"])
    # factorized (RLE) result: surface it in the summary line, not just
    # the stderr detail stream
    if "total_seconds_rle" in c:
        out["total_seconds_rle"] = c["total_seconds_rle"]
        out["rle_verified"] = c["rle_verified"]
        out["vs_ref_rle"] = (_HIGH_BAR.get(c.get("engine"), 1.5)
                             / c["total_seconds_rle"])
        if keys is _CFG_KEYS:
            out["rle_result_seconds"] = c["rle_result_seconds"]
            out["ref_bar_is_materialized"] = True
    return out


def _device_info() -> dict:
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _summary_line(configs: dict, verify: bool,
                  truncated: bool = False) -> str:
    if not configs:
        return json.dumps({"metric": "hash_join_probe_rows_per_sec",
                           "value": 0.0, "unit": "rows/s",
                           "vs_baseline": 0.0, "configs": {},
                           "truncated": truncated,
                           "device": _device_info()})
    head_key = ("ref_low_selectivity" if "ref_low_selectivity" in configs
                else next(iter(configs)))
    value = configs[head_key].get("probe_rows_per_sec",
                                  configs[head_key].get("rows_per_sec", 0.0))
    for keys in (_CFG_KEYS, _CFG_KEYS_MIN):
        line = json.dumps(_round5({
            "metric": "hash_join_probe_rows_per_sec",
            "value": value,
            "unit": "rows/s",
            "vs_baseline": value / REFERENCE_PROBE_ROWS_PER_SEC,
            "verified": all(c.get("verified") for c in configs.values())
            if verify else None,
            "truncated": truncated,
            "device": _device_info(),
            "configs": {n: _config_entry(c, keys)
                        for n, c in configs.items()},
        }), separators=(",", ":"))
        if len(line) <= 1900:
            break
    return line


def _emit_summary(truncated: bool = False):
    sys.stderr.flush()
    print(_summary_line(_COMPLETED, _VERIFY_FLAG[0], truncated), flush=True)


def _on_signal(signum, frame):
    eprint(f"bench: signal {signum} after "
           f"{len(_COMPLETED)} completed configs — emitting summary")
    if _COMPLETED:
        _emit_summary(truncated=True)
    # os._exit: don't risk hanging in runtime teardown mid-compile; a
    # truncated matrix is a failed run
    os._exit(1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="preset name (default: the full matrix, which "
                         "needs a GPU)")
    ap.add_argument("--verify", action="store_true", default=True,
                    help="oracle parity check (DEFAULT ON — the reference "
                         "verifies every run, shared.cpp:167-171)")
    ap.add_argument("--no-verify", dest="verify", action="store_false",
                    help="skip the oracle parity check")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="row-count scale factor")
    ap.add_argument("--engine", default=None, choices=["v1", "v2"],
                    help="v1 = searchsorted probe; v2 = sort-merge probe "
                         "(default: v2, or BOTH engines in the default "
                         "full-matrix run)")
    ap.add_argument("--op", default="join",
                    choices=["join", "aggregate", "filter", "sort",
                             "multi_join"],
                    help="operator to benchmark (headline metric is join)")
    ap.add_argument("--rows", type=int, default=None,
                    help="row count for non-join ops (default 100M, which "
                         "needs a GPU)")
    ap.add_argument("--budget", type=float,
                    default=float(os.environ.get("TPUJOIN_BENCH_BUDGET",
                                                 1500.0)),
                    help="soft wall-clock budget in seconds for the "
                         "default matrix: remaining entries are skipped "
                         "once exceeded, the summary marks the run "
                         "truncated and the exit code is 1 (0 = unlimited)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="capture a jax.profiler trace of the benchmark "
                         "into DIR (xprof/tensorboard format) — the "
                         "kernel-truth profiler, standing in for the "
                         "reference's Nsight Compute recipes "
                         "(nsight-command:1-15)")
    args = ap.parse_args()
    if args.config is None and args.rows is None:
        hw.require_gpu("bench.py without --config or --rows")
    hw.enable_compile_cache()

    _VERIFY_FLAG[0] = args.verify
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGALRM, _on_signal)
    t_start = time.monotonic()
    if args.budget:
        # hard backstop well past the soft budget: if a single entry wedges
        # (compile stall, oracle on a pathological shape), still emit the
        # summary for whatever completed instead of dying silent
        signal.alarm(int(args.budget + 600))

    import contextlib
    trace_ctx = (jax.profiler.trace(args.trace) if args.trace
                 else contextlib.nullcontext())

    if args.op != "join":
        rows = args.rows or 100_000_000
        with trace_ctx:
            if args.op == "aggregate":
                detail = bench_aggregate(rows, max(rows // 10, 100),
                                         args.verify)
            elif args.op == "filter":
                detail = bench_filter(rows, args.verify)
            elif args.op == "multi_join":
                detail = bench_multi_join(rows, args.verify)
            else:
                detail = bench_sort(rows)
        eprint(json.dumps(detail))
        print(json.dumps({
            "metric": f"{args.op}_rows_per_sec",
            "value": detail["rows_per_sec"],
            "unit": "rows/s",
            "vs_baseline": 1.0,  # no reference numbers exist for these ops
            "device": _device_info(),
        }))
        return 0 if detail.get("verified") is not False else 1

    # entries: (config name, engine, result key). The default captures
    # the reference's FULL published matrix (join-performances.md:1-24:
    # v1 AND v2 on both configs) plus the zipf-skew and multi-column
    # extension workloads, every entry oracle/checksum-verified, in ONE
    # summary line.
    if args.config is not None:
        entries = [(args.config, args.engine or "v2", args.config)]
    elif args.engine is not None:   # explicit engine: that engine only,
        # including v1's full dense high-selectivity materialization
        entries = [
            ("ref_low_selectivity", args.engine, "ref_low_selectivity"),
            ("ref_high_selectivity", args.engine, "ref_high_selectivity"),
        ]
        if args.engine == "v2":
            entries.append(("zipf_skew", "v2", "zipf_skew"))
    else:
        entries = [
            ("ref_low_selectivity", "v2", "ref_low_selectivity"),
            ("ref_high_selectivity", "v2", "ref_high_selectivity"),
            ("ref_low_selectivity", "v1", "ref_low_selectivity[v1]"),
            ("ref_high_selectivity", "v1-rle",
             "ref_high_selectivity[v1-rle]"),
            ("zipf_skew", "v2", "zipf_skew"),
        ]
    for name, _, _ in entries:
        if name not in PRESETS:
            sys.exit(f"unknown config {name!r}; available: "
                     f"{', '.join(sorted(PRESETS))}")

    def over_budget() -> bool:
        return bool(args.budget) and (time.monotonic() - t_start
                                      > args.budget)

    truncated = False
    with trace_ctx:
        for name, engine, key in entries:
            if _COMPLETED and over_budget():
                eprint(f"bench: soft budget {args.budget:.0f}s exceeded — "
                       f"skipping {key} and later entries")
                truncated = True
                break
            cfg = PRESETS[name]
            if args.scale != 1.0:
                cfg = JoinConfig(
                    name=cfg.name,
                    build_rows=int(cfg.build_rows * args.scale),
                    probe_rows=int(cfg.probe_rows * args.scale),
                    key_min=cfg.key_min, key_max=cfg.key_max,
                    distribution=cfg.distribution, zipf_s=cfg.zipf_s,
                    seed=cfg.seed,
                )
            detail = bench_join(cfg, args.verify, engine=engine)
            eprint(json.dumps(detail))
            _COMPLETED[key] = detail
            _emit_summary()
        if args.config is None and args.engine is None:
            if over_budget():
                truncated = True
            else:
                mj_detail = bench_multi_join(int(100_000_000 * args.scale),
                                             args.verify)
                eprint(json.dumps(mj_detail))
                _COMPLETED["multi_join"] = mj_detail

    signal.alarm(0)
    _emit_summary(truncated)
    failed = args.verify and not all(c.get("verified")
                                     for c in _COMPLETED.values())
    return 1 if truncated or failed else 0


if __name__ == "__main__":
    sys.exit(main())
