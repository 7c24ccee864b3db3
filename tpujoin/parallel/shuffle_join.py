"""Distributed shuffle join over a device mesh: sorted range-shuffle.

The scale-out path BASELINE.json requires (configs 3-5) and the reference
explicitly lacks (single GPU; "Partitioned Hash-Join" / "Relations that
don't fit on GPU" are future work, reference projectDescription.md:23-24).

Design (mesh + sharding annotations + XLA collectives): **splitter-based
range partitioning over one local key sort**.

1. Tables are row-sharded across a 1-D mesh. Each device sorts its local
   (key, id) rows ONCE — the same 2-operand sort the local join needs
   anyway — and P-1 global key splitters are agreed by quantile-sampling
   both sorted tables and ``all_gather``-ing the samples (identical on
   every device by construction). Co-partitioning: equal keys fall in the
   same splitter bucket on every device and both tables.
2. Because the partition is MONOTONE in the key, each peer's rows are a
   CONTIGUOUS segment of the sorted order: the fixed-capacity [P, C] send
   buffer is packed with P slice copies inside one ``fori_loop`` (flat
   O(1) program graph in mesh size — no per-peer Python unrolling, no
   send-packing sort at all; the hash design paid a 3-operand sort per
   table here). Unused slots carry the pad key / id = -1.
3. One ``jax.lax.all_to_all`` per column exchanges the buffers (XLA
   hands it to NCCL on GPUs).
4. Each device re-sorts its received buffer per side (2-operand sorts —
   the P received segments are each sorted but interleave; the sort also
   floats the pad sentinels to the tail) and joins with the SAME v2
   pipeline as the single-device engine: ops.hash_join.ranks over the
   sorted sides, then ops.hash_join.probe_materialize.
5. ``psum``/``pmax`` reduce exact global result counts and overflow
   telemetry (the distributed analogue of the reference's result-size
   memcpy, join_v1.mlir:140-144).

Reserved sentinels: keys on EITHER side must not equal 0x7FFFFFFE or
0x7FFFFFFF (the engine's probe/build pad values — far outside the
benchmark key domain [1, 1e9], reference shared.cpp:13-14, and the same
two values ops.merge_join already reserves on one chip).

Overflow of a send segment or the local result capacity is *detected*
(pmax over counts) and surfaced to the driver, which retries with more
capacity — never silently dropped. Heavy-hitter splitting for Zipf
skew lives in :mod:`tpujoin.parallel.skew`; see :func:`recommended_slack`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from tpujoin.ops.hash_join import HashJoinTable, probe_materialize, ranks
from tpujoin.parallel.mesh import ROW_AXIS, make_mesh
from tpujoin.utils.shapes import cdiv, round_up

_BUILD_PAD_KEY = np.int32(0x7FFFFFFF)   # sorts last, never matches a probe
_PROBE_PAD_KEY = np.int32(0x7FFFFFFE)   # sorts last, never matches a build
_SU = "scan_unrolled"    # searchsorted method for O(P)-query lookups
SAMPLE_K = 1024          # quantile samples per table per device


def _sort2(keys, ids, pad_key):
    """Local (key, id) sort with driver padding (id < 0) repainted to the
    side's sentinel so pads sink to the tail."""
    k = jnp.where(ids < 0, pad_key, keys)
    return jax.lax.sort((k, ids), num_keys=1, is_stable=False)


def _quantile_sample(keys, k: int):
    """[k] evenly strided elements (quantiles when ``keys`` is sorted)."""
    n = keys.shape[0]
    k = min(k, n)
    stride = max(n // k, 1)
    idx = jnp.minimum(jnp.arange(k, dtype=jnp.int32) * stride, n - 1)
    return jnp.take(keys, idx)


def _splitters(samples, num_peers: int):
    """P-1 global splitter keys from the union of every device's samples.
    Deterministic + all_gather => identical on every device and for both
    tables, which is what makes the range partition a co-partition."""
    g = jax.lax.all_gather(samples, ROW_AXIS).reshape(-1)
    g = jax.lax.sort(g)
    m = g.shape[0]
    idx = jnp.arange(1, num_peers, dtype=jnp.int32) * jnp.int32(
        m // num_peers)
    return jnp.take(g, idx)


def _segment_bounds(sorted_keys, splitters, n_real):
    """(starts, counts) of each peer's contiguous bucket in the local
    sorted order. Bucket p = keys in [splitter[p-1], splitter[p]) — the
    'left' side keeps equal keys whole. ``n_real`` (rows before the pad
    tail) caps every boundary so driver pads are never shipped."""
    inner = jnp.searchsorted(sorted_keys, splitters, side="left",
                             method=_SU).astype(jnp.int32)
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.minimum(inner, n_real)])
    ends = jnp.concatenate([starts[1:], n_real[None].astype(jnp.int32)])
    return starts, ends - starts


def _pack_sorted(skeys, sids, starts, counts, num_peers: int,
                 capacity: int, pad_key):
    """Ragged->fixed [P, C] send buffer from contiguous sorted segments:
    one dynamic-slice copy per peer inside a fori_loop — bandwidth-bound
    copies and a program graph that is O(1) in mesh size (per-peer Python
    unrolling would grow the program linearly with P). Returns (buf_keys, buf_ids, max_count); max_count > capacity
    means send overflow."""
    skeys_p = jnp.concatenate(
        [skeys, jnp.full((capacity,), pad_key, jnp.int32)])
    sids_p = jnp.concatenate([sids, jnp.full((capacity,), -1, jnp.int32)])
    c = jnp.arange(capacity, dtype=jnp.int32)

    def body(p, bufs):
        bk, bi = bufs
        st = jnp.take(starts, p)
        k_p = jax.lax.dynamic_slice_in_dim(skeys_p, st, capacity)
        i_p = jax.lax.dynamic_slice_in_dim(sids_p, st, capacity)
        valid = c < jnp.take(counts, p)
        k_p = jnp.where(valid, k_p, pad_key)
        i_p = jnp.where(valid, i_p, -1)
        bk = jax.lax.dynamic_update_slice_in_dim(bk, k_p[None], p, axis=0)
        bi = jax.lax.dynamic_update_slice_in_dim(bi, i_p[None], p, axis=0)
        return bk, bi

    bk0 = jnp.full((num_peers, capacity), pad_key, jnp.int32)
    bi0 = jnp.full((num_peers, capacity), -1, jnp.int32)
    bk, bi = jax.lax.fori_loop(0, num_peers, body, (bk0, bi0))
    return bk, bi, jnp.max(counts)


def _exchange_sorted(skeys, sids, splitters, num_peers: int, capacity: int,
                     pad_key, n_real):
    """Pack the local sorted rows by splitter bucket and all_to_all them.
    Returns (recv_keys_flat, recv_ids_flat, max_segment)."""
    starts, counts = _segment_bounds(skeys, splitters, n_real)
    bk, bi, mx = _pack_sorted(skeys, sids, starts, counts, num_peers,
                              capacity, pad_key)
    bk = jax.lax.all_to_all(bk, ROW_AXIS, 0, 0)
    bi = jax.lax.all_to_all(bi, ROW_AXIS, 0, 0)
    return bk.reshape(-1), bi.reshape(-1), mx


def _n_real(ids):
    """Rows before the driver-pad tail (pads carry id < 0)."""
    return ids.shape[0] - jnp.sum((ids < 0).astype(jnp.int32))


def _sort_build(bk, bid):
    """Sort received build rows once (pad rows sink to the tail)."""
    bk = jnp.where(bid < 0, _BUILD_PAD_KEY, bk)
    return jax.lax.sort((bk, bid), num_keys=1, is_stable=False)


def _count_sorted(sk, pk, pid_):
    """Count phase of the local join: sort the received probe rows once,
    then rank them against the sorted build keys. Returns
    (ppid, lo, cnt) in sorted-probe order."""
    pk_eff = jnp.where(pid_ < 0, _PROBE_PAD_KEY, pk)
    psk, ppid = jax.lax.sort((pk_eff, pid_), num_keys=1, is_stable=False)
    lo, cnt = ranks(sk, psk)
    return ppid, lo, cnt


def _probe_sorted(sk, sid, pk, pid_, capacity: int):
    """Probe pre-sorted build rows at static result capacity on the v2
    pipeline (the same steps as ops.merge_join.probe_count +
    probe_materialize, with the received buffers' global ids carried
    through). Returns (r_ids, s_ids, total)."""
    ppid, lo, cnt = _count_sorted(sk, pk, pid_)
    r_ids, s_ids, total, _ = probe_materialize(
        HashJoinTable(sk, sid), lo, cnt, capacity, probe_ids=ppid)
    return r_ids, s_ids, total


def _local_join(bk, bid, pk, pid_, capacity: int):
    """Sorted-build equi-join of the received rows, at static result
    capacity; carries explicit global row ids through the exchange.
    (Entry point for :mod:`tpujoin.parallel.skew`, whose replicate path
    concatenates unsorted buffers.) Returns (r_ids, s_ids, total)."""
    sk, sid = _sort_build(bk, bid)
    return _probe_sorted(sk, sid, pk, pid_, capacity)


def make_shuffle_join_pipelined_fn(
    mesh,
    send_cap_r: int,
    send_cap_s: int,
    chunk_result_cap: int,
    num_chunks: int = 2,
):
    """Pipelined shuffle-join step: the probe side is exchanged in
    ``num_chunks`` slices, and slice c's all_to_all carries no data
    dependency on slice c-1's local join — XLA's async collectives can
    overlap the exchange with probe compute (the double-buffered
    overlap BASELINE.json's north star asks for). The build side is
    exchanged and sorted once up front; splitters come from the sorted
    build quantiles plus a strided sample of the (unsorted) full probe
    shard, so every chunk shares one co-partition.

    Local probe shards must be divisible by num_chunks (driver pads).
    Returns per-chunk padded results stacked on a leading axis, per-device
    per-chunk counts, and the overflow telemetry vector
    [send_r, send_s, result]."""
    num_peers = mesh.shape[ROW_AXIS]

    def shard_fn(r_keys, r_ids, s_keys, s_ids):
        rk_s, ri_s = _sort2(r_keys, r_ids, _BUILD_PAD_KEY)
        s_samp = _quantile_sample(
            jnp.where(s_ids < 0, _PROBE_PAD_KEY, s_keys), SAMPLE_K)
        samp = jnp.concatenate(
            [_quantile_sample(rk_s, SAMPLE_K), s_samp])
        spl = _splitters(samp, num_peers)

        rbk, rbi, r_max = _exchange_sorted(
            rk_s, ri_s, spl, num_peers, send_cap_r, _BUILD_PAD_KEY,
            _n_real(r_ids))
        sk, sid = _sort_build(rbk, rbi)

        m_loc = s_keys.shape[0]
        chunk = m_loc // num_chunks
        sends = []
        s_max = jnp.int32(0)
        for c in range(num_chunks):
            ck_ = jax.lax.dynamic_slice_in_dim(s_keys, c * chunk, chunk)
            ci_ = jax.lax.dynamic_slice_in_dim(s_ids, c * chunk, chunk)
            ck_s, ci_s = _sort2(ck_, ci_, _PROBE_PAD_KEY)
            starts, counts = _segment_bounds(ck_s, spl, _n_real(ci_s))
            bk_c, bi_c, mx = _pack_sorted(ck_s, ci_s, starts, counts,
                                          num_peers, send_cap_s,
                                          _PROBE_PAD_KEY)
            sends.append((bk_c, bi_c))
            s_max = jnp.maximum(s_max, mx)

        # software pipeline: issue exchange c+1 before joining chunk c, so
        # the collective and the local probe have no mutual dependency
        recvs = [None] * num_chunks
        recvs[0] = (jax.lax.all_to_all(sends[0][0], ROW_AXIS, 0, 0),
                    jax.lax.all_to_all(sends[0][1], ROW_AXIS, 0, 0))
        outs = []
        totals = []
        for c in range(num_chunks):
            if c + 1 < num_chunks:
                recvs[c + 1] = (
                    jax.lax.all_to_all(sends[c + 1][0], ROW_AXIS, 0, 0),
                    jax.lax.all_to_all(sends[c + 1][1], ROW_AXIS, 0, 0))
            pk_c, pi_c = recvs[c]
            r_out, s_out, tot = _probe_sorted(
                sk, sid, pk_c.reshape(-1), pi_c.reshape(-1),
                chunk_result_cap)
            outs.append((r_out, s_out))
            totals.append(tot)

        r_stack = jnp.concatenate([o[0] for o in outs])
        s_stack = jnp.concatenate([o[1] for o in outs])
        totals = jnp.stack(totals)
        ovf = jnp.stack([
            jax.lax.pmax(r_max, ROW_AXIS),
            jax.lax.pmax(s_max, ROW_AXIS),
            jax.lax.pmax(jnp.max(totals), ROW_AXIS),
        ])
        return r_stack, s_stack, totals, ovf

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS)),
        out_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def make_splitter_stats_fn(mesh):
    """Capacity pre-pass: sort each shard locally, agree
    the splitters, and report the EXACT per-peer segment maxima — so the
    driver sizes send buffers from measured counts instead of a blanket
    slack factor. The sorted shards and splitters are returned and fed
    straight into :func:`make_shuffle_join_presorted_fn`; the sort is NOT
    repeated (the pre-pass costs one extra device-memory round trip of the
    sorted columns, against the oversized exchange a blanket slack factor
    costs).

    Returns fn(r_keys, r_ids, s_keys, s_ids) ->
    (rk_s, ri_s, sk_s, si_s, spl, maxes) with maxes = [max_r_segment,
    max_s_segment] pmax'd over devices."""
    num_peers = mesh.shape[ROW_AXIS]

    def shard_fn(r_keys, r_ids, s_keys, s_ids):
        rk_s, ri_s = _sort2(r_keys, r_ids, _BUILD_PAD_KEY)
        sk_s, si_s = _sort2(s_keys, s_ids, _PROBE_PAD_KEY)
        samp = jnp.concatenate([_quantile_sample(rk_s, SAMPLE_K),
                                _quantile_sample(sk_s, SAMPLE_K)])
        spl = _splitters(samp, num_peers)
        _, r_counts = _segment_bounds(rk_s, spl, _n_real(ri_s))
        _, s_counts = _segment_bounds(sk_s, spl, _n_real(si_s))
        maxes = jnp.stack([
            jax.lax.pmax(jnp.max(r_counts), ROW_AXIS),
            jax.lax.pmax(jnp.max(s_counts), ROW_AXIS),
        ])
        return rk_s, ri_s, sk_s, si_s, spl, maxes

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS)),
        out_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS),
                   P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def make_shuffle_join_presorted_fn(
    mesh,
    send_cap_r: int,
    send_cap_s: int,
    local_result_cap: int,
):
    """The exchange+join step on PRE-SORTED shards and agreed splitters
    (the outputs of :func:`make_splitter_stats_fn`): pack, all_to_all,
    re-sort received sides, v2 local join. Same results/telemetry contract
    as :func:`make_shuffle_join_fn`."""
    num_peers = mesh.shape[ROW_AXIS]

    def shard_fn(rk_s, ri_s, sk_s, si_s, spl):
        rbk, rbi, r_max = _exchange_sorted(
            rk_s, ri_s, spl, num_peers, send_cap_r, _BUILD_PAD_KEY,
            _n_real(ri_s))
        sbk, sbi, s_max = _exchange_sorted(
            sk_s, si_s, spl, num_peers, send_cap_s, _PROBE_PAD_KEY,
            _n_real(si_s))
        sk, sid = _sort_build(rbk, rbi)
        r_ids_out, s_ids_out, local_total = _probe_sorted(
            sk, sid, sbk, sbi, local_result_cap)
        ovf = jnp.stack([
            jax.lax.pmax(r_max, ROW_AXIS),
            jax.lax.pmax(s_max, ROW_AXIS),
            jax.lax.pmax(local_total, ROW_AXIS),
        ])
        return r_ids_out, s_ids_out, local_total[None], ovf

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS),
                  P()),
        out_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def make_shuffle_join_fn(
    mesh,
    send_cap_r: int,
    send_cap_s: int,
    local_result_cap: int,
):
    """Build the shard_map'd distributed join step for a given mesh + static
    capacities. Returns fn(r_keys, r_ids, s_keys, s_ids) operating on
    row-sharded global arrays, yielding row-sharded padded results plus
    per-device exact counts and the overflow telemetry vector
    [send_r, send_s, result]."""
    num_peers = mesh.shape[ROW_AXIS]

    def shard_fn(r_keys, r_ids, s_keys, s_ids):
        # one local sort per table: packing order AND join order at once
        rk_s, ri_s = _sort2(r_keys, r_ids, _BUILD_PAD_KEY)
        sk_s, si_s = _sort2(s_keys, s_ids, _PROBE_PAD_KEY)
        samp = jnp.concatenate([_quantile_sample(rk_s, SAMPLE_K),
                                _quantile_sample(sk_s, SAMPLE_K)])
        spl = _splitters(samp, num_peers)

        rbk, rbi, r_max = _exchange_sorted(
            rk_s, ri_s, spl, num_peers, send_cap_r, _BUILD_PAD_KEY,
            _n_real(ri_s))
        sbk, sbi, s_max = _exchange_sorted(
            sk_s, si_s, spl, num_peers, send_cap_s, _PROBE_PAD_KEY,
            _n_real(si_s))

        sk, sid = _sort_build(rbk, rbi)
        r_ids_out, s_ids_out, local_total = _probe_sorted(
            sk, sid, sbk, sbi, local_result_cap)
        # telemetry: [send_r ovf, send_s ovf, result ovf]
        ovf = jnp.stack([
            jax.lax.pmax(r_max, ROW_AXIS),
            jax.lax.pmax(s_max, ROW_AXIS),
            jax.lax.pmax(local_total, ROW_AXIS),
        ])
        return r_ids_out, s_ids_out, local_total[None], ovf

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS)),
        out_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def make_shuffle_join_rle_fn(mesh, send_cap_r: int, send_cap_s: int):
    """Factorized (RLE) distributed join step: each device returns its
    local join in run-length form — (probe_id, lo, cnt) per received probe
    row over its sorted build ids — instead of materialized pairs. The
    distributed analogue of ops.merge_join.probe_rle: on high-duplication
    shards the materialized local result can exceed any static
    local_result_cap (the single-chip Zipf config reaches ~5e11 pairs),
    while the RLE form is always one fixed-size buffer per device.

    Returns fn(...) -> (ppid, lo, cnt, build_ids, pair_lo32, pair_hi30,
    ovf): per-device RLE columns (zero-count rows included — they expand
    to nothing), the device's sorted build ids, the exact per-device pair
    count split into two i32 halves (lo 30 bits / high bits, keeping the
    shard_map boundary x32 while Zipf totals exceed 2^31), and send-buffer
    overflow telemetry."""
    num_peers = mesh.shape[ROW_AXIS]

    def shard_fn(r_keys, r_ids, s_keys, s_ids):
        rk_s, ri_s = _sort2(r_keys, r_ids, _BUILD_PAD_KEY)
        sk_s, si_s = _sort2(s_keys, s_ids, _PROBE_PAD_KEY)
        samp = jnp.concatenate([_quantile_sample(rk_s, SAMPLE_K),
                                _quantile_sample(sk_s, SAMPLE_K)])
        spl = _splitters(samp, num_peers)
        rbk, rbi, r_max = _exchange_sorted(
            rk_s, ri_s, spl, num_peers, send_cap_r, _BUILD_PAD_KEY,
            _n_real(ri_s))
        sbk, sbi, s_max = _exchange_sorted(
            sk_s, si_s, spl, num_peers, send_cap_s, _PROBE_PAD_KEY,
            _n_real(si_s))
        sk, sid = _sort_build(rbk, rbi)
        ppid, lo, cnt = _count_sorted(sk, sbk, sbi)
        with jax.enable_x64(True):
            pairs = jnp.sum(cnt.astype(jnp.int64))
            pair_lo = (pairs & jnp.int64((1 << 30) - 1)).astype(jnp.int32)
            pair_hi = (pairs >> 30).astype(jnp.int32)
        ovf = jnp.stack([jax.lax.pmax(r_max, ROW_AXIS),
                         jax.lax.pmax(s_max, ROW_AXIS)])
        return (ppid, lo, cnt, sid, pair_lo[None], pair_hi[None], ovf)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS)),
        out_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS),
                   P(ROW_AXIS), P(ROW_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def distributed_hash_join_rle(
    r_keys,
    s_keys,
    *,
    mesh=None,
    slack: float = 1.25,
    max_retries: int = 3,
):
    """Driver: distributed join in factorized (RLE) form — the scale-out
    path for high-duplication workloads where materialized pairs would not
    fit any per-device result buffer.

    Returns (shards, total_pairs): ``shards`` is a list of per-device
    dicts {probe_ids, lo, cnt, build_ids} (numpy; the expansion of run r
    on device d is pairs (build_ids[lo[r]+j], probe_ids[r]) for
    j < cnt[r]), ``total_pairs`` the exact global pair count (Python int,
    not bounded by int32)."""
    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.shape[ROW_AXIS]
    r_keys = np.asarray(r_keys, np.int32)
    s_keys = np.asarray(s_keys, np.int32)
    n, m_rows = len(r_keys), len(s_keys)
    rk, ri = _pad_sharded(r_keys, np.arange(n, dtype=np.int32), ndev)
    sk, si = _pad_sharded(s_keys, np.arange(m_rows, dtype=np.int32), ndev)
    shard = NamedSharding(mesh, P(ROW_AXIS))
    rk, ri, sk, si = (jax.device_put(x, shard) for x in (rk, ri, sk, si))

    cap_r = round_up(int(cdiv(len(np.asarray(rk)) // ndev, ndev) * slack) + 64, 64)
    cap_s = round_up(int(cdiv(len(np.asarray(sk)) // ndev, ndev) * slack) + 64, 64)
    for _ in range(max_retries):
        fn = make_shuffle_join_rle_fn(mesh, cap_r, cap_s)
        ppid, lo, cnt, bid, pl, ph, ovf = fn(rk, ri, sk, si)
        ovf = np.asarray(ovf)
        if ovf[0] <= cap_r and ovf[1] <= cap_s:
            break
        cap_r = max(cap_r, round_up(int(ovf[0]), 64))
        cap_s = max(cap_s, round_up(int(ovf[1]), 64))
    else:
        raise RuntimeError(f"RLE shuffle join send caps did not converge: {ovf}")

    ppid = np.asarray(ppid).reshape(ndev, -1)
    lo = np.asarray(lo).reshape(ndev, -1)
    cnt = np.asarray(cnt).reshape(ndev, -1)
    bid = np.asarray(bid).reshape(ndev, -1)
    pl = np.asarray(pl).reshape(-1).astype(np.int64)
    ph = np.asarray(ph).reshape(-1).astype(np.int64)
    total_pairs = int(((ph << 30) + pl).sum())
    shards = [
        {"probe_ids": ppid[d], "lo": lo[d], "cnt": cnt[d],
         "build_ids": bid[d]}
        for d in range(ndev)
    ]
    return shards, total_pairs


def make_shuffle_semi_fn(mesh, send_cap_r: int, send_cap_s: int):
    """Distributed semi/anti step: count-phase-only — after the exchange,
    each device reports (probe_id, matched) for every received probe row.
    No result capacity exists to overflow; only send buffers carry
    telemetry. Semi = ids with matched, anti = ids without (the same
    count-state partition ops.merge_join.semi_join/anti_join use on one
    chip)."""
    num_peers = mesh.shape[ROW_AXIS]

    def shard_fn(r_keys, r_ids, s_keys, s_ids):
        rk_s, ri_s = _sort2(r_keys, r_ids, _BUILD_PAD_KEY)
        sk_s, si_s = _sort2(s_keys, s_ids, _PROBE_PAD_KEY)
        samp = jnp.concatenate([_quantile_sample(rk_s, SAMPLE_K),
                                _quantile_sample(sk_s, SAMPLE_K)])
        spl = _splitters(samp, num_peers)
        rbk, rbi, r_max = _exchange_sorted(
            rk_s, ri_s, spl, num_peers, send_cap_r, _BUILD_PAD_KEY,
            _n_real(ri_s))
        sbk, sbi, s_max = _exchange_sorted(
            sk_s, si_s, spl, num_peers, send_cap_s, _PROBE_PAD_KEY,
            _n_real(si_s))
        sk, _ = _sort_build(rbk, rbi)
        ppid, _, cnt = _count_sorted(sk, sbk, sbi)
        matched = (cnt > 0).astype(jnp.int32)
        ovf = jnp.stack([jax.lax.pmax(r_max, ROW_AXIS),
                         jax.lax.pmax(s_max, ROW_AXIS)])
        return ppid, matched, ovf

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS)),
        out_specs=(P(ROW_AXIS), P(ROW_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def _distributed_match_ids(r_keys, s_keys, mesh, slack, max_retries):
    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.shape[ROW_AXIS]
    r_keys = np.asarray(r_keys, np.int32)
    s_keys = np.asarray(s_keys, np.int32)
    rk, ri = _pad_sharded(r_keys, np.arange(len(r_keys), dtype=np.int32),
                          ndev)
    sk, si = _pad_sharded(s_keys, np.arange(len(s_keys), dtype=np.int32),
                          ndev)
    shard = NamedSharding(mesh, P(ROW_AXIS))
    rk, ri, sk, si = (jax.device_put(x, shard) for x in (rk, ri, sk, si))
    cap_r = round_up(int(cdiv(len(np.asarray(rk)) // ndev, ndev) * slack) + 64, 64)
    cap_s = round_up(int(cdiv(len(np.asarray(sk)) // ndev, ndev) * slack) + 64, 64)
    for _ in range(max_retries):
        fn = make_shuffle_semi_fn(mesh, cap_r, cap_s)
        ppid, matched, ovf = fn(rk, ri, sk, si)
        ovf = np.asarray(ovf)
        if ovf[0] <= cap_r and ovf[1] <= cap_s:
            break
        cap_r = max(cap_r, round_up(int(ovf[0]), 64))
        cap_s = max(cap_s, round_up(int(ovf[1]), 64))
    else:
        raise RuntimeError(f"semi join send caps did not converge: {ovf}")
    ppid = np.asarray(ppid)
    matched = np.asarray(matched)
    valid = ppid >= 0
    return ppid[valid], matched[valid] > 0


def distributed_semi_join(r_keys, s_keys, *, mesh=None, slack: float = 1.25,
                          max_retries: int = 3):
    """Probe-side distributed semi join: sorted global ids of s rows with
    >= 1 match in r. Multiset-equal to ops.merge_join.semi_join."""
    ids, matched = _distributed_match_ids(r_keys, s_keys, mesh, slack,
                                          max_retries)
    return np.sort(ids[matched])


def distributed_anti_join(r_keys, s_keys, *, mesh=None, slack: float = 1.25,
                          max_retries: int = 3):
    """Probe-side distributed anti join: sorted global ids of s rows with
    NO match in r. Multiset-equal to ops.merge_join.anti_join."""
    ids, matched = _distributed_match_ids(r_keys, s_keys, mesh, slack,
                                          max_retries)
    return np.sort(ids[~matched])


def _pad_sharded(a, ids, mult):
    """Pad (keys, ids) to a multiple of the mesh size (pad ids = -1)."""
    target = round_up(max(len(a), 1), mult)
    if target == len(a):
        return a, ids
    pad_n = target - len(a)
    return (np.concatenate([a, np.zeros(pad_n, np.int32)]),
            np.concatenate([ids, np.full(pad_n, -1, np.int32)]))


def _coarse_cap(rows: int) -> int:
    """Send capacity for ``rows`` measured rows: 64 rows of headroom,
    rounded up to a granule of ~1/64 of the size (at least 256), so
    reruns on similar data hit the same compiled executable."""
    need = rows + 64
    return round_up(need, max(256, 1 << max(need.bit_length() - 7, 0)))


def recommended_slack(distribution: str = "uniform") -> float:
    """Send-segment slack factor over the balanced expectation n_local/P.
    Splitter sampling balances row counts to ~1% on uniform keys; Zipf
    workloads keep headroom until a heavy hitter exceeds one device's
    share (atomic keys cannot be split by range partitioning either — the
    skew path replicates them). The driver's retry loop covers the tail
    either way."""
    return 1.25 if distribution == "uniform" else 4.0


def distributed_hash_join(
    r_keys,
    s_keys,
    *,
    mesh=None,
    slack: float = 1.25,
    expected_matches: int | None = None,
    max_retries: int = 3,
    skew: bool = False,
    pipeline_chunks: int = 1,
    auto_caps: bool = True,
):
    """Driver: exact-size distributed equi-join over all mesh devices.

    ``skew=True`` routes through the heavy-hitter splitting path
    (:mod:`tpujoin.parallel.skew`) — use for Zipf-like key distributions.
    ``pipeline_chunks > 1`` exchanges the probe side in that many slices
    with the collective for slice c+1 overlapping the local join of slice c.

    ``auto_caps`` (default, unpipelined path): size the send buffers from
    the EXACT psum'd segment maxima of a splitter-stats pre-pass instead
    of ``slack`` x the balanced expectation; caps are rounded up to a
    granule of ~1/64 of their size so executables repeat across runs.
    ``slack`` then only sizes the result buffer estimate.

    Pads both tables to a multiple of the mesh size, row-shards them,
    runs the shuffle-join step, and trims each device's padded result to its
    exact count. Retries with doubled capacities on detected overflow.

    Returns (r_ids, s_ids) numpy arrays — global row-id pairs, multiset-equal
    to the single-chip :func:`tpujoin.ops.hash_join.hash_join` result.
    """
    if skew:
        from tpujoin.parallel.skew import distributed_hash_join_skew

        return distributed_hash_join_skew(
            r_keys, s_keys, mesh=mesh, slack=max(slack, 2.0),
            expected_matches=expected_matches)
    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.shape[ROW_AXIS]
    r_keys = np.asarray(r_keys)
    s_keys = np.asarray(s_keys)
    n, m_rows = len(r_keys), len(s_keys)

    def pad_to(a, ids, mult):
        target = round_up(max(len(a), 1), mult)
        if target == len(a):
            return a, ids
        pad_n = target - len(a)
        a = np.concatenate([a, np.zeros(pad_n, np.int32)])
        ids = np.concatenate([ids, np.full(pad_n, -1, np.int32)])
        return a, ids

    r_ids_in = np.arange(n, dtype=np.int32)
    s_ids_in = np.arange(m_rows, dtype=np.int32)
    rk, ri = pad_to(r_keys.astype(np.int32), r_ids_in, ndev)
    sk, si = pad_to(s_keys.astype(np.int32), s_ids_in,
                    ndev * max(pipeline_chunks, 1))

    shard = NamedSharding(mesh, P(ROW_AXIS))
    rk, ri, sk, si = (jax.device_put(x, shard) for x in (rk, ri, sk, si))

    if expected_matches is None:
        expected_matches = max(n, m_rows)  # conservative default
    nchunks = max(pipeline_chunks, 1)
    use_auto = auto_caps and nchunks == 1
    if use_auto:
        stats_fn = make_splitter_stats_fn(mesh)
        rk_s, ri_s, sk_s, si_s, spl, maxes = stats_fn(rk, ri, sk, si)
        maxes_np = np.asarray(maxes)
        cap_r = _coarse_cap(int(maxes_np[0]))
        cap_s = _coarse_cap(int(maxes_np[1]))
    else:
        cap_r = round_up(
            int(cdiv(len(np.asarray(rk)) // ndev, ndev) * slack) + 64, 64)
        cap_s = round_up(
            int(cdiv(len(np.asarray(sk)) // (ndev * nchunks), ndev)
                * slack) + 64, 64)
    cap_res = round_up(
        int(expected_matches / (ndev * nchunks) * slack) + 64, 64)

    cap_retries = max_retries
    while True:
        if nchunks > 1:
            fn = make_shuffle_join_pipelined_fn(mesh, cap_r, cap_s, cap_res,
                                                num_chunks=nchunks)
            r_out, s_out, totals, ovf = fn(rk, ri, sk, si)
        elif use_auto:
            fn = make_shuffle_join_presorted_fn(mesh, cap_r, cap_s, cap_res)
            r_out, s_out, totals, ovf = fn(rk_s, ri_s, sk_s, si_s, spl)
        else:
            fn = make_shuffle_join_fn(mesh, cap_r, cap_s, cap_res)
            r_out, s_out, totals, ovf = fn(rk, ri, sk, si)
        ovf = np.asarray(ovf)
        if ovf[0] <= cap_r and ovf[1] <= cap_s and ovf[2] <= cap_res:
            break
        if cap_retries == 0:
            raise RuntimeError(
                f"shuffle join capacities did not converge: {ovf}")
        cap_retries -= 1
        cap_r = max(cap_r, round_up(int(ovf[0]), 64))
        cap_s = max(cap_s, round_up(int(ovf[1]), 64))
        cap_res = max(cap_res, round_up(int(ovf[2]), 64))

    r_out = np.asarray(r_out).reshape(ndev * nchunks, -1)
    s_out = np.asarray(s_out).reshape(ndev * nchunks, -1)
    totals = np.asarray(totals).reshape(-1)
    parts_r = [r_out[d, : totals[d]] for d in range(ndev * nchunks)]
    parts_s = [s_out[d, : totals[d]] for d in range(ndev * nchunks)]
    return (
        np.concatenate(parts_r) if parts_r else np.empty(0, np.int32),
        np.concatenate(parts_s) if parts_s else np.empty(0, np.int32),
    )
