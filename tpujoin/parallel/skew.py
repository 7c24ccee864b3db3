"""Skew-aware distributed shuffle join: heavy-hitter splitting.

BASELINE.json config 5 ("Skewed Zipf(1.0) key join across 4 cards with
heavy-hitter splitting"). Plain hash partitioning sends every row of a key to one
device, so a Zipf head key overloads one device (the reference has the
same pathology in miniature: its bucket chains grow with duplication,
join_v1.mlir:342-367 — and "Skewed datasets" is on its future-work list,
projectDescription.md:26).

Scheme (two-sided partial repartitioning, the PRPD family):

1. **Detect**: each device nominates its top-H locally-frequent keys per
   side; one ``all_gather`` merges nominations into a global candidate list
   (static size 2·H·P); exact global per-candidate counts come from local
   searchsorted counts + ``psum``. A key is *heavy* if either side's global
   count exceeds ``total_rows / P`` (one device's fair share).
2. **Split**: for each heavy key, the side with FEWER rows is *replicated*
   (broadcast via ``all_gather``) and the side with more rows is *sprayed*
   (round-robin across devices through the normal all_to_all buffers).
   Every matching pair still meets exactly once: the sprayed row's device
   holds all replicated partners.
3. **Join**: each device joins (normal-received ++ replica-gathered) R rows
   against the same for S — one sorted local join, no special cases.

Everything is static-shape: candidate list, replica buffers, and send
buffers have fixed capacities with detect-and-retry overflow telemetry,
like the uniform path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from tpujoin.ops.hash_join import ranks
from tpujoin.ops.radix import partition_ids
from tpujoin.parallel.mesh import ROW_AXIS, make_mesh
from tpujoin.parallel.shuffle_join import (
    _BUILD_PAD_KEY,
    _PROBE_PAD_KEY,
    _SU,
    _local_join,
)
from tpujoin.utils.shapes import round_up


def _local_top_keys(keys, ids, h: int, pad_key):
    """Top-h locally most frequent keys (pad_key where fewer)."""
    valid = jnp.where(ids >= 0, keys, pad_key)
    sk = jax.lax.sort(valid, is_stable=False)
    _, cnt = ranks(sk, sk)
    is_first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sk[1:] != sk[:-1]])
    score = jnp.where(is_first & (sk != pad_key), cnt, 0)
    _, idx = jax.lax.top_k(score, h)
    top = jnp.take(sk, idx)
    topc = jnp.take(score, idx)
    return jnp.where(topc > 0, top, pad_key)


def _route_and_pack(keys, ids, rep_mask, spray_mask, num_peers: int,
                    cap_norm: int, cap_rep: int, pad_key):
    """Split local rows into the [P, cap_norm] all_to_all buffer (normal +
    sprayed rows) and the [cap_rep] replica buffer (broadcast rows)."""
    n = keys.shape[0]
    me = jax.lax.axis_index(ROW_AXIS)
    pid = partition_ids(keys, num_peers)
    spray_pid = ((jnp.arange(n, dtype=jnp.int32) + me)
                 % jnp.int32(num_peers))
    pid = jnp.where(spray_mask, spray_pid, pid)
    # replicated rows and driver padding leave the normal route
    pid = jnp.where(rep_mask, jnp.int32(num_peers), pid)
    pid = jnp.where(ids < 0, jnp.int32(num_peers + 1), pid)
    # rep rows sort directly after the P normal partitions
    # unstable: within a pid segment the row order is arbitrary (the
    # local join re-sorts received rows by key anyway)
    spid, skeys, sids = jax.lax.sort((pid, keys, ids), num_keys=1,
                                     is_stable=False)
    starts, counts = ranks(spid, jnp.arange(num_peers + 1, dtype=jnp.int32),
                           method=_SU)

    # contiguous per-peer slices, never a [P, C] element gather (see
    # shuffle_join._send_buffer): pad the tail so no slice clamps
    pad_n = max(cap_norm, cap_rep)
    skeys_p = jnp.concatenate(
        [skeys, jnp.full((pad_n,), pad_key, jnp.int32)])
    sids_p = jnp.concatenate([sids, jnp.full((pad_n,), -1, jnp.int32)])
    c = jnp.arange(cap_norm, dtype=jnp.int32)
    rows_k, rows_i = [], []
    for p in range(num_peers):
        k_p = jax.lax.dynamic_slice_in_dim(skeys_p, starts[p], cap_norm)
        i_p = jax.lax.dynamic_slice_in_dim(sids_p, starts[p], cap_norm)
        valid = c < counts[p]
        rows_k.append(jnp.where(valid, k_p, pad_key))
        rows_i.append(jnp.where(valid, i_p, -1))
    buf_k = jnp.stack(rows_k)
    buf_i = jnp.stack(rows_i)

    rc = jnp.arange(cap_rep, dtype=jnp.int32)
    rvalid = rc < counts[num_peers]
    rep_k = jnp.where(rvalid, jax.lax.dynamic_slice_in_dim(
        skeys_p, starts[num_peers], cap_rep), pad_key)
    rep_i = jnp.where(rvalid, jax.lax.dynamic_slice_in_dim(
        sids_p, starts[num_peers], cap_rep), -1)

    max_norm = jnp.max(counts[:num_peers])
    return buf_k, buf_i, rep_k, rep_i, max_norm, counts[num_peers]


def make_skew_join_fn(
    mesh,
    send_cap_r: int,
    send_cap_s: int,
    rep_cap_r: int,
    rep_cap_s: int,
    local_result_cap: int,
    top_h: int = 64,
    heavy_factor: float = 1.0,
):
    """shard_map'd skew-aware join step. Same I/O contract as
    shuffle_join.make_shuffle_join_fn plus replica-buffer telemetry."""
    num_peers = mesh.shape[ROW_AXIS]

    def shard_fn(r_keys, r_ids, s_keys, s_ids):
        n_loc = r_keys.shape[0]
        m_loc = s_keys.shape[0]

        # ---- detect: global candidate list + exact global counts ----
        cand_r = _local_top_keys(r_keys, r_ids, top_h, _BUILD_PAD_KEY)
        cand_s = _local_top_keys(s_keys, s_ids, top_h, _BUILD_PAD_KEY)
        cand = jnp.concatenate([cand_r, cand_s])
        cand = jax.lax.all_gather(cand, ROW_AXIS).reshape(-1)
        cand = jax.lax.sort(cand)  # identical on every device

        sr = jax.lax.sort(jnp.where(r_ids >= 0, r_keys, _BUILD_PAD_KEY),
                          is_stable=False)
        ss = jax.lax.sort(jnp.where(s_ids >= 0, s_keys, _BUILD_PAD_KEY),
                          is_stable=False)
        gr = jax.lax.psum(ranks(sr, cand, method=_SU)[1], ROW_AXIS)
        gs = jax.lax.psum(ranks(ss, cand, method=_SU)[1], ROW_AXIS)

        # heavy_factor is a float multiplier on the per-peer average row
        # count (1.5 means "1.5x the average"); apply it in f32 so
        # fractional factors are honored, then floor to an i32 threshold
        base_r = jax.lax.psum(
            jnp.sum((r_ids >= 0).astype(jnp.int32)), ROW_AXIS) // num_peers
        base_s = jax.lax.psum(
            jnp.sum((s_ids >= 0).astype(jnp.int32)), ROW_AXIS) // num_peers
        factor = jnp.float32(max(float(heavy_factor), 0.0))
        thr_r = jnp.maximum(
            (factor * base_r.astype(jnp.float32)).astype(jnp.int32), 1)
        thr_s = jnp.maximum(
            (factor * base_s.astype(jnp.float32)).astype(jnp.int32), 1)
        heavy = ((gr > thr_r) | (gs > thr_s)) & (cand != _BUILD_PAD_KEY)
        # mode 1: replicate R, spray S (R side lighter); mode 2: converse
        mode = jnp.where(heavy, jnp.where(gr <= gs, 1, 2), 0).astype(jnp.int32)

        def lookup_mode(keys):
            slot = jnp.searchsorted(cand, keys, side="left", method=_SU)
            slot = jnp.clip(slot, 0, cand.shape[0] - 1)
            found = jnp.take(cand, slot) == keys
            return jnp.where(found, jnp.take(mode, slot), 0)

        rm = lookup_mode(r_keys)
        sm = lookup_mode(s_keys)

        # ---- split + exchange ----
        rbk, rbi, rrk, rri, r_max, r_repc = _route_and_pack(
            r_keys, r_ids, rm == 1, rm == 2, num_peers, send_cap_r,
            rep_cap_r, _BUILD_PAD_KEY)
        sbk, sbi, srk, sri, s_max, s_repc = _route_and_pack(
            s_keys, s_ids, sm == 2, sm == 1, num_peers, send_cap_s,
            rep_cap_s, _PROBE_PAD_KEY)

        rbk = jax.lax.all_to_all(rbk, ROW_AXIS, 0, 0)
        rbi = jax.lax.all_to_all(rbi, ROW_AXIS, 0, 0)
        sbk = jax.lax.all_to_all(sbk, ROW_AXIS, 0, 0)
        sbi = jax.lax.all_to_all(sbi, ROW_AXIS, 0, 0)
        rrk_g = jax.lax.all_gather(rrk, ROW_AXIS).reshape(-1)
        rri_g = jax.lax.all_gather(rri, ROW_AXIS).reshape(-1)
        srk_g = jax.lax.all_gather(srk, ROW_AXIS).reshape(-1)
        sri_g = jax.lax.all_gather(sri, ROW_AXIS).reshape(-1)

        bk = jnp.concatenate([rbk.reshape(-1), rrk_g])
        bi = jnp.concatenate([rbi.reshape(-1), rri_g])
        pk = jnp.concatenate([sbk.reshape(-1), srk_g])
        pi = jnp.concatenate([sbi.reshape(-1), sri_g])

        r_out, s_out, local_total = _local_join(bk, bi, pk, pi,
                                                local_result_cap)
        ovf = jnp.stack([
            jax.lax.pmax(r_max, ROW_AXIS),
            jax.lax.pmax(s_max, ROW_AXIS),
            jax.lax.pmax(local_total, ROW_AXIS),
            jax.lax.pmax(r_repc, ROW_AXIS),
            jax.lax.pmax(s_repc, ROW_AXIS),
        ])
        return r_out, s_out, local_total[None], ovf

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS)),
        out_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def run_skew_join(
    r_keys,
    s_keys,
    *,
    mesh=None,
    slack: float = 2.0,
    expected_matches: int | None = None,
    max_retries: int = 4,
    top_h: int = 64,
):
    """Pad, row-shard and run the skew-aware join step, growing every
    capacity the telemetry says overflowed. Returns the row-sharded
    padded results (r_out, s_out, totals) and the final telemetry vector
    [send_r, send_s, result, rep_r, rep_s] as host numpy: rep_r / rep_s
    are the most build / probe rows one device replicated (zero when no
    key was heavy)."""
    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.shape[ROW_AXIS]
    r_keys = np.asarray(r_keys, np.int32)
    s_keys = np.asarray(s_keys, np.int32)
    n, m_rows = len(r_keys), len(s_keys)

    def pad_to(a, ids, mult):
        target = round_up(max(len(a), 1), mult)
        pad_n = target - len(a)
        if pad_n:
            a = np.concatenate([a, np.zeros(pad_n, np.int32)])
            ids = np.concatenate([ids, np.full(pad_n, -1, np.int32)])
        return a, ids

    rk, ri = pad_to(r_keys, np.arange(n, dtype=np.int32), ndev)
    sk, si = pad_to(s_keys, np.arange(m_rows, dtype=np.int32), ndev)
    shard = NamedSharding(mesh, P(ROW_AXIS))
    rk, ri, sk, si = (jax.device_put(x, shard) for x in (rk, ri, sk, si))

    if expected_matches is None:
        expected_matches = max(n, m_rows)
    cap_r = round_up(int(len(r_keys) // max(ndev * ndev, 1) * slack) + 64, 64)
    cap_s = round_up(int(len(s_keys) // max(ndev * ndev, 1) * slack) + 64, 64)
    rep_r = rep_s = round_up(top_h * 4, 64)
    cap_res = round_up(int(expected_matches / ndev * slack) + 64, 64)

    ovf = None
    for _ in range(max_retries):
        fn = make_skew_join_fn(mesh, cap_r, cap_s, rep_r, rep_s, cap_res,
                               top_h=top_h)
        r_out, s_out, totals, ovf = fn(rk, ri, sk, si)
        ovf = np.asarray(ovf)
        if (ovf[0] <= cap_r and ovf[1] <= cap_s and ovf[2] <= cap_res
                and ovf[3] <= rep_r and ovf[4] <= rep_s):
            return r_out, s_out, totals, ovf
        cap_r = max(cap_r, round_up(int(ovf[0]), 64))
        cap_s = max(cap_s, round_up(int(ovf[1]), 64))
        cap_res = max(cap_res, round_up(int(ovf[2]), 64))
        rep_r = max(rep_r, round_up(int(ovf[3]), 64))
        rep_s = max(rep_s, round_up(int(ovf[4]), 64))
    raise RuntimeError(f"skew join capacities did not converge: {ovf}")


def distributed_hash_join_skew(r_keys, s_keys, *, mesh=None, **kwargs):
    """Driver: exact distributed join with heavy-hitter splitting.
    Same contract as shuffle_join.distributed_hash_join; ``kwargs`` are
    those of :func:`run_skew_join`."""
    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.shape[ROW_AXIS]
    r_out, s_out, totals, _ = run_skew_join(r_keys, s_keys, mesh=mesh,
                                            **kwargs)
    r_out = np.asarray(r_out).reshape(ndev, -1)
    s_out = np.asarray(s_out).reshape(ndev, -1)
    totals = np.asarray(totals).reshape(-1)
    return (
        np.concatenate([r_out[d, : totals[d]] for d in range(ndev)]),
        np.concatenate([s_out[d, : totals[d]] for d in range(ndev)]),
    )
