"""Sort-merge probe pipeline (v2).

Same contract as :mod:`tpujoin.ops.hash_join`'s count/materialize phases —
exact-size (rowID_R, rowID_S) multiset — but the probe side is sorted once
(one 2-operand sort), so the count phase's rank lookups read both sides in
key order:

  count:       sort probe (keys, ids) -> hash_join.ranks against the
               sorted build keys -> (lo, counts) per sorted probe row
  materialize: hash_join.probe_materialize straight over the count-phase
               state (rows with zero matches own no output slot, so no
               compaction), carrying the sorted probe ids

The relationship between v1 (hash_join) and v2 (merge_join) deliberately
mirrors the reference's join_v1 -> join_v2 lineage: identical semantics,
a re-engineered probe path.

Emitting results in sorted-probe order is free parity: the output is an
unordered multiset (the oracle compares sorted pairs, reference
shared.cpp:167-171), so no unsort pass is ever needed.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpujoin.ops.hash_join import HashJoinTable, build, ranks
from tpujoin.ops.hash_join import probe_materialize as hj_materialize
from tpujoin.utils.shapes import round_up


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SortedProbe:
    """Count-phase state, all in sorted-probe-key order."""

    probe_ids: jax.Array   # [m] original probe row ids under the sort
    lo: jax.Array          # [m] lower bound in sorted build keys
    counts: jax.Array      # [m] match counts

    def tree_flatten(self):
        return (self.probe_ids, self.lo, self.counts), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)


def exact_sum_i32(x: jax.Array) -> jax.Array:
    """Exact int64 sum of an i32 array (skewed joins exceed 2^31 pairs)."""
    with jax.enable_x64(True):
        return jnp.sum(x.astype(jnp.int64))


@jax.jit
def probe_count(ht: HashJoinTable, probe_keys: jax.Array):
    """Count phase. Returns (state, total, nonzero_rows) — total is the
    exact result size (int64: skewed workloads exceed 2^31 pairs, e.g.
    Zipf(1.0) at 10M x 10M is ~10^11 pairs), nonzero_rows the number of
    probe rows with >= 1 match (the width of the RLE result)."""
    m = probe_keys.shape[0]
    ids = jnp.arange(m, dtype=jnp.int32)
    # unstable: ids are distinct, and the join result is an unordered
    # multiset — tie order carries nothing
    psk, pid = jax.lax.sort((probe_keys, ids), num_keys=1, is_stable=False)
    lo, cnt = ranks(ht.sorted_keys, psk)
    total = exact_sum_i32(cnt)
    nonzero = jnp.sum((cnt > 0).astype(jnp.int32))
    return SortedProbe(pid, lo, cnt), total, nonzero


def _compact(state: SortedProbe, k_cap: int, all_matched: bool = False):
    """The count-phase rows with >= 1 match, in order, at static width
    k_cap: (lo_c, cnt_c, sid_c), tail zero-padded. Exclusive cumsum of the
    match mask gives each kept row its slot, and one dropping scatter per
    column writes it there.

    ``all_matched`` (static) asserts nonzero == m — the caller checked
    every probe row has a match (always true on fully-covered key
    domains, e.g. the reference's 10Mx10M config) — making compaction the
    identity."""
    cols = (state.lo, state.counts, state.probe_ids)
    m = state.counts.shape[0]
    if all_matched:
        if k_cap <= m:
            return tuple(jax.lax.slice_in_dim(c, 0, k_cap) for c in cols)
        return tuple(jnp.pad(c, (0, k_cap - m)) for c in cols)
    keep = state.counts > 0
    slot = jnp.cumsum(keep.astype(jnp.int32)) - keep.astype(jnp.int32)
    slot = jnp.where(keep, slot, k_cap)
    return tuple(jnp.zeros((k_cap,), jnp.int32).at[slot].set(c, mode="drop")
                 for c in cols)


def probe_materialize(
    ht: HashJoinTable,
    state: SortedProbe,
    capacity: int,
    probe_base: int | jax.Array = 0,
):
    """Materialize phase over the v2 count state: hash_join's
    materialize with the sorted probe ids carried through. Returns
    (r_ids, s_ids, total, fits)."""
    return hj_materialize(ht, state.lo, state.counts, capacity, probe_base,
                          state.probe_ids)


@functools.partial(jax.jit, static_argnames=("k_cap", "all_matched"))
def probe_rle(ht: HashJoinTable, state: SortedProbe, k_cap: int,
              all_matched: bool = False):
    """Factorized (RLE) result at static row capacity: per matched probe
    row, (probe_id, lo, cnt) over ``ht.sorted_ids``. This IS the join result
    in run-length form — total pairs = sum(cnt) — produced without paying
    the pair-expansion cost. The natural interface for high-duplication
    workloads (the reference's 10Mx10M config materializes 1B pairs / 8.5 GB
    just to hold ~100k distinct runs, join-performances.md:3-5); downstream
    operators (aggregations, semi-joins) can consume runs directly, and
    :func:`probe_materialize` expands on demand.

    ``all_matched`` (static, asserted by the caller from nonzero == m)
    makes compaction the identity."""
    lo_c, cnt_c, sid_c = _compact(state, k_cap, all_matched=all_matched)
    return sid_c, lo_c, cnt_c


def merge_join_rle(build_keys, probe_keys, *, row_pad_multiple: int = 1 << 16):
    """Full-join driver returning the factorized result:
    (probe_ids, lo, cnt, sorted_build_ids) with exact row count — the
    expansion of row r is pairs (sorted_build_ids[lo[r]+j], probe_ids[r])
    for j < cnt[r]."""
    build_keys = jnp.asarray(build_keys)
    probe_keys = jnp.asarray(probe_keys)
    ht = build(build_keys)
    state, total, nonzero = probe_count(ht, probe_keys)
    nonzero = int(nonzero)
    if nonzero == 0:
        e = np.empty(0, np.int32)
        return e, e, e, np.asarray(ht.sorted_ids)
    k_cap = round_up(nonzero, row_pad_multiple)
    sid, lo, cnt = probe_rle(ht, state, k_cap,
                             all_matched=nonzero == probe_keys.shape[0])
    return (np.asarray(sid[:nonzero]), np.asarray(lo[:nonzero]),
            np.asarray(cnt[:nonzero]), np.asarray(ht.sorted_ids))


@jax.jit
def _match_partition(state: SortedProbe):
    """Probe ids partitioned by matchedness: the first ``nonzero`` entries
    are the matched probe rows (ascending id), the tail the unmatched ones
    — the compact-by-sort idiom reduced to ONE single-operand i32 sort by
    packing the unmatched flag above the id (the ops.filter idiom). One
    count phase answers semi, anti and the outer-join NULL set."""
    m = state.probe_ids.shape[0]
    if m < (1 << 30):
        packed = jnp.where(state.counts == 0,
                           state.probe_ids + jnp.int32(1 << 30),
                           state.probe_ids)
        return (jax.lax.sort(packed, is_stable=False)
                & jnp.int32((1 << 30) - 1))
    z = (state.counts == 0).astype(jnp.int32)
    _, sid_s = jax.lax.sort((z, state.probe_ids), num_keys=1,
                            is_stable=False)
    return sid_s


def semi_join(build_keys, probe_keys, **_ignored):
    """Probe-side semi join: ids of probe rows with >= 1 build match.
    (The reference supports only inner join; semi/anti/outer complete the
    equi-join family on the same count machinery — a semi join is the count
    phase's nonzero set, no materialization at all.)"""
    ht = build(jnp.asarray(build_keys))
    state, _, nonzero = probe_count(ht, jnp.asarray(probe_keys))
    sid_s = _match_partition(state)
    return np.sort(np.asarray(sid_s[:int(nonzero)]))


def anti_join(build_keys, probe_keys, **_ignored):
    """Probe-side anti join: ids of probe rows with NO build match."""
    ht = build(jnp.asarray(build_keys))
    state, _, nonzero = probe_count(ht, jnp.asarray(probe_keys))
    sid_s = _match_partition(state)
    return np.sort(np.asarray(sid_s[int(nonzero):]))


def left_outer_join(build_keys, probe_keys, **kwargs):
    """Probe-side left outer join: all inner pairs plus (-1, probe_id) for
    unmatched probe rows (NULL build side encoded as -1). Costs one count
    plus one materialize — the unmatched set falls out of the same
    count-state partition the materialize phase compacts by, so nothing
    is recomputed."""
    build_keys = jnp.asarray(build_keys)
    probe_keys = jnp.asarray(probe_keys)
    ht = build(build_keys)
    state, total_a, nonzero_a = probe_count(ht, probe_keys)
    total, nonzero = int(total_a), int(nonzero_a)
    sid_s = _match_partition(state)
    unmatched = np.asarray(sid_s[nonzero:])

    if total == 0:
        r_inner = np.empty(0, np.int32)
        s_inner = np.empty(0, np.int32)
    else:
        pad = kwargs.get("result_pad_multiple", 1 << 20)
        cap = round_up(total, pad)
        r_ids, s_ids, _, fits = probe_materialize(ht, state, cap)
        assert bool(fits), "materialize capacity undersized"
        r_inner = np.asarray(r_ids[:total])
        s_inner = np.asarray(s_ids[:total])

    r_out = np.concatenate([r_inner, np.full(len(unmatched), -1, np.int32)])
    s_out = np.concatenate([s_inner, unmatched])
    return r_out, s_out


def merge_join(
    build_keys,
    probe_keys,
    *,
    probe_chunk_rows: int | None = None,
    result_pad_multiple: int = 1 << 20,
):
    """Full-join driver on the v2 pipeline; same contract as
    ops.hash_join.hash_join. Returns exact-size numpy (r_ids, s_ids)."""
    build_keys = jnp.asarray(build_keys)
    probe_keys = jnp.asarray(probe_keys)
    m = int(probe_keys.shape[0])
    chunk = m if probe_chunk_rows is None else min(probe_chunk_rows, max(m, 1))

    ht = build(build_keys)
    out_r, out_s = [], []
    for start in range(0, m, chunk) if m else []:
        end = min(start + chunk, m)
        pk = jax.lax.slice_in_dim(probe_keys, start, end)
        if end - start < chunk:
            # pad with INT32_MAX - 1: sorts to the tail, matches nothing in
            # the benchmark key domain, and (unlike the v1 driver's masked
            # variant) keeps one compiled executable per chunk shape
            pk = jnp.pad(pk, (0, chunk - (end - start)),
                         constant_values=np.int32(0x7FFFFFFE))
        state, total, _ = probe_count(ht, pk)
        total = int(total)
        if total == 0:
            continue
        cap = round_up(total, result_pad_multiple)
        r_ids, s_ids, _, fits = probe_materialize(ht, state, cap,
                                                  probe_base=start)
        assert bool(fits), "materialize capacity undersized"
        out_r.append(np.asarray(r_ids[:total]))
        out_s.append(np.asarray(s_ids[:total]))

    if not out_r:
        return np.empty((0,), np.int32), np.empty((0,), np.int32)
    return np.concatenate(out_r), np.concatenate(out_s)
