"""Multi-column equi-join and filter pushdown.

BASELINE.json config 2 frames the reference's join_v2 workload as a
"multi-column join + selection.mlir filter pushdown". The reference itself
joins single i32 key columns (its hash is ``key % hashTableSize``,
reference join_v1.mlir:206-210) and applies no pushdown; this module
provides both as first-class engine features.

Design: composite keys are reduced to one 32-bit *candidate* key by mixing
the per-column hashes (:func:`tpujoin.ops.radix.hash32`). Equal tuples get
equal candidate keys by construction; unequal tuples collide only at hash
probability. The single-key join then produces a candidate pair superset,
and a vectorized post-filter keeps exactly the pairs whose key columns are
all equal — the exact-multiset contract survives hashing. This is the
standard vectorized-DB treatment of composite keys and avoids any wide-key
sort (XLA sorts with multiple key operands cost one payload lane per extra
column; the candidate-hash form keeps the hot sort at 8 bytes/row).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpujoin.core.table import Table
from tpujoin.ops.filter import filter_materialize

from tpujoin.ops.radix import hash32
from tpujoin.utils.shapes import round_up

def combined_key(table: Table, on: list[str]) -> jax.Array:
    """One i32 candidate key per row from the named key columns."""
    cols = [table[c] for c in on]
    if len(cols) == 1:
        # same sentinel-range clamp as the multi-column case: pushdown
        # pads kept-buffer tails with 0x7FFFFFFE/0x7FFFFFFF, so a raw
        # single-column key equal to either could otherwise match a pad
        # slot. Folding onto 0x7FFFFFFD only creates
        # candidate collisions, which the exact post-filter removes.
        return jnp.minimum(cols[0].astype(jnp.int32), jnp.int32(0x7FFFFFFD))
    h = hash32(cols[0].astype(jnp.int32))
    for c in cols[1:]:
        # Boost-style hash_combine: order-sensitive mix of successive columns
        h = hash32((h ^ (hash32(c.astype(jnp.int32))
                         + jnp.uint32(0x9E3779B9)
                         + (h << 6) + (h >> 2))).astype(jnp.int32))
    # keep hashed keys out of the engine's sentinel range (0x7FFFFFFE is
    # the probe-chunk pad, 0x7FFFFFFF the sort pad): folding the top two
    # values onto 0x7FFFFFFD only adds hash collisions, which the exact
    # post-filter already removes
    return jnp.minimum(h.astype(jnp.int32), jnp.int32(0x7FFFFFFD))


@functools.partial(jax.jit, static_argnames=("capacity", "num_cols"))
def _exact_filter(r_cols, s_cols, cand_r, cand_s, capacity: int, num_cols: int):
    """Keep candidate pairs whose key columns are all equal (drops hash
    collisions). Invalid candidates (id -1 padding) are dropped too."""
    valid = cand_r >= 0
    safe_r = jnp.where(valid, cand_r, 0)
    safe_s = jnp.where(valid, cand_s, 0)
    eq = valid
    for i in range(num_cols):
        eq = eq & (jnp.take(r_cols[i], safe_r) == jnp.take(s_cols[i], safe_s))
    slots, total = filter_materialize(eq, capacity)
    sel = jnp.clip(slots, 0, cand_r.shape[0] - 1)
    keep = slots >= 0
    out_r = jnp.where(keep, jnp.take(cand_r, sel), -1)
    out_s = jnp.where(keep, jnp.take(cand_s, sel), -1)
    return out_r, out_s, total


@jax.jit
def _take_pad(full, ids, pad_key):
    """full[ids] with ids < 0 mapped to ``pad_key`` (O(result) gather)."""
    valid = ids >= 0
    hk = jnp.take(full, jnp.clip(ids, 0, full.shape[0] - 1))
    return jnp.where(valid, hk, pad_key)


@functools.partial(jax.jit, static_argnames=("cap",))
def _push_sort2(hk_full, mask, cap, pad_key):
    """Compact (candidate key, row id) by ONE 2-operand sort: the fail
    bit packed above the id is the sort key, the candidate key rides as
    payload — no O(kept) gather and flat cost in selectivity."""
    n = hk_full.shape[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    packed = jnp.where(mask, ids, ids + jnp.int32(1 << 30))
    sp, hk_s = jax.lax.sort((packed, hk_full), num_keys=1,
                            is_stable=False)    # packed ids distinct
    total = jnp.sum(mask.astype(jnp.int32))
    if cap <= n:
        sp = jax.lax.slice_in_dim(sp, 0, cap)
        hk_s = jax.lax.slice_in_dim(hk_s, 0, cap)
    else:
        sp = jnp.pad(sp, (0, cap - n), constant_values=np.int32(1 << 30))
        hk_s = jnp.pad(hk_s, (0, cap - n))
    t = jnp.arange(cap, dtype=jnp.int32)
    ids_c = jnp.where(t < total, sp & jnp.int32((1 << 30) - 1), -1)
    hk_c = jnp.where(t < total, hk_s, pad_key)
    return ids_c, hk_c


@functools.partial(jax.jit, static_argnames=("cap",))
def _push_sort3(hk_full, mask, cap, pad_key):
    """Like :func:`_push_sort2` but for tables at or above 2^30 rows,
    where no fail bit fits above the id in one i32: a 3-operand sort on
    an explicit drop flag (kept rows first; id and candidate key ride as
    payload)."""
    n = hk_full.shape[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    flag = jnp.where(mask, jnp.int32(0), jnp.int32(1))
    _, ids_s, hk_s = jax.lax.sort((flag, ids, hk_full), num_keys=1,
                                  is_stable=False)
    total = jnp.sum(mask.astype(jnp.int32))
    if cap <= n:
        ids_s = jax.lax.slice_in_dim(ids_s, 0, cap)
        hk_s = jax.lax.slice_in_dim(hk_s, 0, cap)
    else:
        ids_s = jnp.pad(ids_s, (0, cap - n), constant_values=np.int32(-1))
        hk_s = jnp.pad(hk_s, (0, cap - n))
    t = jnp.arange(cap, dtype=jnp.int32)
    ids_c = jnp.where(t < total, ids_s, -1)
    hk_c = jnp.where(t < total, hk_s, pad_key)
    return ids_c, hk_c


def _push(table: Table, pred, col, pad_key, on, result_pad_multiple):
    """One side's pushdown: (kept_row_ids, candidate_keys) at bucketed
    static width, tail slots sentinel-keyed / id -1 so pads never join."""
    from tpujoin.ops.filter import filter_count

    hk_full = combined_key(table, on)
    if pred is None:
        return jnp.arange(table.num_rows, dtype=jnp.int32), hk_full
    mask = pred(table[col])
    total = int(filter_count(mask))
    if total == 0:
        return None, None
    cap = round_up(total, result_pad_multiple)
    if table.num_rows < (1 << 30):
        return _push_sort2(hk_full, mask, cap, pad_key)
    # >= 2^30 rows: the packed fail-bit idiom has no headroom above the
    # id, so compact by a 3-operand flag sort instead (still no O(kept)
    # gather; ties within a flag class carry no information)
    return _push_sort3(hk_full, mask, cap, pad_key)


def hash_join_multi(
    r: Table,
    s: Table,
    on: list[str] | str,
    *,
    result_pad_multiple: int = 1 << 16,
    return_numpy: bool = True,
):
    """Equi-join on one or more key columns; exact multiset of row-id pairs.

    Like :func:`tpujoin.ops.hash_join.hash_join` but joining on the
    conjunction of equality over every column in ``on``. Fully
    device-resident: the candidate join runs on the v2 sort-merge engine
    and the exact post-filter consumes its padded device output directly
    — the only host transfers are the scalar counts (the reference's own
    result memcpy sits outside its timers, join_v1.mlir:614-615).

    Returns (r_ids, s_ids) numpy arrays, or with ``return_numpy=False``
    (device_r, device_s, total) where the first ``total`` rows are valid.
    """
    from tpujoin.ops import merge_join as mj

    if isinstance(on, str):
        on = [on]
    hk_r = combined_key(r, on)
    hk_s = combined_key(s, on)
    ht = mj.build(hk_r)
    state, total_a, _ = mj.probe_count(ht, hk_s)
    total = int(total_a)
    if total == 0:
        e = np.empty(0, np.int32)
        return (e, e) if return_numpy else (jnp.asarray(e), jnp.asarray(e), 0)
    cap = round_up(total, result_pad_multiple)
    cand_r, cand_s, _, _ = mj.probe_materialize(ht, state, cap)
    # device arrays, pad slots = -1 (dropped below)
    r_cols = tuple(r[c] for c in on)
    s_cols = tuple(s[c] for c in on)
    out_r, out_s, total2_a = _exact_filter(r_cols, s_cols, cand_r, cand_s,
                                           cap, len(on))
    total2 = int(total2_a)
    if return_numpy:
        return np.asarray(out_r[:total2]), np.asarray(out_s[:total2])
    return out_r, out_s, total2


def join_with_pushdown(
    r: Table,
    s: Table,
    on: list[str] | str,
    *,
    r_pred=None,
    s_pred=None,
    r_pred_col: str | None = None,
    s_pred_col: str | None = None,
    result_pad_multiple: int = 1 << 16,
    return_numpy: bool = True,
):
    """Filter-pushdown join: apply per-side predicates *before* the join
    (the selection.mlir filter fused upstream of join_v2 per BASELINE.json
    config 2), then join only the surviving rows. Returned ids refer to
    the ORIGINAL tables. Fully device-resident (filter, join, and the
    kept-row -> original-row id remap all stay on device; only scalar
    counts cross the host boundary).

    The per-side pushdown gathers only ONE array at the kept rows — the
    precomputed candidate key (elementwise over the full column, free) —
    never the key/value columns themselves; the exact post-filter reads
    the original columns at O(result) candidate pairs and the kept->original
    remap is the compaction output itself. Kept buffers stay at bucketed
    static widths, padded with per-side sentinel keys above the candidate
    range (combined_key caps real keys at 0x7FFFFFFD) so pads never match
    anything — including each other.

    All jitted helpers live at MODULE level: nested ``@jax.jit`` defs are
    fresh function objects per driver call, so every invocation would
    recompile its whole graph set."""
    from tpujoin.ops import merge_join as mj

    if isinstance(on, str):
        on = [on]

    r_ids_kept, hk_r = _push(r, r_pred, r_pred_col,
                             np.int32(0x7FFFFFFF), on, result_pad_multiple)
    s_ids_kept, hk_s = _push(s, s_pred, s_pred_col,
                             np.int32(0x7FFFFFFE), on, result_pad_multiple)
    if hk_r is None or hk_s is None:
        e = np.empty(0, np.int32)
        return (e, e) if return_numpy else (jnp.asarray(e), jnp.asarray(e),
                                            0)

    ht = mj.build(hk_r)
    state, total_a, _ = mj.probe_count(ht, hk_s)
    total_c = int(total_a)
    if total_c == 0:
        e = np.empty(0, np.int32)
        return (e, e) if return_numpy else (jnp.asarray(e), jnp.asarray(e),
                                            0)
    cap2 = round_up(total_c, result_pad_multiple)
    cand_r, cand_s, _, _ = mj.probe_materialize(ht, state, cap2)
    # kept-position -> original-row ids, O(result)
    cand_r = _take_pad(r_ids_kept, cand_r, np.int32(-1))
    cand_s = _take_pad(s_ids_kept, cand_s, np.int32(-1))
    r_cols = tuple(r[c] for c in on)
    s_cols = tuple(s[c] for c in on)
    out_r, out_s, total2_a = _exact_filter(r_cols, s_cols, cand_r, cand_s,
                                           cap2, len(on))
    total = int(total2_a)
    if return_numpy:
        return np.asarray(out_r[:total]), np.asarray(out_s[:total])
    return out_r, out_s, total
