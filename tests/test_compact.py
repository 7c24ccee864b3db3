"""Stream compaction on plain XLA — the RLE result's matched-row
compaction (exclusive cumsum of the mask + one dropping scatter per
column), the packed-sort compactions of filter / aggregate / pushdown —
against numpy boolean-mask compaction."""
import jax.numpy as jnp
import numpy as np
import pytest

from tpujoin.oracle import check_group_agg
from tpujoin.ops import aggregate as agg
from tpujoin.ops import filter as flt
from tpujoin.ops import merge_join as mj
from tpujoin.ops.hash_join import build

N = 8192


def _state(sel, seed, n=N):
    rng = np.random.default_rng(seed)
    flag = rng.random(n) < sel
    cnt = np.where(flag, rng.integers(1, 6, n), 0).astype(np.int32)
    lo = np.sort(rng.integers(0, 1 << 20, n)).astype(np.int32)
    sid = rng.permutation(n).astype(np.int32)
    state = mj.SortedProbe(jnp.asarray(sid), jnp.asarray(lo),
                           jnp.asarray(cnt))
    return state, cnt, lo, sid, flag


def _compact(state, k_cap):
    return [np.asarray(a) for a in mj._compact(state, k_cap)]


@pytest.mark.parametrize("sel,seed", [
    (0.95, 0), (0.55, 1), (0.30, 2), (1.0, 3),
])
def test_matches_mask_compaction(sel, seed):
    state, cnt, lo, sid, flag = _state(sel, seed)
    nonzero = int(flag.sum())
    k_cap = 8192
    lo_c, cnt_c, sid_c = _compact(state, k_cap)
    np.testing.assert_array_equal(lo_c[:nonzero], lo[flag])
    np.testing.assert_array_equal(cnt_c[:nonzero], cnt[flag])
    np.testing.assert_array_equal(sid_c[:nonzero], sid[flag])
    # the tail is zero-padded
    assert np.all(lo_c[nonzero:] == 0)
    assert np.all(cnt_c[nonzero:] == 0)


def test_sparse_selectivity():
    state, cnt, lo, sid, flag = _state(0.02, 7)
    nonzero = int(flag.sum())
    lo_c, cnt_c, sid_c = _compact(state, 1024)
    np.testing.assert_array_equal(sid_c[:nonzero], sid[flag])
    np.testing.assert_array_equal(lo_c[:nonzero], lo[flag])


def test_empty_and_full():
    lo = jnp.arange(N, dtype=jnp.int32)
    sid = jnp.arange(N, dtype=jnp.int32)
    zero = mj.SortedProbe(sid, lo, jnp.zeros(N, jnp.int32))
    _, cnt_c, _ = _compact(zero, 1024)
    assert np.all(cnt_c == 0)

    full = mj.SortedProbe(sid, lo, jnp.ones(N, jnp.int32))
    _, _, sid_c = _compact(full, N)
    np.testing.assert_array_equal(sid_c, np.arange(N))


def test_capacity_below_nonzero_keeps_prefix():
    state, cnt, lo, sid, flag = _state(0.5, 11)
    lo_c, cnt_c, sid_c = _compact(state, 1024)
    np.testing.assert_array_equal(sid_c, sid[flag][:1024])
    np.testing.assert_array_equal(cnt_c, cnt[flag][:1024])


@pytest.mark.parametrize("sel,seed", [(0.5, 0), (0.9, 1), (1.0, 2)])
def test_filter_materialize_ids(sel, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(N) < sel
    nonzero = int(mask.sum())
    k_cap = 4096
    ids, total = flt.filter_materialize(jnp.asarray(mask), k_cap)
    assert int(total) == nonzero
    ids = np.asarray(ids)
    k = min(nonzero, k_cap)
    np.testing.assert_array_equal(ids[:k], np.flatnonzero(mask)[:k])
    assert np.all(ids[nonzero:] == -1)


def test_filter_table_matches_numpy():
    from tpujoin.core.table import Table

    rng = np.random.default_rng(3)
    vals = rng.random(N).astype(np.float32)
    t = Table({"v": jnp.asarray(vals), "id": jnp.arange(N, dtype=jnp.int32)})
    out = flt.filter_table(t, lambda v: v < 0.6, "v", pad_multiple=1024)
    np.testing.assert_array_equal(np.asarray(out["id"]),
                                  np.flatnonzero(vals < 0.6))


def test_group_materialize_matches_numpy():
    rng = np.random.default_rng(5)
    keys = rng.integers(1, 3000, N).astype(np.int32)
    gk, gc, ng = agg.group_materialize(jnp.asarray(keys), 4096)
    uk, uc = np.unique(keys, return_counts=True)
    g = int(ng)
    assert g == len(uk)
    np.testing.assert_array_equal(np.asarray(gk[:g]), uk)
    np.testing.assert_array_equal(np.asarray(gc[:g]), uc)
    assert np.all(np.asarray(gk[g:]) == -1)


def test_probe_rle_matches_numpy():
    rng = np.random.default_rng(13)
    bk = rng.integers(1, 400, 4096).astype(np.int32)
    pk = rng.integers(1, 1200, 4096).astype(np.int32)
    ht = build(jnp.asarray(bk))
    state, _, nonzero_a = mj.probe_count(ht, jnp.asarray(pk))
    nonzero = int(nonzero_a)
    assert 0 < nonzero < 4096
    sid, lo, cnt = (np.asarray(a)[:nonzero]
                    for a in mj.probe_rle(ht, state, 4096))
    sk = np.sort(bk)
    np.testing.assert_array_equal(lo, np.searchsorted(sk, pk[sid], "left"))
    np.testing.assert_array_equal(
        cnt, np.searchsorted(sk, pk[sid], "right") - lo)
    # every matched probe row exactly once, in key order
    np.testing.assert_array_equal(np.sort(sid),
                                  np.flatnonzero(np.isin(pk, bk)))
    assert np.all(np.diff(pk[sid]) >= 0)


def test_probe_materialize_integration():
    from tpujoin import oracle

    rng = np.random.default_rng(11)
    bk = rng.integers(1, 600, 4096).astype(np.int32)
    pk = rng.integers(1, 2000, 4096).astype(np.int32)  # ~30% matched
    ht = build(jnp.asarray(bk))
    state, total_a, _ = mj.probe_count(ht, jnp.asarray(pk))
    total = int(total_a)
    cap = ((total + 1023) // 1024) * 1024
    r, s, _, fits = mj.probe_materialize(ht, state, cap)
    assert bool(fits)
    assert oracle.check_join(bk, pk, np.asarray(r[:total]),
                             np.asarray(s[:total])) == 1


@pytest.mark.parametrize("dom,seed", [(700, 5), (60, 6)])
def test_group_agg_columns_match_numpy(dom, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, dom, N).astype(np.int32)
    vals = rng.integers(-1000, 1 << 20, N).astype(np.int32)
    gk, gc, (sh, slo), mn, mx, ng = agg.group_agg_materialize(
        jnp.asarray(keys), jnp.asarray(vals), 1024)
    g = int(ng)
    sums = ((np.asarray(sh[:g]).astype(np.int64) << 32)
            | np.asarray(slo[:g]).astype(np.int64))
    assert check_group_agg(keys, vals, np.asarray(gk[:g]),
                           np.asarray(gc[:g]), sums, np.asarray(mn[:g]),
                           np.asarray(mx[:g]))
    assert np.all(np.asarray(gc[g:]) == 0)


def test_group_agg_negative_values_match_numpy():
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 700, N).astype(np.int32)
    vals = rng.integers(-1_000_000, 1_000_000, N).astype(np.int32)
    gk, gc, sums, mn, mx = agg.group_by_agg(keys, vals)
    assert check_group_agg(keys, vals, gk, gc, sums, mn, mx)


def test_pushdown_compactions_agree():
    """The pushdown's two packed-sort compactions (fail bit above the id,
    and the explicit flag sort for >= 2^30 rows) keep the same rows."""
    from tpujoin.ops.multi_join import _push_sort2, _push_sort3

    rng = np.random.default_rng(17)
    hk = jnp.asarray(rng.integers(0, 1 << 30, N).astype(np.int32))
    mask = jnp.asarray(rng.random(N) < 0.4)
    pad = np.int32(0x7FFFFFFE)
    ids2, hk2 = _push_sort2(hk, mask, 4096, pad)
    ids3, hk3 = _push_sort3(hk, mask, 4096, pad)
    total = int(np.asarray(mask).sum())
    np.testing.assert_array_equal(np.asarray(ids2[:total]),
                                  np.flatnonzero(np.asarray(mask)))
    np.testing.assert_array_equal(np.sort(np.asarray(ids3[:total])),
                                  np.asarray(ids2[:total]))
    np.testing.assert_array_equal(np.asarray(hk2[total:]), pad)
    np.testing.assert_array_equal(np.asarray(ids3[total:]), -1)
