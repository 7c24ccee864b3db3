"""Semi / anti / left-outer joins + group-by aggregates vs numpy oracles."""
import numpy as np
import pytest

from tpujoin.ops.aggregate import group_by_agg
from tpujoin.ops.merge_join import anti_join, left_outer_join, semi_join


def _rand(n, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi + 1, n).astype(np.int32)


@pytest.mark.parametrize("seed,dom", [(0, 50), (1, 10**6)])
def test_semi_and_anti_partition_probe_rows(seed, dom):
    rk = _rand(500, 1, dom, seed)
    sk = _rand(700, 1, dom, seed + 9)
    semi = semi_join(rk, sk, row_pad_multiple=256)
    anti = anti_join(rk, sk, row_pad_multiple=256)
    in_build = np.isin(sk, rk)
    np.testing.assert_array_equal(np.sort(semi), np.nonzero(in_build)[0])
    np.testing.assert_array_equal(np.sort(anti), np.nonzero(~in_build)[0])
    # exact partition of the probe rows
    assert len(semi) + len(anti) == len(sk)
    assert len(np.intersect1d(semi, anti)) == 0


def test_left_outer_join_covers_all_probe_rows():
    rk = _rand(300, 1, 40, 2)
    sk = _rand(400, 1, 80, 3)   # half the domain unmatched
    r_ids, s_ids = left_outer_join(rk, sk, result_pad_multiple=1024)
    # every probe row appears at least once
    np.testing.assert_array_equal(np.unique(s_ids), np.arange(len(sk)))
    # null rows are exactly the anti rows
    nulls = s_ids[r_ids == -1]
    np.testing.assert_array_equal(np.sort(nulls), anti_join(rk, sk))
    # non-null pairs are true matches
    ok = r_ids >= 0
    np.testing.assert_array_equal(rk[r_ids[ok]], sk[s_ids[ok]])
    # inner multiplicity preserved: per probe row, #pairs = #key matches
    expected_rows = np.where(np.isin(sk, rk),
                             np.asarray([(rk == k).sum() for k in sk]), 1)
    got_rows = np.bincount(s_ids, minlength=len(sk))
    np.testing.assert_array_equal(got_rows, expected_rows)


@pytest.mark.parametrize("n,dom,seed", [(5000, 40, 0), (3000, 3000, 1)])
def test_group_by_agg_matches_numpy(n, dom, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, dom + 1, n).astype(np.int32)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    gk, gc, gs, gmin, gmax = group_by_agg(keys, vals, pad_multiple=256)
    uk = np.unique(keys)
    np.testing.assert_array_equal(gk, uk)
    for i, k in enumerate(uk):
        sel = vals[keys == k]
        assert gc[i] == len(sel)
        assert gmin[i] == sel.min()
        assert gmax[i] == sel.max()
        assert gs[i] == sel.sum()  # sums are exact int64


def test_group_by_agg_exact_at_adversarial_scale():
    """Sums far beyond f32's 2^24 integer range and beyond i32 must stay
    exact: 200k values of ~2^30
    in one group sums to ~2^47."""
    n = 200_000
    keys = np.ones(n, np.int32)
    keys[n // 2:] = 2
    vals = np.full(n, (1 << 30) + 12345, np.int32)
    vals[::7] = -((1 << 30) - 999)
    gk, gc, gs, gmin, gmax = group_by_agg(keys, vals, pad_multiple=256)
    for i, k in enumerate([1, 2]):
        sel = vals[keys == k].astype(np.int64)
        assert gk[i] == k and gc[i] == len(sel)
        assert gs[i] == sel.sum()
        assert gmin[i] == sel.min() and gmax[i] == sel.max()
