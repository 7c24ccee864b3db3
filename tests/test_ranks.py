"""ops.hash_join.ranks — the count phase's rank lookup for every join
path (v1, v2, the shuffle join, skew detection) — against numpy's
searchsorted."""
import jax.numpy as jnp
import numpy as np
import pytest

from tpujoin.ops.hash_join import ranks


def _ref(build_sorted, queries):
    lo = np.searchsorted(build_sorted, queries, side="left")
    hi = np.searchsorted(build_sorted, queries, side="right")
    return lo.astype(np.int32), (hi - lo).astype(np.int32)


@pytest.mark.parametrize("n,m,dom,seed", [
    (5000, 3000, 400, 0),     # heavy duplication
    (2048, 2048, 10**9, 1),   # sparse matches
    (100, 4096, 50, 2),       # tiny build, many probes per key
    (4096, 100, 10, 3),       # tiny probe
    (1024, 1024, 1, 4),       # all keys equal: one giant duplicate run
])
def test_matches_reference(n, m, dom, seed):
    rng = np.random.default_rng(seed)
    b = np.sort(rng.integers(1, dom + 1, n).astype(np.int32))
    p = np.sort(rng.integers(1, dom + 1, m).astype(np.int32))
    lo, cnt = ranks(jnp.asarray(b), jnp.asarray(p))
    exp_lo, exp_cnt = _ref(b, p)
    np.testing.assert_array_equal(np.asarray(cnt), exp_cnt)
    np.testing.assert_array_equal(np.asarray(lo), exp_lo)
    # where matched, the full run [lo, lo+cnt) equals the probe key
    for j in np.nonzero(exp_cnt)[0][:50]:
        seg = b[int(lo[j]): int(lo[j]) + int(cnt[j])]
        assert (seg == p[j]).all()


def test_unsorted_queries():
    # the v1 count phase ranks the probe keys in their original order
    rng = np.random.default_rng(5)
    b = np.sort(rng.integers(1, 300, 3000).astype(np.int32))
    p = rng.integers(1, 400, 2500).astype(np.int32)
    lo, cnt = ranks(jnp.asarray(b), jnp.asarray(p))
    exp_lo, exp_cnt = _ref(b, p)
    np.testing.assert_array_equal(np.asarray(lo), exp_lo)
    np.testing.assert_array_equal(np.asarray(cnt), exp_cnt)


def test_empty_probe_and_build():
    b = jnp.asarray(np.sort(np.random.default_rng(0).integers(1, 100, 256)
                            .astype(np.int32)))
    lo, cnt = ranks(b, jnp.asarray(np.empty(0, np.int32)))
    assert lo.shape == (0,) and cnt.shape == (0,)

    lo, cnt = ranks(jnp.asarray(np.empty(0, np.int32)),
                    jnp.asarray(np.arange(1, 100, dtype=np.int32)))
    assert int(jnp.sum(cnt)) == 0


def test_pad_keys_never_match_each_other():
    # build pads are 0x7FFFFFFF and probe pads 0x7FFFFFFE: they sort last
    # and match nothing on the other side
    b = np.sort(np.r_[np.arange(1, 50), np.full(30, 0x7FFFFFFF)]
                ).astype(np.int32)
    p = np.sort(np.r_[np.arange(25, 75), np.full(40, 0x7FFFFFFE)]
                ).astype(np.int32)
    lo, cnt = ranks(jnp.asarray(b), jnp.asarray(p))
    exp_lo, exp_cnt = _ref(b, p)
    np.testing.assert_array_equal(np.asarray(cnt), exp_cnt)
    np.testing.assert_array_equal(np.asarray(lo), exp_lo)
    assert int(np.asarray(cnt)[p == 0x7FFFFFFE].sum()) == 0
