"""v2 (sort-merge) pipeline: multiset parity with oracle and v1."""
import jax.numpy as jnp
import numpy as np
import pytest

from tpujoin import oracle
import tpujoin.ops.hash_join as hj
import tpujoin.ops.merge_join as mj


def _rand(n, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi + 1, n).astype(np.int32)


@pytest.mark.parametrize("n,m,dom,seed", [
    (100, 100, 20, 0),
    (1000, 500, 1000, 1),
    (513, 1023, 7, 2),
    (2048, 2048, 10**9, 3),
    (3000, 3000, 100, 4),
])
def test_multiset_parity(n, m, dom, seed):
    rk = _rand(n, 1, dom, seed)
    sk = _rand(m, 1, dom, seed + 100)
    r_ids, s_ids = mj.merge_join(rk, sk, result_pad_multiple=256)
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


def test_matches_v1_engine():
    rk = _rand(4000, 1, 300, 5)
    sk = _rand(4000, 1, 300, 6)
    a = hj.hash_join(rk, sk, result_pad_multiple=512)
    b = mj.merge_join(rk, sk, result_pad_multiple=512)
    ka = np.lexsort((a[1], a[0]))
    kb = np.lexsort((b[1], b[0]))
    np.testing.assert_array_equal(a[0][ka], b[0][kb])
    np.testing.assert_array_equal(a[1][ka], b[1][kb])


def test_chunked_probe():
    rk = _rand(2000, 1, 150, 7)
    sk = _rand(5000, 1, 150, 8)
    r_ids, s_ids = mj.merge_join(rk, sk, probe_chunk_rows=1100,
                                 result_pad_multiple=1024)
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


def test_empty_result_and_skew():
    rk = np.arange(1, 101, dtype=np.int32)
    sk = np.arange(1001, 1101, dtype=np.int32)
    r_ids, s_ids = mj.merge_join(rk, sk)
    assert len(r_ids) == 0

    rk = np.full(64, 7, np.int32)
    sk = np.full(96, 7, np.int32)
    r_ids, s_ids = mj.merge_join(rk, sk, result_pad_multiple=8192)
    assert len(r_ids) == 64 * 96
    assert oracle.check_join(rk, sk, r_ids, s_ids, nested=True) == 1


def test_count_phase_totals():
    rk = _rand(1000, 1, 100, 10)
    sk = _rand(777, 1, 100, 11)
    ht = hj.build(jnp.asarray(rk))
    _, total, nonzero = mj.probe_count(ht, jnp.asarray(sk))
    expected = np.asarray([(rk == k).sum() for k in sk])
    assert int(total) == expected.sum()
    assert int(nonzero) == (expected > 0).sum()
