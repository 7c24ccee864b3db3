"""Distributed shuffle join on an emulated 8-device CPU mesh — multiset
parity with the single-chip engine and the native oracle (SURVEY.md §4's
required multi-device tests; the reference has no distribution at all)."""
import numpy as np
import pytest

import jax

from tpujoin import oracle
from tpujoin.parallel.mesh import make_mesh
from tpujoin.parallel.shuffle_join import (
    distributed_anti_join,
    distributed_hash_join,
    distributed_hash_join_rle,
    distributed_semi_join,
)


needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 emulated devices")


def _rand(n, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi + 1, n).astype(np.int32)


@needs_devices
@pytest.mark.parametrize("n,m,dom,seed", [
    (4096, 4096, 500, 0),
    (1000, 3000, 100, 1),
    (4097, 999, 50, 2),     # sizes not divisible by mesh
])
def test_distributed_matches_oracle(n, m, dom, seed):
    rk = _rand(n, 1, dom, seed)
    sk = _rand(m, 1, dom, seed + 7)
    mesh = make_mesh(8)
    r_ids, s_ids = distributed_hash_join(
        rk, sk, mesh=mesh, expected_matches=oracle.join_count(rk, sk))
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


@needs_devices
def test_distributed_empty_result():
    rk = np.arange(1, 1001, dtype=np.int32)
    sk = np.arange(100_000, 101_000, dtype=np.int32)
    mesh = make_mesh(8)
    r_ids, s_ids = distributed_hash_join(rk, sk, mesh=mesh, expected_matches=0)
    assert len(r_ids) == 0
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


@needs_devices
def test_distributed_skewed_keys_overflow_retry():
    # Zipf-like worst case: one heavy key owning ~30% of rows blows the
    # uniform send-buffer estimate; the driver's detect-and-retry loop must
    # still converge to the exact result.
    rng = np.random.default_rng(3)
    rk = rng.integers(1, 200, 4000).astype(np.int32)
    rk[:1200] = 42
    sk = rng.integers(1, 200, 4000).astype(np.int32)
    sk[:1200] = 42
    mesh = make_mesh(8)
    r_ids, s_ids = distributed_hash_join(
        rk, sk, mesh=mesh, slack=1.1,
        expected_matches=oracle.join_count(rk, sk))
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


@needs_devices
def test_mesh_subset():
    rk = _rand(512, 1, 64, 4)
    sk = _rand(512, 1, 64, 5)
    mesh = make_mesh(4)
    r_ids, s_ids = distributed_hash_join(
        rk, sk, mesh=mesh, expected_matches=oracle.join_count(rk, sk))
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


@needs_devices
@pytest.mark.parametrize("chunks", [2, 4])
def test_pipelined_exchange_matches_oracle(chunks):
    """Pipelined (overlapped-exchange) variant: same exact multiset."""
    rk = _rand(4096, 1, 300, 11)
    sk = _rand(4096, 1, 300, 12)
    mesh = make_mesh(8)
    r_ids, s_ids = distributed_hash_join(
        rk, sk, mesh=mesh, expected_matches=oracle.join_count(rk, sk),
        pipeline_chunks=chunks)
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


@needs_devices
def test_pipelined_ragged_sizes():
    rk = _rand(3001, 1, 100, 13)
    sk = _rand(5003, 1, 100, 14)
    mesh = make_mesh(8)
    r_ids, s_ids = distributed_hash_join(
        rk, sk, mesh=mesh, expected_matches=oracle.join_count(rk, sk),
        pipeline_chunks=2)
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1

@needs_devices
def test_distributed_rle_matches_oracle():
    """Factorized (RLE) distributed result: expanding every device's runs
    must reproduce the exact pair multiset, and the split pair counters
    must reassemble to the true total."""
    rk = _rand(4096, 1, 200, 21)
    sk = _rand(4096, 1, 200, 22)
    mesh = make_mesh(8)
    shards, total = distributed_hash_join_rle(rk, sk, mesh=mesh)
    assert total == oracle.join_count(rk, sk)
    out_r, out_s = [], []
    for sh in shards:
        keep = sh["cnt"] > 0
        sid, lo, cnt = (sh["probe_ids"][keep], sh["lo"][keep],
                        sh["cnt"][keep])
        src = sh["build_ids"]
        j = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        out_r.append(src[np.repeat(lo, cnt) + j])
        out_s.append(np.repeat(sid, cnt))
    r_ids = np.concatenate(out_r) if out_r else np.empty(0, np.int32)
    s_ids = np.concatenate(out_s) if out_s else np.empty(0, np.int32)
    assert len(r_ids) == total
    assert oracle.check_join(rk, sk, r_ids.astype(np.int32),
                             s_ids.astype(np.int32)) == 1


@needs_devices
def test_distributed_rle_high_duplication():
    """High-duplication shard: pairs >> rows; the RLE form carries it with
    no result capacity at all."""
    rng = np.random.default_rng(23)
    rk = rng.integers(1, 9, 4096).astype(np.int32)
    sk = rng.integers(1, 9, 4096).astype(np.int32)
    mesh = make_mesh(8)
    shards, total = distributed_hash_join_rle(rk, sk, mesh=mesh)
    assert total == oracle.join_count(rk, sk)  # ~2M pairs from 4k rows


@needs_devices
def test_distributed_semi_anti_match_single_chip():
    from tpujoin.ops.merge_join import anti_join, semi_join

    rk = _rand(2048, 1, 400, 31)
    sk = _rand(3001, 1, 600, 32)   # some probe keys unmatched
    mesh = make_mesh(8)
    semi_d = distributed_semi_join(rk, sk, mesh=mesh)
    anti_d = distributed_anti_join(rk, sk, mesh=mesh)
    np.testing.assert_array_equal(semi_d, semi_join(rk, sk))
    np.testing.assert_array_equal(anti_d, anti_join(rk, sk))
    assert len(semi_d) + len(anti_d) == len(sk)


@pytest.mark.parametrize("n,m,dom,parts", [
    (3000, 2000, 500, 8),
    (5000, 7000, 20, 64),      # heavy duplication
    (100, 100, 10**9, 1),      # almost no matches
    (50, 60, 5, 256),          # more classes than keys
])
def test_host_join_expectation_matches_oracle_pairs(n, m, dom, parts):
    """The NumPy expectation behind the shuffle join's full-coverage
    checks, against the oracle's explicit pair list."""
    from tpujoin.utils.verify import (expected_multiset_sum_pairs,
                                      host_join_expectation)

    rk = _rand(n, -dom, dom, n)
    sk = _rand(m, -dom, dom, m)
    pairs = oracle._numpy_join_pairs(rk, sk)
    expected = (len(pairs),
                expected_multiset_sum_pairs(pairs[:, 0], pairs[:, 1]))
    assert host_join_expectation(rk, sk, parts=parts) == expected


@pytest.mark.parametrize("rows", [0, 1, 200, 65_536, 10**8 + 7])
def test_send_capacity_granule(rows):
    """Measured send segments get 64 rows of headroom and a granule of at
    most ~1.6% of the size, so similar runs share one executable."""
    from tpujoin.parallel.shuffle_join import _coarse_cap

    cap = _coarse_cap(rows)
    assert cap >= rows + 64
    assert cap % 256 == 0
    assert cap <= max(rows + 64 + 256, (rows + 64) * 1.016 + 1)
    assert _coarse_cap(rows + 1) >= cap
