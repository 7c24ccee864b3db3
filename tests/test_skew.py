"""Skew-aware distributed join: exactness under heavy hitters + balance."""
import numpy as np
import pytest

import jax

from tpujoin import oracle
from tpujoin.core import datagen
from tpujoin.parallel.mesh import make_mesh
from tpujoin.parallel.skew import distributed_hash_join_skew, run_skew_join

needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 emulated devices")


@needs_devices
def test_uniform_keys_still_exact():
    rng = np.random.default_rng(0)
    rk = rng.integers(1, 400, 4096).astype(np.int32)
    sk = rng.integers(1, 400, 4096).astype(np.int32)
    r_ids, s_ids = distributed_hash_join_skew(
        rk, sk, mesh=make_mesh(8), expected_matches=oracle.join_count(rk, sk))
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


@needs_devices
def test_single_dominant_key_exact():
    # 40% of both sides share one key — plain hashing would put ~40% of all
    # result pairs on one device; splitting must keep exactness
    rng = np.random.default_rng(1)
    rk = rng.integers(1, 1000, 4000).astype(np.int32)
    sk = rng.integers(1, 1000, 4000).astype(np.int32)
    rk[:1600] = 77
    sk[:1600] = 77
    r_ids, s_ids = distributed_hash_join_skew(
        rk, sk, mesh=make_mesh(8), expected_matches=oracle.join_count(rk, sk))
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


@needs_devices
def test_zipf_join_exact():
    import jax.numpy as jnp
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    rk = np.asarray(datagen.zipf_keys(k1, 8192, 1, 2000, s=1.0))
    sk = np.asarray(datagen.zipf_keys(k2, 8192, 1, 2000, s=1.0))
    r_ids, s_ids = distributed_hash_join_skew(
        rk, sk, mesh=make_mesh(8), expected_matches=oracle.join_count(rk, sk))
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


@needs_devices
def test_heavy_on_one_side_only():
    # key heavy in R but light in S: S side replicated, R sprayed
    rng = np.random.default_rng(2)
    rk = rng.integers(1, 500, 4000).astype(np.int32)
    rk[:2000] = 99
    sk = rng.integers(1, 500, 4000).astype(np.int32)  # ~8 rows of key 99
    r_ids, s_ids = distributed_hash_join_skew(
        rk, sk, mesh=make_mesh(8), expected_matches=oracle.join_count(rk, sk))
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


@needs_devices
def test_skew_balances_send_buffers():
    """With one dominant key, the skew-aware path should converge with
    strictly smaller per-peer send capacity than plain hashing needs."""
    from tpujoin.parallel.shuffle_join import distributed_hash_join
    rng = np.random.default_rng(3)
    rk = rng.integers(1, 1000, 8000).astype(np.int32)
    sk = rng.integers(1, 1000, 8000).astype(np.int32)
    sk[:4000] = 55  # half the probe side is one key
    exp = oracle.join_count(rk, sk)
    # plain hashing must grow a send buffer to >= 4000/8 on one peer (all
    # key-55 rows target one device); the skew path sprays them.
    r_ids, s_ids = distributed_hash_join_skew(
        rk, sk, mesh=make_mesh(8), slack=1.5, expected_matches=exp)
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1
    r2, s2 = distributed_hash_join(rk, sk, mesh=make_mesh(8),
                                   expected_matches=exp)
    assert oracle.check_join(rk, sk, r2, s2) == 1


@needs_devices
@pytest.mark.parametrize("heavy", [False, True])
def test_replica_telemetry(heavy):
    """The replica counts in the telemetry say whether splitting fired: a
    key on more build rows than one device's share makes the probe's rows
    of that key replicas; uniform keys replicate nothing."""
    rng = np.random.default_rng(4)
    rk = rng.integers(1, 1000, 4000).astype(np.int32)
    sk = rng.integers(1, 1000, 4000).astype(np.int32)
    if heavy:
        rk[::3][:600] = 999
        sk[[5, 1005, 2005]] = 999
    _, _, totals, ovf = run_skew_join(rk, sk, mesh=make_mesh(8),
                                      expected_matches=oracle.join_count(rk, sk))
    assert int(np.asarray(totals).sum()) == oracle.join_count(rk, sk)
    replicas = int(ovf[3]) + int(ovf[4])
    assert (replicas > 0) == heavy
    if heavy:
        assert ovf[4] > 0   # the probe side is the lighter one: replicated
