"""The (key, row id) sorts that replaced the hand-written merge sort: the
build sort (ops.hash_join.build) and the v2 probe sort inside
ops.merge_join.probe_count, checked against numpy's sort plus the
(key, id) consistency invariants across adversarial key distributions
(the reference verifies every workload it times — shared.cpp:167-171)."""
import jax.numpy as jnp
import numpy as np
import pytest

from tpujoin.ops import merge_join as mj
from tpujoin.ops.hash_join import build

N = 1 << 13


def _keys(dist: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    if dist == "uniform":
        return rng.integers(0, 1 << 30, n).astype(np.int32)
    if dist == "dup8":
        return rng.integers(0, 8, n).astype(np.int32)
    if dist == "all_equal":
        return np.full(n, 42, np.int32)
    if dist == "sorted":
        return np.arange(n, dtype=np.int32)
    if dist == "reversed":
        return np.arange(n, dtype=np.int32)[::-1].copy()
    if dist == "sawtooth":
        return np.arange(n, dtype=np.int32) % 37
    if dist == "negative":
        return rng.integers(-1000, 1000, n).astype(np.int32)
    if dist == "pad_keys":
        # the engine's reserved pad values still sort like any key
        k = rng.integers(1, 100, n).astype(np.int32)
        k[::5] = 0x7FFFFFFE
        k[::7] = 0x7FFFFFFF
        return k
    raise ValueError(dist)


def _check_sorted_pairs(keys, sk, sid):
    sk, sid = np.asarray(sk), np.asarray(sid)
    np.testing.assert_array_equal(sk, np.sort(keys))
    np.testing.assert_array_equal(keys[sid], sk)
    assert len(np.unique(sid)) == keys.shape[0]


@pytest.mark.parametrize("dist", ["uniform", "dup8", "all_equal", "sorted",
                                  "reversed", "sawtooth"])
@pytest.mark.parametrize("n", [N, 5000])
def test_build_sort_distributions(dist, n):
    keys = _keys(dist, n)
    ht = build(jnp.asarray(keys))
    _check_sorted_pairs(keys, ht.sorted_keys, ht.sorted_ids)


@pytest.mark.parametrize("dist", ["negative", "pad_keys"])
def test_build_sort_edge_keys(dist):
    keys = _keys(dist, 3 * 1024 + 17)
    ht = build(jnp.asarray(keys))
    _check_sorted_pairs(keys, ht.sorted_keys, ht.sorted_ids)


def test_probe_sort_inside_count_phase():
    # the v2 count phase sorts the probe side once; its state must be the
    # probe ids in key order, each with its own key's build range
    rng = np.random.default_rng(13)
    bk = rng.integers(0, 500, 4096).astype(np.int32)
    pk = rng.integers(0, 500, 13 * 1024 + 5).astype(np.int32)
    ht = build(jnp.asarray(bk))
    state, _, _ = mj.probe_count(ht, jnp.asarray(pk))
    pid = np.asarray(state.probe_ids)
    np.testing.assert_array_equal(pk[pid], np.sort(pk))
    assert len(np.unique(pid)) == len(pk)
