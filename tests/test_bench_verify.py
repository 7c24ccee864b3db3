"""Full-coverage materialization checksums (bench._window_checksums /
bench._expected_checksums): the round-3 verification gate that covers every
materialized pair (the reference checks every pair of every run,
shared.cpp:154-171). Tests: device and host reductions agree on a real
join, and a single corrupted slot anywhere flips its window's checksum."""
import numpy as np
import pytest

import jax.numpy as jnp

import bench
from tpujoin.ops import merge_join as mj
from tpujoin.ops.hash_join import build
from tpujoin.utils.shapes import round_up


def _join_state(n, m, dom, seed):
    rng = np.random.default_rng(seed)
    bk = jnp.asarray(rng.integers(1, dom, n).astype(np.int32))
    pk = jnp.asarray(rng.integers(1, dom, m).astype(np.int32))
    ht = build(bk)
    state, total_a, nonzero_a = mj.probe_count(ht, pk)
    total, nonzero = int(total_a), int(nonzero_a)
    k_cap = round_up(nonzero, 1024)
    cap = round_up(total, bench._VERIFY_WINDOW)
    r_ids, s_ids, total_dev, fits = mj.probe_materialize(ht, state, cap)
    assert bool(fits)
    sid, lo, cnt = mj.probe_rle(ht, state, k_cap)
    return (ht, np.asarray(sid[:nonzero]), np.asarray(lo[:nonzero]),
            np.asarray(cnt[:nonzero]), r_ids, s_ids, total_dev, total, cap)


@pytest.mark.parametrize("n,m,dom,seed", [
    (4096, 4096, 64, 0),      # high duplication
    (4096, 4096, 100_000, 1),  # sparse matches
])
def test_checksums_match_rle_expansion(n, m, dom, seed):
    (ht, sid, lo, cnt, r_ids, s_ids, total_dev, total,
     cap) = _join_state(n, m, dom, seed)
    nw = cap // bench._VERIFY_WINDOW
    got_hi, got_lo = bench._window_checksums(r_ids, s_ids,
                                             jnp.asarray(total_dev), nw)
    exp_hi, exp_lo, _ = bench._expected_checksums(
        np.asarray(ht.sorted_ids), sid, lo, cnt, total, nw)
    np.testing.assert_array_equal(np.asarray(got_hi), exp_hi)
    np.testing.assert_array_equal(np.asarray(got_lo), exp_lo)


def test_checksum_detects_single_slot_corruption():
    (ht, sid, lo, cnt, r_ids, s_ids, total_dev, total,
     cap) = _join_state(2048, 2048, 32, 2)
    assert total > 10
    nw = cap // bench._VERIFY_WINDOW
    exp_hi, exp_lo, _ = bench._expected_checksums(
        np.asarray(ht.sorted_ids), sid, lo, cnt, total, nw)
    rng = np.random.default_rng(0)
    for slot in [0, int(total) // 2, int(total) - 1,
                 int(rng.integers(0, total))]:
        bad_r = np.asarray(r_ids).copy()
        bad_r[slot] ^= 1
        got_hi, got_lo = bench._window_checksums(
            jnp.asarray(bad_r), s_ids, jnp.asarray(total_dev), nw)
        assert (not np.array_equal(np.asarray(got_hi), exp_hi)
                or not np.array_equal(np.asarray(got_lo), exp_lo)), slot


def test_checksum_ignores_pad_slots():
    """Slots >= total must not contribute: corrupting the pad region
    leaves every checksum unchanged."""
    (ht, sid, lo, cnt, r_ids, s_ids, total_dev, total,
     cap) = _join_state(2048, 2048, 50, 3)
    assert total < cap
    nw = cap // bench._VERIFY_WINDOW
    ref_hi, ref_lo = bench._window_checksums(r_ids, s_ids,
                                             jnp.asarray(total_dev), nw)
    bad_r = np.asarray(r_ids).copy()
    bad_r[total:] = 12345
    got_hi, got_lo = bench._window_checksums(
        jnp.asarray(bad_r), s_ids, jnp.asarray(total_dev), nw)
    np.testing.assert_array_equal(np.asarray(got_hi), np.asarray(ref_hi))
    np.testing.assert_array_equal(np.asarray(got_lo), np.asarray(ref_lo))

def test_multiset_checksum_order_invariant_and_sensitive():
    """The order-invariant multiset checksum must equal the RLE-derived
    expectation under ANY permutation of the pair slots (v1 emits pairs in
    unsorted-probe order) and still catch a duplicated-pair substitution
    (which xor-folding would miss)."""
    (ht, sid, lo, cnt, r_ids, s_ids, total_dev, total,
     cap) = _join_state(2048, 2048, 32, 4)
    nw = cap // bench._VERIFY_WINDOW
    _, _, msum = bench._expected_checksums(
        np.asarray(ht.sorted_ids), sid, lo, cnt, total, nw)
    rng = np.random.default_rng(5)
    perm = rng.permutation(total)
    r_p = np.asarray(r_ids).copy()
    s_p = np.asarray(s_ids).copy()
    r_p[:total], s_p[:total] = r_p[perm], s_p[perm]
    hi, lo32 = bench._multiset_checksum(jnp.asarray(r_p), jnp.asarray(s_p),
                                        jnp.asarray(total_dev), nw)
    got = (int(hi) << 32) | int(lo32)
    assert got == msum
    # duplicate slot 0's pair over slot 1 — a multiset change xor cancels
    r_p[1], s_p[1] = r_p[0], s_p[0]
    hi2, lo2 = bench._multiset_checksum(jnp.asarray(r_p), jnp.asarray(s_p),
                                        jnp.asarray(total_dev), nw)
    assert ((int(hi2) << 32) | int(lo2)) != msum
