"""Run expansion (ops.hash_join.expand) — the one materialize step shared
by v1, v2 and the shuffle join — against a numpy expansion oracle, plus
the materialize drivers built on it. Pairs are compared as the reference
does, as a multiset of rowIDs (reference shared_stuff/shared.cpp:167-171).

A case is a run list: run i covers ``counts[i]`` output slots, its build
side is ``src[lo[i] + j]`` and its probe side ``sid[i]``. Rows with zero
counts own no slot (the v2 path expands its uncompacted count state)."""
import jax.numpy as jnp
import numpy as np
import pytest

from tpujoin import oracle
from tpujoin.ops import hash_join as hj
from tpujoin.ops import merge_join as mj
from tpujoin.ops.hash_join import build, expand
from tpujoin.utils.shapes import round_up


def numpy_expand(lo, counts, sid, src, capacity):
    r = np.full(capacity, -1, np.int64)
    s = np.full(capacity, -1, np.int64)
    t = 0
    for l, c, p in zip(lo, counts, sid):
        for j in range(c):
            if t < capacity:
                r[t] = src[l + j]
                s[t] = p
            t += 1
    return r, s


def run_case(counts, lo, sid, src, capacity=None):
    counts = np.asarray(counts, np.int32)
    lo = np.asarray(lo, np.int32)
    sid = np.asarray(sid, np.int32)
    src = np.asarray(src, np.int32)
    total = int(counts.sum())
    capacity = total if capacity is None else capacity
    row, bpos, tot = expand(jnp.asarray(lo), jnp.asarray(counts), capacity)
    assert int(tot) == total
    valid = np.arange(capacity) < total
    row, bpos = np.asarray(row), np.asarray(bpos)
    r = np.where(valid, src[np.clip(bpos, 0, len(src) - 1)], -1)
    s = np.where(valid, sid[row] if len(sid) else 0, -1)
    er, es = numpy_expand(lo, counts, sid, src, capacity)
    np.testing.assert_array_equal(r, er)
    np.testing.assert_array_equal(s, es)


CASES = {
    "single_run": ([5], [2], [7], np.arange(100) * 3),
    "adjacent_runs": ([3, 4, 1], [0, 3, 7], [9, 1, 4], np.arange(64) + 100),
    # probe rows with one key reuse one build range
    "duplicate_probe_keys": ([4, 4, 4, 2], [10, 10, 10, 20], [5, 6, 7, 8],
                             np.arange(64) * 11),
    "run_spanning_many_slots": ([20000], [1], [3], np.arange(30000)),
    "one_group_many_runs": ([4] * 6, [10] * 6, [5, 9, 2, 7, 1, 3],
                            np.arange(64) * 11),
    "adjacent_groups": ([3, 3, 4, 1, 1], [0, 0, 3, 7, 7], [9, 1, 4, 2, 8],
                        np.arange(64) + 100),
    # period 700: not a power of two, crossing 1024-slot boundaries
    "period_crossing_boundaries": ([700] * 9, [100] * 9, list(range(9)),
                                   np.arange(4000)),
    "giant_group": ([3500] * 6, [1] * 6, list(range(6)), np.arange(8000)),
    "long_run_in_small_groups": ([5000, 5000, 17], [0, 0, 6000], [3, 1, 2],
                                 np.arange(8000)),
    "group_block_spanning": ([1500] * 5, [1] * 5, list(range(5)),
                             np.arange(4000)),
    "big_period": ([2048] * 3, [7] * 3, [2, 0, 1], np.arange(2560)),
    "period_above_2048": ([2052] * 2, [0] * 2, [0, 1], np.arange(2560)),
    "dense_single_slot_runs": ([1] * 600, [3] * 600,
                               np.random.default_rng(0).permutation(600),
                               np.arange(16)),
    "zero_count_rows_interleaved": ([0, 3, 0, 0, 2, 0, 5, 0],
                                    [0, 0, 3, 3, 3, 5, 5, 10],
                                    [10, 11, 12, 13, 14, 15, 16, 17],
                                    np.arange(32) * 2),
    "first_and_last_rows_empty": ([0, 0, 4, 1, 0], [0, 0, 2, 6, 7],
                                  [4, 3, 2, 1, 0], np.arange(16)),
    "single_slot": ([1], [9], [4], np.arange(16)),
    "alternating_zero": ([1, 0] * 300, np.arange(600) // 2,
                         np.arange(600), np.arange(400)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fixed_cases(name):
    counts, lo, sid, src = CASES[name]
    run_case(counts, lo, sid, src)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_runs(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 200))
    counts = rng.integers(1, 50, size=k).astype(np.int32)
    gaps = rng.integers(0, 5, size=k)
    lo = (np.cumsum(counts + gaps) - (counts + gaps)).astype(np.int32)
    sid = rng.permutation(k).astype(np.int32)
    src = rng.integers(0, 1 << 30, size=int(lo[-1] + counts[-1] + 8),
                       dtype=np.int32)
    run_case(counts, lo, sid, src)


@pytest.mark.parametrize("seed", range(8))
def test_randomized_groups(seed):
    """Groups of probe rows sharing one build range (the sorted-probe
    shape of duplicated keys on both sides)."""
    rng = np.random.default_rng(seed)
    g = int(rng.integers(1, 12))
    gnb = rng.integers(1, 200, size=g).astype(np.int32)
    gnp = rng.integers(1, 25, size=g).astype(np.int32)
    gaps = rng.integers(0, 5, size=g)
    glo = (np.cumsum(gnb + gaps) - (gnb + gaps)).astype(np.int32)
    counts = np.repeat(gnb, gnp)
    lo = np.repeat(glo, gnp)
    sid = rng.permutation(len(counts)).astype(np.int32)
    src = rng.integers(0, 1 << 30, size=int(glo[-1] + gnb[-1] + 8),
                       dtype=np.int32)
    run_case(counts, lo, sid, src)


@pytest.mark.parametrize("k,max_count,seed", [
    (1000, 1, 0),      # all singleton matches
    (300, 20, 1),      # mixed run lengths
    (1, 5000, 2),      # one giant run (skew)
    (2000, 3, 3),
])
def test_sorted_lo_runs(k, max_count, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max_count + 1, k).astype(np.int32)
    lo = np.sort(rng.integers(0, 10**6, k)).astype(np.int32)
    sid = rng.permutation(k).astype(np.int32)
    run_case(counts, lo, sid, np.arange(10**6 + max_count))


@pytest.mark.parametrize("extra", [1, 7, 333, 4096])
def test_capacity_padding_is_maskable(extra):
    # slots past the total are left for the caller to mask
    rng = np.random.default_rng(extra)
    counts = rng.integers(0, 4, 100).astype(np.int32)
    lo = np.sort(rng.integers(0, 1000, 100)).astype(np.int32)
    run_case(counts, lo, np.arange(100), np.arange(1100),
             capacity=int(counts.sum()) + extra)


@pytest.mark.parametrize("m,capacity", [(4, 8), (0, 8), (4, 0)])
def test_empty_result(m, capacity):
    row, bpos, total = expand(jnp.zeros(m, jnp.int32),
                              jnp.zeros(m, jnp.int32), capacity)
    assert int(total) == 0
    assert row.shape == (capacity,) and bpos.shape == (capacity,)


def _join_state(bk, pk):
    ht = build(jnp.asarray(bk))
    state, total, nonzero = mj.probe_count(ht, jnp.asarray(pk))
    return ht, state, int(total), int(nonzero)


@pytest.mark.parametrize("engine", ["v1", "v2", "device"])
def test_undersized_capacity_reports_no_fit(engine):
    """A capacity below the total must come back with fits=False — the
    output would be a truncated multiset — never as a silent success."""
    rng = np.random.default_rng(3)
    bk = rng.integers(1, 20, 512).astype(np.int32)
    pk = rng.integers(1, 20, 512).astype(np.int32)
    total = oracle.join_count(bk, pk)
    cap = total // 2
    if engine == "v1":
        ht = build(jnp.asarray(bk))
        lo, counts = hj.probe_count(ht, jnp.asarray(pk))
        *_, tot, fits = hj.probe_materialize(ht, lo, counts, cap)
    elif engine == "v2":
        ht, state, _, _ = _join_state(bk, pk)
        *_, tot, fits = mj.probe_materialize(ht, state, cap)
    else:
        *_, tot, fits = hj.hash_join_device(jnp.asarray(bk),
                                            jnp.asarray(pk), capacity=cap)
    assert int(tot) == total
    assert not bool(fits)


@pytest.mark.parametrize("dup,n_keys", [(8, 40), (64, 40), (16, 12),
                                        (32, 12), (16, 200), (32, 3)])
def test_v2_materialize_matches_v1(dup, n_keys):
    """v2 (expansion over sorted-probe state) equals v1 (expansion in
    probe order) as a multiset on duplicated keys on both sides."""
    rng = np.random.default_rng(42 + dup)
    bk = rng.integers(1, n_keys, size=1200, dtype=np.int32)
    pk = np.repeat(rng.integers(1, n_keys, size=16, dtype=np.int32), dup)
    rng.shuffle(pk)
    ht, state, total, _ = _join_state(bk, pk)
    cap = round_up(total, 1 << 10)
    r2, s2, t2, fits = mj.probe_materialize(ht, state, cap)
    assert bool(fits) and int(t2) == total
    lo, counts = hj.probe_count(ht, jnp.asarray(pk))
    r1, s1, t1, _ = hj.probe_materialize(ht, lo, counts, cap)
    assert int(t1) == total
    ref = sorted(zip(np.asarray(r1[:total]).tolist(),
                     np.asarray(s1[:total]).tolist()))
    got = sorted(zip(np.asarray(r2[:total]).tolist(),
                     np.asarray(s2[:total]).tolist()))
    assert ref == got
    assert oracle.check_join(bk, pk, np.asarray(r2[:total]),
                             np.asarray(s2[:total])) == 1


@pytest.mark.parametrize("engine", ["v1", "v2"])
def test_probe_base_offsets_sids(engine):
    rng = np.random.default_rng(5)
    bk = rng.integers(1, 8, size=1024, dtype=np.int32)
    pk = rng.integers(1, 8, size=256, dtype=np.int32)
    ht, state, total, _ = _join_state(bk, pk)
    if engine == "v1":
        lo, counts = hj.probe_count(ht, jnp.asarray(pk))
        _, s0, _, f0 = hj.probe_materialize(ht, lo, counts, 1 << 16)
        _, s1, _, f1 = hj.probe_materialize(ht, lo, counts, 1 << 16,
                                            probe_base=100)
    else:
        _, s0, _, f0 = mj.probe_materialize(ht, state, 1 << 16)
        _, s1, _, f1 = mj.probe_materialize(ht, state, 1 << 16,
                                            probe_base=100)
    assert bool(f0) and bool(f1)
    np.testing.assert_array_equal(np.asarray(s1[:total]),
                                  np.asarray(s0[:total]) + 100)
    np.testing.assert_array_equal(np.asarray(s1[total:]), -1)


def test_all_matched_rle_fast_path():
    """When every probe row matches, all_matched=True makes the RLE
    compaction the identity and must give the same rows."""
    rng = np.random.default_rng(9)
    bk = rng.integers(1, 8, size=1024, dtype=np.int32)
    pk = rng.integers(1, 8, size=256, dtype=np.int32)  # domain covered
    ht, state, _, nonzero = _join_state(bk, pk)
    assert nonzero == 256
    a = mj.probe_rle(ht, state, 1 << 10)
    b = mj.probe_rle(ht, state, 1 << 10, all_matched=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x)[:nonzero],
                                      np.asarray(y)[:nonzero])


def test_merge_join_driver_high_duplication():
    rng = np.random.default_rng(7)
    bk = rng.integers(1, 20, size=300, dtype=np.int32)
    pk = rng.integers(1, 20, size=256, dtype=np.int32)
    r, s = mj.merge_join(bk, pk, result_pad_multiple=1 << 12)
    exp = sorted((int(b), int(p)) for p, pkv in enumerate(pk)
                 for b, bkv in enumerate(bk) if bkv == pkv)
    got = sorted(zip(r.tolist(), s.tolist()))
    assert got == exp
