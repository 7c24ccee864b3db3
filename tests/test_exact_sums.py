"""Exact wide sums: the int64 pair total of the count phase
(merge_join.exact_sum_i32) and the int64 prefix sums inside
group_agg_materialize. Exactness must hold at extreme i32 values and
at sizes that overflow any 32-bit accumulator."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from tpujoin.ops.aggregate import group_by_agg
from tpujoin.ops.merge_join import exact_sum_i32


@pytest.mark.parametrize("m", [0, 1, 7, 4095, 4096, 4097, 12_288 + 5])
def test_exact_sum_sizes(m):
    rng = np.random.default_rng(m)
    x = rng.integers(0, 2**31 - 1, size=m, dtype=np.int64).astype(np.int32)
    got = int(exact_sum_i32(jnp.asarray(x)))
    assert got == int(x.astype(np.int64).sum())


def test_exact_sum_extreme_counts():
    # every element at INT32_MAX: the classic overflow trap for partial
    # sums — 8192 of them exceed 2^44
    x = np.full(8192 + 100, 2**31 - 1, np.int32)
    got = int(exact_sum_i32(jnp.asarray(x)))
    assert got == (2**31 - 1) * len(x)


def test_group_agg_negative_values_exact():
    # the hi16/lo16 split must stay exact for NEGATIVE values (arithmetic
    # shift identity) and for sums crossing +/- 2^31
    rng = np.random.default_rng(5)
    n = 20_000
    keys = rng.integers(1, 50, n).astype(np.int32)
    vals = rng.integers(-(2**31) + 1, 2**31 - 1, n,
                        dtype=np.int64).astype(np.int32)
    gk, gc, sums, gmin, gmax = group_by_agg(keys, vals)
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], vals[order].astype(np.int64)
    bnd = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    ends = np.r_[bnd[1:], n]
    cs = np.r_[0, np.cumsum(vs)]
    np.testing.assert_array_equal(gk, ks[bnd])
    np.testing.assert_array_equal(gc, ends - bnd)
    np.testing.assert_array_equal(sums, cs[ends] - cs[bnd])
    np.testing.assert_array_equal(gmin.astype(np.int64),
                                  np.minimum.reduceat(vs, bnd))
    np.testing.assert_array_equal(gmax.astype(np.int64),
                                  np.maximum.reduceat(vs, bnd))

