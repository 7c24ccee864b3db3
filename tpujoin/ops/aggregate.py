"""Hash aggregate: group-by-count over an i32 key column.

One of the extension operators BASELINE.json requires ("hash aggregate
(group-by count), 100M rows"); the reference names aggregation as future
work (reference projectDescription.md:20-32).

Design: no hash table at all — sort the keys (the same primitive that
backs the join build), mark run boundaries, and compact boundary positions.
Group counts are adjacent-boundary differences. Entirely vectorized:
one sort and one packed-sort compaction of the boundaries; skew (a heavy
key) costs nothing because a run's length never enters a loop bound.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpujoin.ops.filter import filter_materialize
from tpujoin.utils.shapes import round_up


@jax.jit
def group_count(keys: jax.Array) -> jax.Array:
    """Count phase: number of distinct keys."""
    sk = jax.lax.sort(keys, is_stable=False)
    is_boundary = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sk[1:] != sk[:-1]]
    )
    return jnp.sum(is_boundary.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("capacity",))
def group_materialize(keys: jax.Array, capacity: int):
    """Materialize phase: (unique_keys, counts, num_groups), padded to
    capacity (pad keys = -1, pad counts = 0)."""
    n = keys.shape[0]
    sk = jax.lax.sort(keys, is_stable=False)
    is_boundary = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sk[1:] != sk[:-1]]
    )
    starts, num_groups = filter_materialize(is_boundary, capacity)
    valid = starts >= 0
    safe_starts = jnp.where(valid, starts, 0)
    group_keys = jnp.where(valid, jnp.take(sk, safe_starts), -1)
    # count of group g = start of group g+1 (or n for the last group) - start
    next_start = jnp.concatenate(
        [starts[1:], jnp.full((1,), -1, jnp.int32)]
    )
    is_last = jnp.arange(capacity, dtype=jnp.int32) == (num_groups - 1)
    ends = jnp.where(is_last, n, next_start)
    counts = jnp.where(valid, ends - safe_starts, 0)
    return group_keys.astype(jnp.int32), counts.astype(jnp.int32), num_groups


@functools.partial(jax.jit, static_argnames=("capacity",))
def group_agg_materialize(keys: jax.Array, values: jax.Array, capacity: int):
    """Per-group (count, sum, min, max) over a value column, gather-light.

    Sort (key, value) pairs; group sums come from prefix-sum differences at
    the G group boundaries, min/max from the first/last value of each run
    (values sorted within a key run because value is the sort tiebreaker) —
    every gather is G-sized, never row-count-sized. Returns
    (group_keys, counts, (sum_hi, sum_lo), mins, maxs, num_groups), padded
    to capacity (pad keys -1, counts 0). Sums are EXACT 64-bit integers
    split into (hi i32, lo u32) words: the prefix sum runs in i64 (x64
    scope local to this trace) so 100M-row sums of 1e9-scale values never
    lose integer precision — combine with ``(hi.astype(int64) << 32) | lo``.
    """
    n = keys.shape[0]
    # num_keys=2: value is a sort key too, so each key run has its values
    # ascending -> run min/max are its first/last elements
    # unstable: BOTH operands are sort keys, so ties are fully equal rows
    sk, sv = jax.lax.sort((keys, values), num_keys=2, is_stable=False)
    is_boundary = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sk[1:] != sk[:-1]])
    with jax.enable_x64(True):
        cs = jnp.cumsum(sv.astype(jnp.int64))

    cap_i = jnp.arange(capacity, dtype=jnp.int32)
    starts, num_groups = filter_materialize(is_boundary, capacity)
    valid = starts >= 0
    safe_starts = jnp.where(valid, starts, 0)
    group_keys = jnp.where(valid, jnp.take(sk, safe_starts), -1)
    next_start = jnp.concatenate(
        [starts[1:], jnp.full((1,), -1, jnp.int32)])
    is_last = cap_i == (num_groups - 1)
    ends = jnp.where(is_last, n, next_start)
    safe_ends = jnp.where(valid, jnp.clip(ends, 1, n), 1)
    counts = jnp.where(valid, safe_ends - safe_starts, 0)
    with jax.enable_x64(True):
        sum_hi64 = jnp.take(cs, (safe_ends - 1).astype(jnp.int64))
        sum_lo64 = jnp.where(safe_starts > 0,
                             jnp.take(cs, (safe_starts - 1).astype(jnp.int64)),
                             jnp.int64(0))
        sums64 = jnp.where(valid, sum_hi64 - sum_lo64, jnp.int64(0))
        sums_hi = (sums64 >> 32).astype(jnp.int32)
        sums_lo = (sums64 & jnp.int64(0xFFFFFFFF)).astype(jnp.uint32)
    mins = jnp.where(valid, jnp.take(sv, safe_starts), 0)
    maxs = jnp.where(valid, jnp.take(sv, safe_ends - 1), 0)
    return (group_keys, counts, (sums_hi, sums_lo), mins, maxs,
            num_groups)


def group_by_agg(keys, values, *, pad_multiple: int = 1 << 16):
    """Driver: exact-size per-group (key, count, sum, min, max) as numpy.
    Sums are exact int64 (no float rounding at any scale)."""
    keys = jnp.asarray(keys)
    values = jnp.asarray(values)
    ngroups = int(group_count(keys))
    if ngroups == 0:
        e = np.empty(0, np.int32)
        return e, e, np.empty(0, np.int64), e, e
    gk, gc, (gs_hi, gs_lo), gmin, gmax, _ = group_agg_materialize(
        keys, values, round_up(ngroups, pad_multiple))
    sl = slice(0, ngroups)
    sums = ((np.asarray(gs_hi[sl]).astype(np.int64) << 32)
            | np.asarray(gs_lo[sl]).astype(np.int64))
    return (np.asarray(gk[sl]), np.asarray(gc[sl]), sums,
            np.asarray(gmin[sl]), np.asarray(gmax[sl]))


def group_by_count(keys, *, pad_multiple: int = 1 << 16):
    """Driver: exact-size (unique_keys, counts) as numpy arrays, keys
    ascending."""
    keys = jnp.asarray(keys)
    ngroups = int(group_count(keys))
    if ngroups == 0:
        return np.empty((0,), np.int32), np.empty((0,), np.int32)
    gk, gc, _ = group_materialize(keys, round_up(ngroups, pad_multiple))
    return np.asarray(gk[:ngroups]), np.asarray(gc[:ngroups])
