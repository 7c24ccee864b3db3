"""Equi-join over i32 key columns — the engine's flagship operator.

Capability parity with the reference's chained hash join
(reference join_v1.mlir:525-649 / join_v2.mlir:607-730): given a build
relation R and probe relation S, produce all (rowID_R, rowID_S) pairs with
R.key == S.key, with *exact-size* result allocation, compared to the oracle
as a multiset (reference shared_stuff/shared.cpp:129-171).

Design — none of the reference's machinery is carried over:

===========================  =============================================
reference (single GPU SIMT)  this engine (vectorized XLA dataflow)
===========================  =============================================
linked-list hash table built
with atomic fetch-add +      build side *sorted by key* (one 2-operand
atomic-exchange inserts      XLA sort); the sorted order IS the hash
(join_v1.mlir:213-249)       table — every key's matches are contiguous
count kernel: per-thread     count = searchsorted(sorted_keys, probe_keys,
chain walk (scf.while,       left/right); counts = hi - lo. One vector op,
join_v1.mlir:342-367)        no pointer chasing, skew-proof
thread-0 serial block        exclusive prefix sum = jnp.cumsum on the whole
prefix sum + atomic global   counts vector (the reference's two-level
offset (join_v1.mlir:        shmem scan + atomic collapses into one scan)
375-407)
probe kernel: chain re-walk, result expansion (:func:`expand`): one packed
store at per-thread          marker per matched row scattered at its
precomputed offset           output offset, forward-filled by a running
(join_v1.mlir:483-514)       max — no atomics, race-free by dataflow
===========================  =============================================

The count->allocate->materialize split is kept (it is the reference's
exact-size-result contract, join_v1.mlir:591-605): count returns the result
size to the host, the host rounds capacity up to a bucket (to bound
recompilation), and materialize runs at that static capacity.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpujoin.utils.shapes import round_up

# jnp.searchsorted method for the engine's large rank lookups (v1 and v2
# count phases, the shuffle join). "sort" ranks by two library sorts of
# the concatenated keys; on the H100 at 100M x 100M it beat "scan_unrolled"
# and "scan" for sorted and unsorted queries alike (PERF.md, PR 1).
# Lookups of a handful of queries pass "scan_unrolled" instead.
SEARCH_METHOD = "sort"


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class HashJoinTable:
    """The built side of the join: keys sorted on device + the permutation.

    The sorted order plays the role of the reference's bucket array + linked
    list (reference join_v1.mlir:25-39 allocates head/next/key/rowID arrays):
    rows with equal keys are contiguous, so a "bucket" is a [lo, hi) range
    found by binary search instead of a pointer chain.
    """

    sorted_keys: jax.Array   # [n] i32, ascending
    sorted_ids: jax.Array    # [n] i32, original row ids under the sort

    def tree_flatten(self):
        return (self.sorted_keys, self.sorted_ids), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)

    @property
    def num_rows(self) -> int:
        return int(self.sorted_keys.shape[0])


@jax.jit
def build(build_keys: jax.Array) -> HashJoinTable:
    """Build phase (replaces @buildTable + @initializeHashTable,
    reference join_v1.mlir:54-108): one (key, row id) sort."""
    n = build_keys.shape[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    # unstable: equal-key runs may hold their ids in any order — every
    # consumer treats a run as an id multiset (oracle-checked)
    sk, sid = jax.lax.sort((build_keys, ids), num_keys=1, is_stable=False)
    return HashJoinTable(sk, sid)


def ranks(sorted_keys: jax.Array, queries: jax.Array,
          method: str = SEARCH_METHOD):
    """(lo, counts): per query, its lower bound in ``sorted_keys`` and the
    number of equal keys there. Queries may be in any order."""
    lo = jnp.searchsorted(sorted_keys, queries, side="left", method=method)
    hi = jnp.searchsorted(sorted_keys, queries, side="right", method=method)
    return lo.astype(jnp.int32), (hi - lo).astype(jnp.int32)


@jax.jit
def probe_count(ht: HashJoinTable, probe_keys: jax.Array):
    """Count phase (replaces @countRows, reference join_v1.mlir:110-147).

    Returns (lo, counts): per-probe-row bucket start in the sorted build
    side and match count. total = counts.sum() is the exact result size the
    reference memcpys back to the host (join_v1.mlir:140-144).
    """
    return ranks(ht.sorted_keys, probe_keys)


@jax.jit
def probe_count_masked(ht: HashJoinTable, probe_keys: jax.Array, valid_rows):
    """probe_count with rows >= valid_rows forced to zero matches.

    ``valid_rows`` is a *traced* scalar, so a padded tail chunk reuses the
    full chunk's compiled executable instead of forcing a recompile for its
    odd shape (compile latency dominates small queries). Zero-count
    trailing rows are never selected by materialize (they own no slot).
    """
    lo, counts = probe_count(ht, probe_keys)
    in_range = jnp.arange(probe_keys.shape[0], dtype=jnp.int32) < valid_rows
    return lo, jnp.where(in_range, counts, 0)


def expand(lo: jax.Array, counts: jax.Array, capacity: int):
    """Run expansion shared by every join path: for output slot
    t < capacity, the row ``row[t]`` whose run covers t and the build
    position ``bpos[t] = lo[row] + (t - offset[row])``. Row i's run is
    [offset[i], offset[i] + counts[i]) with offset the exclusive prefix
    sum of ``counts``; rows with zero counts own no slot. Slots at or past
    the total hold in-range rows but no pair, and must be masked by the
    caller. Returns (row, bpos, total), total as i32.

    One packed i64 marker per matched row — (row << 32) | biased(lo -
    offset) — is scattered at its output offset and forward-filled by
    ``lax.cummax``: rows ascend with offsets, so the markers ascend and a
    running max IS the forward fill. Cost O(rows + capacity), no sort."""
    m = counts.shape[0]
    offsets = jnp.cumsum(counts) - counts          # exclusive prefix sum
    total = offsets[-1] + counts[-1] if m else jnp.int32(0)
    t = jnp.arange(capacity, dtype=jnp.int32)
    with jax.enable_x64(True):
        rows64 = jnp.arange(m, dtype=jnp.int64)
        c64 = (lo - offsets).astype(jnp.int64) + jnp.int64(1 << 31)
        pack = (rows64 << 32) | c64
        pos = jnp.where(counts > 0, offsets, capacity)
        sentinel = jnp.int64(-1) << 62
        mark = jnp.full((capacity,), sentinel, jnp.int64)
        mark = mark.at[pos].set(pack, mode="drop")
        filled = jax.lax.cummax(mark)
        row = (filled >> 32).astype(jnp.int32)
        coff = ((filled & jnp.int64(0xFFFFFFFF))
                - jnp.int64(1 << 31)).astype(jnp.int32)
    seen = row >= 0
    return (jnp.where(seen, row, 0), jnp.where(seen, coff + t, 0),
            total.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("capacity",))
def probe_materialize(
    ht: HashJoinTable,
    lo: jax.Array,
    counts: jax.Array,
    capacity: int,
    probe_base: int | jax.Array = 0,
    probe_ids: jax.Array | None = None,
):
    """Materialize phase (replaces @probeRelation, reference
    join_v1.mlir:149-176), shared by v1, v2 and the shuffle join: expand
    (lo, counts) into rowID pairs with :func:`expand` plus one O(capacity)
    gather of build ids. Count row i stands for probe row
    ``probe_ids[i]`` (v2's sorted-probe order) or i itself (v1), offset
    by ``probe_base``. Slots >= total are padded with -1.

    Returns (r_ids, s_ids, total, fits) where r_ids/s_ids are [capacity]
    i32; ``fits`` is False iff capacity < total (the output would then be a
    silently-truncated multiset — every driver checks it).
    """
    row, bpos, total = expand(lo, counts, capacity)
    valid = jnp.arange(capacity, dtype=jnp.int32) < total
    bpos = jnp.clip(bpos, 0, ht.num_rows - 1)
    if probe_ids is not None:
        row = jnp.take(probe_ids, row)
    r_ids = jnp.where(valid, jnp.take(ht.sorted_ids, bpos), -1)
    s_ids = jnp.where(valid, row + probe_base, -1)
    return (r_ids.astype(jnp.int32), s_ids.astype(jnp.int32), total,
            total <= capacity)


def hash_join(
    build_keys,
    probe_keys,
    *,
    probe_chunk_rows: int | None = None,
    result_pad_multiple: int = 1 << 20,
    return_numpy: bool = True,
):
    """Full equi-join driver (replaces @main, reference join_v1.mlir:525-649).

    Streams the probe side through the device in chunks (bounding the result
    buffer — the reference's 1B-row config needs ~8 GB of result and the
    reference allocates it all at once, join-performances.md:5), pulling each
    chunk's exact size to the host and materializing at a bucketed capacity.

    Returns (r_ids, s_ids): i32 arrays of exactly the result size, a multiset
    of matching (build rowID, probe rowID) pairs in unspecified order.
    """
    build_keys = jnp.asarray(build_keys)
    probe_keys = jnp.asarray(probe_keys)
    m = int(probe_keys.shape[0])
    chunk = m if probe_chunk_rows is None else min(probe_chunk_rows, max(m, 1))

    ht = build(build_keys)
    out_r, out_s = [], []
    for start in range(0, m, chunk) if m else []:
        end = min(start + chunk, m)
        pk = jax.lax.slice_in_dim(probe_keys, start, end)
        if end - start < chunk:
            # pad the tail chunk to the common shape; padded rows are
            # masked to zero matches below, so one compiled executable
            # serves every chunk.
            pk = jnp.pad(pk, (0, chunk - (end - start)))
        lo, counts = probe_count_masked(ht, pk, jnp.int32(end - start))
        # int32 sum is safe: a chunk's match count is bounded by
        # probe_chunk_rows * build_rows matches only in the degenerate
        # all-equal-keys case; callers bound chunks so totals stay < 2^31.
        total = int(jnp.sum(counts))
        if total == 0:
            continue
        cap = round_up(total, result_pad_multiple)
        r_ids, s_ids, _, fits = probe_materialize(ht, lo, counts, cap,
                                                  probe_base=start)
        assert bool(fits), "materialize capacity undersized"
        out_r.append(np.asarray(r_ids[:total]))
        out_s.append(np.asarray(s_ids[:total]))

    if not out_r:
        r = np.empty((0,), np.int32)
        s = np.empty((0,), np.int32)
    else:
        r = np.concatenate(out_r)
        s = np.concatenate(out_s)
    if return_numpy:
        return r, s
    return jnp.asarray(r), jnp.asarray(s)


def hash_join_rle(build_keys, probe_keys):
    """v1 factorized (RLE) join result: (probe_ids, lo, cnt, sorted_ids)
    where the expansion of row r is pairs (sorted_ids[lo[r]+j],
    probe_ids[r]) for j < cnt[r].

    For the v1 (searchsorted) engine this is FREE beyond the count phase:
    probe_count's (lo, counts) in probe order IS the run-length result —
    no expansion and no gather (the same move the reference's count kernel
    makes by returning only the result SIZE without materializing,
    join_v1.mlir:140-146). The v2 analogue is
    ops.merge_join.merge_join_rle."""
    build_keys = jnp.asarray(build_keys)
    probe_keys = jnp.asarray(probe_keys)
    ht = build(build_keys)
    lo, counts = probe_count(ht, probe_keys)
    m = int(probe_keys.shape[0])
    return (np.arange(m, dtype=np.int32), np.asarray(lo),
            np.asarray(counts), np.asarray(ht.sorted_ids))


@functools.partial(jax.jit, static_argnames=("capacity",))
def hash_join_device(build_keys, probe_keys, capacity: int):
    """Single-jit fixed-capacity join: build + count + materialize fused.

    For fully-on-device pipelines and benchmarking: the caller supplies the
    result capacity (pad slots are -1); ``total`` reports the true size and
    ``fits`` whether the capacity held it. Returns (r_ids, s_ids, total,
    fits).
    """
    ht = build(build_keys)
    lo, counts = probe_count(ht, probe_keys)
    return probe_materialize(ht, lo, counts, capacity)
