"""Radix partitioning: histogram + stable reorder by key digits.

The partitioning primitive behind the distributed shuffle join (BASELINE.json
config 3 "radix-partitioned hash join" and config 4's shuffle) — the
reference has none of this; "Partitioned Hash-Join" is on its future-work
list (reference projectDescription.md:23).

Design note: the classic radix pass is histogram -> prefix sum ->
scatter-at-computed-offsets. Here the stable reorder step is one XLA sort
keyed on the (small-domain) partition digit, and the histogram/offsets come
from the same sorted form via searchsorted — no scatter anywhere.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def hash32(keys: jax.Array) -> jax.Array:
    """Murmur3 finalizer (public-domain integer mix) — decorrelates key bits
    before partition assignment, so ``key % P`` patterns in the data cannot
    skew partitions. Returns uint32."""
    x = keys.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


@functools.partial(jax.jit, static_argnames=("num_partitions",))
def partition_ids(keys: jax.Array, num_partitions: int) -> jax.Array:
    """Partition assignment via multiplicative hashing: uniform over
    [0, num_partitions) for any key distribution."""
    h = hash32(keys)
    # uint32 modulo: bias is < P/2^32, negligible for any practical mesh
    # (x64 is disabled under jit, so no 64-bit fixed-point reduction here)
    return (h % jnp.uint32(num_partitions)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("num_partitions",))
def radix_partition(keys: jax.Array, row_ids: jax.Array, num_partitions: int):
    """Reorder (keys, row_ids) so partition p's rows are contiguous.

    Returns (pkeys, pids, offsets, counts): offsets[p] is partition p's start
    in the reordered arrays, counts[p] its size (CSR layout — the vectorized
    analogue of a bucketized hash table).
    """
    pid = partition_ids(keys, num_partitions)
    spid, skeys, sids = jax.lax.sort((pid, keys, row_ids), num_keys=1)
    boundaries = jnp.arange(num_partitions, dtype=jnp.int32)
    offsets = jnp.searchsorted(spid, boundaries, side="left", method="sort")
    ends = jnp.searchsorted(spid, boundaries, side="right", method="sort")
    counts = (ends - offsets).astype(jnp.int32)
    return skeys, sids, offsets.astype(jnp.int32), counts


@functools.partial(jax.jit, static_argnames=("bits_per_pass",))
def radix_sort(keys: jax.Array, bits_per_pass: int = 8):
    """LSD radix sort over i32 keys; returns (sorted_keys, permutation).

    Each digit pass is a stable reorder keyed on the digit (one XLA sort).
    For a full-width key a single fused sort on the biased key beats
    multi-pass digit sorting — this function exists for operator-API
    parity and for sorting by a *narrow* digit cheaply;
    :func:`tpujoin.ops.sort.sort_with_ids` is the production path.
    """
    n = keys.shape[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    # bias to unsigned order so negative keys sort correctly per-digit
    biased = keys.astype(jnp.uint32) ^ jnp.uint32(0x80000000)
    perm = ids
    cur = biased
    for shift in range(0, 32, bits_per_pass):
        digit = (cur >> jnp.uint32(shift)) & jnp.uint32((1 << bits_per_pass) - 1)
        _, cur, perm = jax.lax.sort(
            (digit.astype(jnp.int32), cur, perm), num_keys=1, is_stable=True
        )
    return (cur ^ jnp.uint32(0x80000000)).astype(jnp.int32), perm
