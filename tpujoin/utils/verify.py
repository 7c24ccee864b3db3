"""Full-coverage result verification machinery (device + host halves).

The reference's oracle gate checks EVERY pair of every run
(reference shared_stuff/shared.cpp:154-171). Shipping multi-GB pair
columns to the host for a sort-based comparison costs more than the join,
so coverage is achieved by 64-bit checksums reduced ON DEVICE and compared
against host-side streaming recomputation:

- position-sensitive per-window checksums (:func:`window_checksums` vs
  :func:`expected_checksums`) prove the materialized columns equal the
  verified factorized form slot by slot;
- the order-invariant multiset checksum (:func:`multiset_checksum`,
  wrapping u64 SUM of mix64(r<<32|s) — addition, not xor, so a
  duplicated+dropped pair cannot cancel) proves multiset equality for
  engines that emit pairs in a different order (v1's unsorted-probe
  layout, every distributed program's per-device shards).

Any slot whose (r, s) differs from the expectation flips its checksum
with probability 1 - 2^-64. Shared by bench.py and the distributed
checks of chip_smoke.py: every check covers pairs_checked ==
result_rows.
"""
from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

VERIFY_WINDOW = 1 << 20
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
GOLDEN = 0x9E3779B97F4A7C15


def mix64_np(z):
    z = (z ^ (z >> np.uint64(30))) * np.uint64(_M1)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(_M2)
    return z ^ (z >> np.uint64(31))


@functools.partial(jax.jit, static_argnames=("num_windows",))
def window_checksums(r_ids, s_ids, total, num_windows: int):
    """[num_windows] u32x2 position-sensitive checksums over 2^20-slot
    windows (slots >= total contribute nothing). One jit, one scan;
    per-step temps ~8 MB."""
    w = VERIFY_WINDOW
    with jax.enable_x64(True):
        r2 = r_ids.reshape(num_windows, w)
        s2 = s_ids.reshape(num_windows, w)
        total = total.astype(jnp.int64)

        def one(c, xs):
            r, s = xs
            t = c * w + jnp.arange(w, dtype=jnp.int64)
            pack = (r.astype(jnp.uint64) << 32) | s.astype(jnp.uint64)
            z = pack + t.astype(jnp.uint64) * jnp.uint64(GOLDEN)
            z = (z ^ (z >> 30)) * jnp.uint64(_M1)
            z = (z ^ (z >> 27)) * jnp.uint64(_M2)
            z = z ^ (z >> 31)
            h = jax.lax.reduce(
                jnp.where(t < total, z, jnp.uint64(0)), jnp.uint64(0),
                jax.lax.bitwise_xor, (0,))
            return c + 1, h

        _, hs = jax.lax.scan(one, jnp.int64(0), (r2, s2))
        return (jnp.right_shift(hs, jnp.uint64(32)).astype(jnp.uint32),
                (hs & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32))


@functools.partial(jax.jit, static_argnames=("num_windows",))
def multiset_checksum(r_ids, s_ids, total, num_windows: int):
    """Order-invariant u64 multiset checksum of the first ``total`` (r, s)
    slots: wrapping sum of mix64(r<<32|s). Returned as (hi32, lo32)."""
    w = VERIFY_WINDOW
    with jax.enable_x64(True):
        r2 = r_ids.reshape(num_windows, w)
        s2 = s_ids.reshape(num_windows, w)
        total = total.astype(jnp.int64)

        def one(carry, xs):
            c, acc = carry
            r, s = xs
            t = c * w + jnp.arange(w, dtype=jnp.int64)
            z = (r.astype(jnp.uint64) << 32) | s.astype(jnp.uint64)
            z = (z ^ (z >> 30)) * jnp.uint64(_M1)
            z = (z ^ (z >> 27)) * jnp.uint64(_M2)
            z = z ^ (z >> 31)
            acc = acc + jnp.sum(jnp.where(t < total, z, jnp.uint64(0)))
            return (c + 1, acc), None

        (_, acc), _ = jax.lax.scan(one, (jnp.int64(0), jnp.uint64(0)),
                                   (r2, s2))
        return ((acc >> jnp.uint64(32)).astype(jnp.uint32),
                (acc & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32))


def device_multiset_sum(r_ids, s_ids, total) -> int:
    """Host int of :func:`multiset_checksum` over a padded result buffer
    whose first ``total`` slots are valid (the distributed per-shard
    layout). Pads the buffer to a whole number of windows."""
    cap = r_ids.shape[0]
    pad = (-cap) % VERIFY_WINDOW
    if pad:
        r_ids = jnp.pad(r_ids, (0, pad))
        s_ids = jnp.pad(s_ids, (0, pad))
    hi, lo = multiset_checksum(r_ids, s_ids, jnp.asarray(total),
                               (cap + pad) // VERIFY_WINDOW)
    return ((int(hi) << 32) | int(lo)) % (1 << 64)


def expected_checksums(src, sid, lo, cnt, total: int, num_windows: int):
    """Host-streamed per-window checksums + the multiset sum from an
    (already verified) RLE form — never materializing more than one
    window. ``src`` maps build positions to ids; run r expands to pairs
    (src[lo[r] + j], sid[r]) for j < cnt[r]."""
    w = VERIFY_WINDOW
    cnt64 = cnt.astype(np.int64)
    offs = np.cumsum(cnt64) - cnt64
    hi32 = np.empty(num_windows, np.uint32)
    lo32 = np.empty(num_windows, np.uint32)
    msum = np.uint64(0)
    for c in range(num_windows):
        a, b = c * w, min((c + 1) * w, total)
        if a >= b:
            hi32[c] = lo32[c] = 0
            continue
        i0 = max(np.searchsorted(offs, a, side="right") - 1, 0)
        i1 = np.searchsorted(offs, b, side="left")
        rs, rl, rc, rid = offs[i0:i1], lo[i0:i1], cnt64[i0:i1], sid[i0:i1]
        starts = np.maximum(rs, a)
        ends = np.minimum(rs + rc, b)
        lens = ends - starts
        j = (np.arange(b - a) - np.repeat(np.cumsum(lens) - lens, lens)
             + np.repeat(starts - rs, lens))
        r = src[np.repeat(rl, lens) + j].astype(np.uint64)
        s = np.repeat(rid, lens).astype(np.uint64)
        t = np.arange(a, b, dtype=np.uint64)
        pack = (r << np.uint64(32)) | s
        h = mix64_np(pack + t * np.uint64(GOLDEN))
        folded = np.bitwise_xor.reduce(h)
        hi32[c] = np.uint32(folded >> np.uint64(32))
        lo32[c] = np.uint32(folded & np.uint64(0xFFFFFFFF))
        with np.errstate(over="ignore"):
            msum = msum + mix64_np(pack).sum(dtype=np.uint64)
    return hi32, lo32, int(msum)


def expected_multiset_sum_pairs(r_ids: np.ndarray,
                                s_ids: np.ndarray) -> int:
    """Host multiset sum over explicit pair columns (for expectations
    built by a numpy ground-truth join)."""
    pack = ((r_ids.astype(np.uint64) << np.uint64(32))
            | s_ids.astype(np.uint64))
    with np.errstate(over="ignore"):
        return int(mix64_np(pack).sum(dtype=np.uint64))


def host_join_expectation(bk: np.ndarray, pk: np.ndarray, *,
                          parts: int = 64,
                          workers: int | None = None) -> tuple[int, int]:
    """Ground-truth (total, msum) for the equi-join of key columns bk/pk
    with global row ids — the NumPy reference for the shuffle join's
    checks, usable at 10^8-row scale. Both sides are split into ``parts``
    key-hash classes (a radix pass over the class index; hashing keeps
    skewed key ranges balanced), and each class is sorted and joined on
    its own by a thread pool: NumPy's sorts, searchsorted and ufuncs
    release the GIL."""
    bk = np.asarray(bk)
    pk = np.asarray(pk)
    if len(bk) == 0 or len(pk) == 0:
        return 0, 0
    bits = parts.bit_length() - 1
    assert parts == 1 << bits and bits <= 8

    def split(keys):
        h = keys.astype(np.int64).astype(np.uint64) * np.uint64(GOLDEN)
        part = (h >> np.uint64(64 - bits)).astype(np.uint8) if bits else \
            np.zeros(len(keys), np.uint8)
        order = np.argsort(part, kind="stable")   # radix pass on 8 bits
        bounds = np.r_[0, np.cumsum(np.bincount(part, minlength=parts))]
        return order, bounds

    order_r, bounds_r = split(bk)
    order_s, bounds_s = split(pk)

    def one(p):
        rid = order_r[bounds_r[p]:bounds_r[p + 1]]
        sid = order_s[bounds_s[p]:bounds_s[p + 1]]
        if len(rid) == 0 or len(sid) == 0:
            return 0, 0
        o = np.argsort(bk[rid])
        rid = rid[o]
        srk = bk[rid]
        sid = sid[np.argsort(pk[sid])]
        spk = pk[sid]
        lo = np.searchsorted(srk, spk, "left")
        cnt = (np.searchsorted(srk, spk, "right") - lo).astype(np.int64)
        m = int(cnt.sum())
        if m == 0:
            return 0, 0
        j = (np.arange(m) - np.repeat(np.cumsum(cnt) - cnt, cnt)
             + np.repeat(lo, cnt))
        pack = ((rid[j].astype(np.uint64) << np.uint64(32))
                | np.repeat(sid, cnt).astype(np.uint64))
        with np.errstate(over="ignore"):
            return m, int(mix64_np(pack).sum(dtype=np.uint64))

    with ThreadPoolExecutor(workers or min(parts, os.cpu_count() or 1)) as ex:
        results = list(ex.map(one, range(parts)))
    total = sum(t for t, _ in results)
    return total, sum(h for _, h in results) % (1 << 64)
