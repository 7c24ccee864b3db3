"""Python binding for the native C++ correctness oracle (ctypes).

The parity gate: every engine result must be an exact multiset match of the
oracle's recomputed join — the contract the reference enforces on every run
(reference shared_stuff/shared.cpp:129-171 ``check``, called from
join_v1.mlir:628-632). Falls back to a NumPy oracle if the shared library
cannot be built (the NumPy path is also an independent cross-check).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "liboracle.so"
_lib = None
_lib_tried = False


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if not _LIB_PATH.exists():
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(str(_LIB_PATH))
    except (OSError, subprocess.CalledProcessError):
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.oracle_join_count.restype = ctypes.c_int64
    lib.oracle_join_count.argtypes = [i32p, ctypes.c_int64, i32p,
                                      ctypes.c_int64, ctypes.c_int]
    lib.oracle_check.restype = ctypes.c_int
    lib.oracle_check.argtypes = [i32p, ctypes.c_int64, i32p, ctypes.c_int64,
                                 i32p, i32p, ctypes.c_int64, ctypes.c_int]
    lib.oracle_group_count.restype = ctypes.c_int64
    lib.oracle_group_count.argtypes = [i32p, ctypes.c_int64, i32p, i32p,
                                       ctypes.c_int64]
    lib.oracle_check_rle.restype = ctypes.c_int
    lib.oracle_check_rle.argtypes = [i32p, ctypes.c_int64, i32p,
                                     ctypes.c_int64, i32p, i32p, i32p, i32p,
                                     ctypes.c_int64]
    _lib = lib
    return _lib


def _as_i32(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a), dtype=np.int32)
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def have_native() -> bool:
    return _load() is not None


def join_count(r_keys, s_keys, *, nested: bool = False) -> int:
    """Exact |R join S| recomputed natively (sort-based unless nested)."""
    r, s = _as_i32(r_keys), _as_i32(s_keys)
    lib = _load()
    if lib is not None:
        return int(lib.oracle_join_count(_ptr(r), len(r), _ptr(s), len(s),
                                         1 if nested else 0))
    return len(_numpy_join_pairs(r, s))


def check_join(r_keys, s_keys, res_r, res_s, *, nested: bool = False) -> int:
    """1 = exact multiset match, 0 = mismatch, -1 = size mismatch
    (the reference's return contract, shared.cpp:158-171)."""
    r, s = _as_i32(r_keys), _as_i32(s_keys)
    rr, rs = _as_i32(res_r), _as_i32(res_s)
    assert len(rr) == len(rs)
    lib = _load()
    if lib is not None:
        return int(lib.oracle_check(_ptr(r), len(r), _ptr(s), len(s),
                                    _ptr(rr), _ptr(rs), len(rr),
                                    1 if nested else 0))
    expected = _numpy_join_pairs(r, s)
    if len(expected) != len(rr):
        return -1
    got = np.stack([rr, rs], axis=1)
    expected = expected[np.lexsort((expected[:, 1], expected[:, 0]))]
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    return 1 if np.array_equal(expected, got) else 0


def check_join_rle(r_keys, s_keys, sorted_build_ids, probe_ids, lo, cnt) -> int:
    """Check a factorized (RLE) join result: per probe row ``probe_ids[r]``,
    the build-id run ``sorted_build_ids[lo[r]:lo[r]+cnt[r]]`` must be the
    exact match multiset. 1 ok / 0 mismatch / -1 size mismatch. Native only
    (no NumPy fallback): falls back to expanding + :func:`check_join`."""
    r, s = _as_i32(r_keys), _as_i32(s_keys)
    sbi, pid = _as_i32(sorted_build_ids), _as_i32(probe_ids)
    lo_a, cnt_a = _as_i32(lo), _as_i32(cnt)
    lib = _load()
    if lib is not None:
        return int(lib.oracle_check_rle(_ptr(r), len(r), _ptr(s), len(s),
                                        _ptr(sbi), _ptr(pid), _ptr(lo_a),
                                        _ptr(cnt_a), len(pid)))
    res_r = np.concatenate([sbi[l:l + c] for l, c in zip(lo_a, cnt_a)]) \
        if len(pid) else np.empty(0, np.int32)
    res_s = np.repeat(pid, cnt_a) if len(pid) else np.empty(0, np.int32)
    return check_join(r, s, res_r, res_s)


def group_by_count(keys):
    """(unique_keys, counts) ascending — the aggregate oracle."""
    k = _as_i32(keys)
    lib = _load()
    if lib is not None:
        cap = len(k)
        ko = np.empty(cap, np.int32)
        co = np.empty(cap, np.int32)
        n = int(lib.oracle_group_count(_ptr(k), len(k), _ptr(ko), _ptr(co), cap))
        return ko[:n], co[:n]
    uk, uc = np.unique(k, return_counts=True)
    return uk.astype(np.int32), uc.astype(np.int32)


def check_group_agg(keys, values, gk, gc, sums, gmin, gmax) -> bool:
    """Exact parity of per-group (key, count, sum, min, max) host arrays,
    keys ascending and sums int64, against a NumPy recompute."""
    v = np.asarray(values).astype(np.int64)
    keys = np.asarray(keys)
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], v[order]
    bnd = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    ends = np.r_[bnd[1:], len(ks)]
    cs = np.r_[0, np.cumsum(vs)]
    return bool(np.array_equal(gk, ks[bnd])
                and np.array_equal(gc, ends - bnd)
                and np.array_equal(sums, cs[ends] - cs[bnd])
                and np.array_equal(np.asarray(gmin).astype(np.int64),
                                   np.minimum.reduceat(vs, bnd))
                and np.array_equal(np.asarray(gmax).astype(np.int64),
                                   np.maximum.reduceat(vs, bnd)))


def _numpy_join_pairs(r: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Independent NumPy oracle: sorted-build binary-search join."""
    order = np.argsort(r, kind="stable").astype(np.int32)
    rs = r[order]
    lo = np.searchsorted(rs, s, side="left")
    hi = np.searchsorted(rs, s, side="right")
    counts = hi - lo
    total = int(counts.sum())
    out = np.empty((total, 2), np.int32)
    pos = 0
    for j in np.nonzero(counts)[0]:
        c = counts[j]
        out[pos:pos + c, 0] = order[lo[j]:hi[j]]
        out[pos:pos + c, 1] = j
        pos += c
    return out
