"""The one module that knows which platform the program runs on: the GPU
check of the entry points, the persistent compile cache, and the peak
table for roofline accounting.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_ROOT = Path(__file__).resolve().parents[2]

# device_kind -> HBM bandwidth in GB/s (NVIDIA H100 SXM data sheet: 80 GB
# at 3.35 TB/s). A GPU missing here is an error, never a guessed peak.
_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def require_gpu(what: str) -> None:
    """Exit non-zero unless JAX's default backend is a GPU: a measurement
    path never falls back to the CPU."""
    if jax.default_backend() != "gpu":
        raise SystemExit(f"{what}: no GPU found (JAX default backend is "
                         f"{jax.default_backend()!r})")


def hbm_peak_gbps(device=None) -> float | None:
    """HBM peak of ``device`` (default: the first device) in GB/s; None on
    the CPU, which gets no roofline share. Raises on a GPU that is not in
    the table."""
    if device is None:
        device = jax.devices()[0]
    if device.platform == "cpu":
        return None
    try:
        return _HBM_GBPS[device.device_kind]
    except KeyError:
        raise ValueError(
            f"no HBM peak known for device kind {device.device_kind!r}; "
            f"add it to tpujoin.utils.hw._HBM_GBPS with its source") from None


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.
    When JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and nothing
    else is set; otherwise the cache lives at the fixed path
    ``<repo>/.jax_cache`` (the path is part of the cache key)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(REPO_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
