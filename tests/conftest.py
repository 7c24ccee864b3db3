"""Test environment: force the JAX CPU backend with 8 virtual devices so
multi-device sharding is exercised without GPUs (SURVEY.md §4: the
reference has no tests at all; we add unit + property + emulated-mesh tests).

Must run before any test module imports jax; the config update after import
makes the CPU choice authoritative.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
