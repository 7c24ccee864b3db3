"""Device mesh setup.

The reference is strictly single-GPU (reference projectDescription.md:23-24
leaves partitioning and out-of-memory relations as future work); scale-out
here is a 1-D ``jax.sharding.Mesh`` whose axis is the engine's only
meaningful parallelism axis: *rows* (tables partitioned across devices).
The collectives are XLA's (NCCL between the NVLink-joined cards of one
host), never hand-coded; every device reaches every other at one rate, so
the mesh follows the algorithm alone.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


ROW_AXIS = "x"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the first n_devices (default: all) local devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (ROW_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a 1-D array's rows across the mesh."""
    return NamedSharding(mesh, P(ROW_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
