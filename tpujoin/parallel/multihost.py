"""Multi-process mesh bootstrap.

One process can drive every card of a host, which is how the engine runs
on four cards. Several processes — one per host, or several on one host —
join through ``initialize()``: afterwards every process sees the global
device set and the SAME engine code (shuffle join, skew split, pipelined
exchange) runs unchanged; nothing else in the engine is process-count-
aware. Pass the coordinator address (``host:port``), the process count
and this process's id explicitly: no cluster environment supplies them.
Single-process setups skip initialize entirely.

The multi-process runtime is exercised by tests/test_multihost.py (two
local processes, CPU backend, localhost coordinator) driving
``initialize`` + ``make_global_mesh`` + one shuffle-join step with an
exact-count check; the collective programs are further validated on an
emulated 8-device CPU mesh (tests/test_dist.py, tests/test_skew.py) and
by ``__graft_entry__.dryrun_multichip``.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from tpujoin.parallel.mesh import ROW_AXIS


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the JAX distributed runtime (call once per process before
    any device use). Unset arguments are left to JAX's own discovery."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def make_global_mesh() -> Mesh:
    """1-D row mesh over ALL devices across every process (vs
    mesh.make_mesh, which uses the process-local view). The row axis spans
    processes; shard_map + XLA collectives handle the transport."""
    return Mesh(np.array(jax.devices()), (ROW_AXIS,))


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def put_row_sharded(arr: np.ndarray, mesh: Mesh) -> jax.Array:
    """Row-shard a host-replicated numpy array over a (possibly
    multi-process) mesh. ``jax.device_put`` can only target the calling
    process's addressable devices, so the single-host drivers' put is NOT
    multi-process-safe; this builds the global array shard-by-shard via
    ``make_array_from_callback`` — every process materializes exactly its
    addressable slices of the same host-replicated input."""
    sharding = NamedSharding(mesh, PartitionSpec(ROW_AXIS))
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])
