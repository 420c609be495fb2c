"""Device mesh helpers for multi-device scaling.

The reference has no distributed layer at all (SURVEY.md §2.3: no MPI/NCCL,
one optional thread).  This build scales through ``jax.sharding``: one
mesh, named axes, shardings annotated at function boundaries, XLA inserting
the collectives (NCCL on GPUs).  These helpers centralize mesh construction so engine,
BA, and the semantic head agree on axis names:

* ``landmark`` — the BA landmark-block axis (Schur elimination is local per
  landmark; the reduced camera system is a ``psum``).
* ``data``     — batch axis for replicated/parallel frame processing and the
  semantic head.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

LANDMARK_AXIS = "landmark"
DATA_AXIS = "data"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up: ``jax.distributed.initialize`` with env-var
    fallbacks (the NCCL/MPI bootstrap the reference never had; SURVEY §5
    'Distributed communication backend').  No-op on single-host."""
    if num_processes is None or num_processes <= 1:
        return
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_devices: int | None = None, axis: str = LANDMARK_AXIS) -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_2d_mesh(data: int, model: int) -> Mesh:
    """(data x landmark) mesh for combined batch + BA-block sharding."""
    devs = np.array(jax.devices()[: data * model]).reshape(data, model)
    return Mesh(devs, (DATA_AXIS, LANDMARK_AXIS))


def shard_landmarks(mesh: Mesh, arr: jax.Array, axis_name: str = LANDMARK_AXIS):
    """Place a landmark-major array with its leading axis sharded."""
    spec = P(axis_name, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, arr: jax.Array):
    return jax.device_put(arr, NamedSharding(mesh, P()))
