"""Data-parallel tracking: N independent sequence streams over the mesh.

The reference processes one sequence on one CPU.  For fleet-scale offline
odometry (mapping runs, dataset evaluation sweeps) this build shards a
*batch of sequences* over the ``data`` axis: each device carries the VOState
of its own streams and executes the same jitted tracking step — pure SPMD,
no cross-device traffic during tracking (collectives only appear in the
distributed BA refinement).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from stereo_semantic_vo_tpu.core.config import VOConfig
from stereo_semantic_vo_tpu.engine.state import VOState, init_state
from stereo_semantic_vo_tpu.engine.tracker import FrameInput, init_step, track_step
from stereo_semantic_vo_tpu.parallel.mesh import DATA_AXIS


def batched_init_state(cfg: VOConfig, batch: int) -> VOState:
    s = init_state(cfg)
    return jax.tree.map(lambda x: jnp.stack([x] * batch), s)


def make_dp_tracker(mesh: Mesh, cfg: VOConfig):
    """Returns step(states, frames) -> (states, outputs), both batched on the
    leading axis and sharded over the mesh's data axis.  Dispatches init vs
    track per stream (streams can start at different times)."""

    def one(state, frame):
        return jax.lax.cond(
            state.frame_idx < 0,
            lambda s, f: init_step(s, f, cfg),
            lambda s, f: track_step(s, f, cfg),
            state, frame,
        )

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    def step(states: VOState, frames: FrameInput):
        return jax.vmap(one)(states, frames)

    return step
