"""Distributed Schur-complement bundle adjustment over a device mesh.

The one genuinely distributed workload in the system (SURVEY.md §2.3 item 2,
BASELINE.json north star): landmark blocks are sharded across devices; each
device eliminates its own landmark diagonal locally (the Schur trick is
embarrassingly parallel over landmarks) and the (F*6)^2 reduced camera system
is formed with a single ``psum`` over the mesh — the collective analogue of
g2o's BlockSolver (Thirdparty/g2o/g2o/core/block_solver.hpp) with device
collectives (NCCL over NVLink on GPUs) in place of a shared heap.

Per LM iteration, per device with L/D local landmarks:
  1. residuals/Jacobians for (F, L/D) observations        — local work
  2. Hcc, gc, S-contribution, rhs-contribution            — local einsums
  3. psum -> every device holds the full reduced system   — one collective
  4. 24x24 solve (replicated, negligible)                 — local
  5. back-substitute own landmark updates                 — local
  6. psum(cost) drives the shared accept/reject + damping — one scalar psum

Communication per iteration is O(F^2 * 36 + F * 6) floats — independent of
the landmark count, which is why scaling efficiency stays high as the map
grows.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from stereo_semantic_vo_tpu.core import lie
from stereo_semantic_vo_tpu.core.camera import Camera
from stereo_semantic_vo_tpu.core.config import BAConfig
from stereo_semantic_vo_tpu.ops.local_ba import (
    _GAUGE_PRIOR,
    _damp,
    _residual_and_jacobians,
    build_normal_equations,
)
from stereo_semantic_vo_tpu.parallel.mesh import LANDMARK_AXIS
from stereo_semantic_vo_tpu.core.precision import f32_geometry


class ShardedBAResult(NamedTuple):
    poses: jax.Array   # (F, 4, 4) replicated
    points: jax.Array  # (L, 3) landmark-sharded
    cost: jax.Array    # () replicated


def _local_cost(poses, points, obs_uv, obs_mask, cam, delta, axis,
                obs_ur=None, obs_r_mask=None):
    c = _residual_and_jacobians(
        poses, points, obs_uv, obs_mask, cam, delta, obs_ur, obs_r_mask
    )[4]
    return jax.lax.psum(c, axis)


@f32_geometry
def _sharded_ba_body(
    poses, points, obs_uv, obs_mask, point_valid, cam: Camera, cfg: BAConfig,
    fix_first_pose: bool, axis: str, obs_ur=None, obs_r_mask=None,
):
    """Runs inside shard_map: points/obs arrays are the *local* shard.
    ``obs_ur``/``obs_r_mask`` add the stereo BA edge (u_R = u - bf/z) per
    observation — same semantics as the single-device ops/local_ba path;
    both shard over landmarks like every other obs tensor, so the collective
    structure is unchanged."""
    F = poses.shape[0]
    obs_mask = obs_mask & point_valid[None, :]

    def cost_fn(po, pt):
        return _local_cost(
            po, pt, obs_uv, obs_mask, cam, cfg.huber_delta, axis,
            obs_ur, obs_r_mask,
        )

    def step(carry, _):
        po, pt, lam, cost = carry
        eq = build_normal_equations(
            po, pt, obs_uv, obs_mask, cam, cfg.huber_delta,
            obs_ur=obs_ur, obs_r_mask=obs_r_mask,
        )
        pv = point_valid.astype(jnp.float32)

        Hpp_d = _damp(eq.Hpp, lam)
        Hpp_d = jnp.where(pv[:, None, None] > 0, Hpp_d, jnp.eye(3)[None])
        Hpp_inv = jnp.linalg.inv(Hpp_d) * pv[:, None, None]

        W = jnp.einsum("flab,lbc->flac", eq.Hcp, Hpp_inv)
        S_local = jnp.einsum("flac,glbc->fgab", W, eq.Hcp)
        rhs_local = jnp.einsum("flac,lc->fa", W, eq.gp)

        # the Hcc/gc sums also partition over landmarks -> psum everything
        S_blocks, rhs_red, Hcc, gc = jax.lax.psum(
            (S_local, rhs_local, eq.Hcc, eq.gc), axis
        )
        Hcc_d = _damp(Hcc, lam)
        S = -S_blocks
        S = S.at[jnp.arange(F), jnp.arange(F)].add(Hcc_d)
        rhs = gc - rhs_red
        S_flat = S.transpose(0, 2, 1, 3).reshape(F * 6, F * 6)
        if fix_first_pose:
            S_flat = S_flat + jnp.diag(jnp.zeros(F * 6).at[:6].set(_GAUGE_PRIOR))
        dx_c = -jnp.linalg.solve(S_flat, rhs.reshape(F * 6)).reshape(F, 6)

        gp_eff = eq.gp + jnp.einsum("flab,fa->lb", eq.Hcp, dx_c)
        dx_p = -jnp.einsum("lab,lb->la", Hpp_inv, gp_eff)

        po_new = jax.vmap(lambda d, T: lie.se3_exp(d) @ T)(dx_c, po)
        pt_new = pt + dx_p
        new_cost = cost_fn(po_new, pt_new)
        accept = new_cost < cost
        po = jnp.where(accept, po_new, po)
        pt = jnp.where(accept, pt_new, pt)
        lam = jnp.clip(
            jnp.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up), 1e-9, 1e6
        )
        cost = jnp.where(accept, new_cost, cost)
        return (po, pt, lam, cost), None

    cost0 = cost_fn(poses, points)
    (po, pt, _, cost), _ = jax.lax.scan(
        step, (poses, points, jnp.float32(cfg.init_lambda), cost0), None,
        length=cfg.local_iterations,
    )
    return po, pt, cost


def make_sharded_local_ba(
    mesh: Mesh, cam: Camera, cfg: BAConfig, fix_first_pose: bool = True,
    stereo_edges: bool = False,
):
    """Build the jitted distributed BA: landmark-sharded points/observations,
    replicated poses.  Landmark count must divide the mesh size.  With
    ``stereo_edges`` the runner takes two extra landmark-sharded (F, L)
    arrays (obs_ur, obs_r_mask) adding the stereo residual per observation."""
    axis = LANDMARK_AXIS
    pspec_rep = P()
    pspec_lm = P(axis)

    if stereo_edges:
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(pspec_rep, pspec_lm, P(None, axis), P(None, axis),
                      pspec_lm, P(None, axis), P(None, axis)),
            out_specs=(pspec_rep, pspec_lm, pspec_rep),
            check_vma=False,
        )
        def _body_st(poses, points, obs_uv, obs_mask, point_valid, obs_ur, obs_rm):
            return _sharded_ba_body(
                poses, points, obs_uv, obs_mask, point_valid, cam, cfg,
                fix_first_pose, axis, obs_ur, obs_rm,
            )

        @jax.jit
        def run_st(poses, points, obs_uv, obs_mask, point_valid,
                   obs_ur, obs_r_mask) -> ShardedBAResult:
            po, pt, cost = _body_st(
                poses, points, obs_uv, obs_mask, point_valid, obs_ur, obs_r_mask
            )
            return ShardedBAResult(poses=po, points=pt, cost=cost)

        return run_st

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(pspec_rep, pspec_lm, P(None, axis), P(None, axis), pspec_lm),
        out_specs=(pspec_rep, pspec_lm, pspec_rep),
        check_vma=False,
    )
    def _body(poses, points, obs_uv, obs_mask, point_valid):
        return _sharded_ba_body(
            poses, points, obs_uv, obs_mask, point_valid, cam, cfg,
            fix_first_pose, axis,
        )

    @jax.jit
    def run(poses, points, obs_uv, obs_mask, point_valid) -> ShardedBAResult:
        po, pt, cost = _body(poses, points, obs_uv, obs_mask, point_valid)
        return ShardedBAResult(poses=po, points=pt, cost=cost)

    return run
