"""Local bundle adjustment: sliding-window poses + landmarks, solved by
Levenberg-Marquardt with Schur-complement elimination of the landmark block.

The reference has no local BA (only the motion-only pose optimization,
src/Optimizer.cc) but vendors g2o's full sparse-block machinery for it
(Thirdparty/g2o/g2o/core/block_solver.hpp).  This module is the dense-batched
replacement: the BA normal equations are built as dense *batched blocks*

  H = [ Hcc  Hcp ]   Hcc: (F, 6, 6) block-diagonal pose blocks
      [ Hcp' Hpp ]   Hpp: (L, 3, 3) block-diagonal landmark blocks
                     Hcp: (F, L, 6, 3) coupling blocks

and the landmark block is eliminated in closed form:

  S    = Hcc - sum_l Hcp[:, l] Hpp[l]^-1 Hcp[:, l]'   (reduced camera system)
  rhs  = gc  - sum_l Hcp[:, l] Hpp[l]^-1 gp[l]
  dx_c = solve(S, rhs);  dx_p[l] = Hpp[l]^-1 (gp[l] - Hcp[:, l]' dx_c)

Every step is an einsum over the landmark axis — which is exactly the axis
parallel/sharded_ba.py shards across devices, turning the two sums into
``psum`` collectives (SURVEY.md §2.3 item 2).

Gauge freedom is fixed by a strong prior on pose 0 (the window anchor).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_semantic_vo_tpu.core import lie
from stereo_semantic_vo_tpu.core.camera import Camera
from stereo_semantic_vo_tpu.core.config import BAConfig
from stereo_semantic_vo_tpu.ops.ba import huber_weights
from stereo_semantic_vo_tpu.core.precision import f32_geometry

_GAUGE_PRIOR = 1e8


class LocalBAResult(NamedTuple):
    poses: jax.Array   # (F, 4, 4)
    points: jax.Array  # (L, 3)
    cost: jax.Array


class NormalEq(NamedTuple):
    Hcc: jax.Array  # (F, 6, 6)
    Hcp: jax.Array  # (F, L, 6, 3)
    Hpp: jax.Array  # (L, 3, 3)
    gc: jax.Array   # (F, 6)
    gp: jax.Array   # (L, 3)
    cost: jax.Array


def _residual_and_jacobians(
    poses, points, obs_uv, obs_mask, cam, huber_delta,
    obs_ur=None, obs_r_mask=None,
):
    """Residuals + analytic Jacobians for all (frame, landmark) pairs.

    poses (F,4,4), points (L,3), obs_uv (F,L,2), obs_mask (F,L) ->
    r (F,L,C), w (F,L) IRLS weights, Jc (F,L,C,6), Jp (F,L,C,3), cost ().

    With ``obs_ur``/``obs_r_mask`` (F,L) given, a third *stereo* residual
    u_R = u - bf/z is added per observation (masked per-observation, since
    sparse stereo can fail where tracking succeeded).  This is the
    ORB-SLAM-class stereo BA edge (g2o EdgeStereoSE3ProjectXYZ): without it
    joint window BA silently *replaces* each landmark's precise one-frame
    stereo depth with weak few-frame-baseline triangulation and makes the
    estimate worse, not better.
    """
    R = poses[:, :3, :3]                       # (F, 3, 3)
    t = poses[:, :3, 3]                        # (F, 3)
    pc = jnp.einsum("fij,lj->fli", R, points) + t[:, None, :]  # (F, L, 3)
    x, y = pc[..., 0], pc[..., 1]
    z = jnp.where(jnp.abs(pc[..., 2]) > 1e-6, pc[..., 2], 1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy = cam.fx, cam.fy
    u = fx * x * iz + cam.cx
    v = fy * y * iz + cam.cy
    stereo = obs_ur is not None

    zeros = jnp.zeros_like(z)
    rows = [u - obs_uv[..., 0], v - obs_uv[..., 1]]
    jrows = [
        jnp.stack([fx * iz, zeros, -fx * x * iz2], axis=-1),
        jnp.stack([zeros, fy * iz, -fy * y * iz2], axis=-1),
    ]
    if stereo:
        wr = obs_r_mask.astype(jnp.float32)
        rows.append((u - cam.bf * iz - obs_ur) * wr)
        # d(u_R)/dpc = d(u)/dpc + bf/z^2 * dz/dpc,  dz/dpc = (0, 0, 1)
        jrows.append(
            jnp.stack([fx * iz, zeros, -fx * x * iz2 + cam.bf * iz2], axis=-1)
            * wr[..., None]
        )
    r = jnp.stack(rows, axis=-1)               # (F, L, C)

    w_geom = obs_mask.astype(jnp.float32) * (z > 0.05)
    r2 = jnp.sum(r * r, axis=-1)
    w = w_geom * huber_weights(r2, huber_delta)
    d = huber_delta
    rho = jnp.where(r2 <= d * d, r2, 2.0 * d * jnp.sqrt(jnp.maximum(r2, 1e-12)) - d * d)
    cost = jnp.sum(w_geom * rho)

    # d(residual)/d(camera-point), (F, L, C, 3)
    duv_dpc = jnp.stack(jrows, axis=-2)
    # pose twist [rho, phi], left-multiplied update: dpc/dxi = [I, -hat(pc)]
    hat_pc = lie.hat(pc)                       # (F, L, 3, 3)
    dpc_dxi = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3), pc.shape[:-1] + (3, 3)), -hat_pc], axis=-1
    )                                          # (F, L, 3, 6)
    Jc = jnp.einsum("flij,fljk->flik", duv_dpc, dpc_dxi)  # (F, L, C, 6)
    # dpc/dX = R  ->  Jp = duv_dpc @ R
    Jp = jnp.einsum("flij,fjk->flik", duv_dpc, R)         # (F, L, C, 3)
    return r, w, Jc, Jp, cost


@f32_geometry
def build_normal_equations(
    poses, points, obs_uv, obs_mask, cam: Camera, huber_delta: float,
    obs_ur=None, obs_r_mask=None,
) -> NormalEq:
    r, w, Jc, Jp, cost = _residual_and_jacobians(
        poses, points, obs_uv, obs_mask, cam, huber_delta, obs_ur, obs_r_mask
    )
    Jc_w = Jc * w[..., None, None]
    Hcc = jnp.einsum("flia,flib->fab", Jc_w, Jc)          # (F, 6, 6)
    Hpp = jnp.einsum("flia,flib->lab", Jp * w[..., None, None], Jp)  # (L, 3, 3)
    Hcp = jnp.einsum("flia,flib->flab", Jc_w, Jp)         # (F, L, 6, 3)
    gc = jnp.einsum("flia,fli->fa", Jc_w, r)              # (F, 6)
    gp = jnp.einsum("flia,fli->la", Jp * w[..., None, None], r)      # (L, 3)
    return NormalEq(Hcc=Hcc, Hcp=Hcp, Hpp=Hpp, gc=gc, gp=gp, cost=cost)


def _damp(H: jax.Array, lam: jax.Array) -> jax.Array:
    """Multiplicative LM damping on the block diagonal: H + lam*diag(H)."""
    n = H.shape[-1]
    diag = jnp.diagonal(H, axis1=-2, axis2=-1)
    return H + lam * jnp.eye(n, dtype=H.dtype) * (diag[..., None, :] + 1e-6)


@f32_geometry
def schur_solve(
    eq: NormalEq, lam: jax.Array, point_valid: jax.Array, fix_first_pose: bool = True
) -> tuple[jax.Array, jax.Array]:
    """Reduced-camera-system solve. Returns (dx_c (F, 6), dx_p (L, 3))."""
    F = eq.Hcc.shape[0]
    pv = point_valid.astype(jnp.float32)

    # damped, validity-masked landmark blocks (invalid -> identity, zero rhs)
    Hpp_d = _damp(eq.Hpp, lam)
    Hpp_d = jnp.where(pv[:, None, None] > 0, Hpp_d, jnp.eye(3)[None])
    Hpp_inv = jnp.linalg.inv(Hpp_d)                        # (L, 3, 3)
    Hpp_inv = Hpp_inv * pv[:, None, None]

    # S = Hcc + damping - sum_l Hcp Hpp^-1 Hcp'
    W = jnp.einsum("flab,lbc->flac", eq.Hcp, Hpp_inv)      # (F, L, 6, 3)
    S_blocks = jnp.einsum("flac,glbc->fgab", W, eq.Hcp)    # (F, F, 6, 6)
    Hcc_d = _damp(eq.Hcc, lam)
    S = -S_blocks
    S = S.at[jnp.arange(F), jnp.arange(F)].add(Hcc_d)
    rhs = eq.gc - jnp.einsum("flac,lc->fa", W, eq.gp)      # (F, 6)

    S_flat = S.transpose(0, 2, 1, 3).reshape(F * 6, F * 6)
    rhs_flat = rhs.reshape(F * 6)
    if fix_first_pose:
        prior = jnp.zeros(F * 6).at[:6].set(_GAUGE_PRIOR)
        S_flat = S_flat + jnp.diag(prior)
    dx_c = -jnp.linalg.solve(S_flat, rhs_flat).reshape(F, 6)

    # back-substitute landmarks: dx_p = -Hpp^-1 (gp + Hcp' dx_c)
    gp_eff = eq.gp + jnp.einsum("flab,fa->lb", eq.Hcp, dx_c)
    dx_p = -jnp.einsum("lab,lb->la", Hpp_inv, gp_eff)
    return dx_c, dx_p


@f32_geometry
def local_ba(
    poses: jax.Array,
    points: jax.Array,
    obs_uv: jax.Array,
    obs_mask: jax.Array,
    point_valid: jax.Array,
    cam: Camera,
    cfg: BAConfig,
    fix_first_pose: bool = True,
    obs_ur: jax.Array | None = None,
    obs_r_mask: jax.Array | None = None,
) -> LocalBAResult:
    """LM loop over Schur-complement steps.  All shapes static:
    poses (F,4,4), points (L,3), obs_uv (F,L,2), obs_mask (F,L),
    point_valid (L,).  ``obs_ur``/``obs_r_mask`` (F,L) add per-observation
    stereo edges (see _residual_and_jacobians)."""
    obs_mask = obs_mask & point_valid[None, :]

    def total_cost(po, pt):
        eq_cost = _residual_and_jacobians(
            po, pt, obs_uv, obs_mask, cam, cfg.huber_delta, obs_ur, obs_r_mask
        )[4]
        return eq_cost

    def step(carry, _):
        po, pt, lam, cost = carry
        eq = build_normal_equations(
            po, pt, obs_uv, obs_mask, cam, cfg.huber_delta,
            obs_ur=obs_ur, obs_r_mask=obs_r_mask,
        )
        dx_c, dx_p = schur_solve(eq, lam, point_valid, fix_first_pose)
        po_new = jax.vmap(lambda d, T: lie.se3_exp(d) @ T)(dx_c, po)
        pt_new = pt + dx_p
        new_cost = total_cost(po_new, pt_new)
        accept = new_cost < cost
        po = jnp.where(accept, po_new, po)
        pt = jnp.where(accept, pt_new, pt)
        lam = jnp.clip(
            jnp.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up), 1e-9, 1e6
        )
        cost = jnp.where(accept, new_cost, cost)
        return (po, pt, lam, cost), None

    cost0 = total_cost(poses, points)
    (po, pt, _, cost), _ = jax.lax.scan(
        step,
        (poses, points, jnp.float32(cfg.init_lambda), cost0),
        None,
        length=cfg.local_iterations,
    )
    return LocalBAResult(poses=po, points=pt, cost=cost)
