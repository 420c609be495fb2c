"""Bundle adjustment as batched Levenberg-Marquardt in pure JAX.

Replaces the reference's g2o motion-only BA (src/Optimizer.cc:15-86: one
VertexSE3Expmap, one monocular EdgeSE3ProjectXYZOnlyPose per matched map
point, Huber delta=sqrt(5.991), dense 6x6 solve, LM, 10 iterations) with a
``lax.scan`` over LM steps.  All residuals and Jacobians for the whole
keypoint set are evaluated in one fused pass; the normal equations are a
single 6x6 solve.  Everything vmaps, so RANSAC hypothesis refinement and
multi-frame local BA reuse the same pieces.

Local BA (poses + landmarks, Schur complement on the landmark diagonal) lives
in ops/local_ba.py; the distributed version in parallel/sharded_ba.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_semantic_vo_tpu.core import lie
from stereo_semantic_vo_tpu.core.camera import Camera
from stereo_semantic_vo_tpu.core.config import BAConfig
from stereo_semantic_vo_tpu.core.precision import f32_geometry


class BAResult(NamedTuple):
    T_cw: jax.Array        # (4, 4) optimized world->camera pose
    cost: jax.Array        # () final robust cost
    inlier_mask: jax.Array  # (K,) chi2 <= 5.991 at the final pose
    n_iters: jax.Array     # () iterations actually accepted


def reprojection_residuals(
    T_cw: jax.Array, X_w: jax.Array, uv: jax.Array, cam: Camera
) -> tuple[jax.Array, jax.Array]:
    """(K, 2) pixel residuals and (K,) camera-frame depths."""
    pc = lie.transform_points(T_cw, X_w)
    z = pc[..., 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-6, z, 1e-6)
    u = cam.fx * pc[..., 0] / safe_z + cam.cx
    v = cam.fy * pc[..., 1] / safe_z + cam.cy
    return jnp.stack([u, v], axis=-1) - uv, z


def huber_weights(r2: jax.Array, delta: float) -> jax.Array:
    """IRLS weights for the Huber loss on squared residual norms r2."""
    r = jnp.sqrt(jnp.maximum(r2, 1e-12))
    return jnp.where(r <= delta, 1.0, delta / r)


def _pose_jacobian(T_cw: jax.Array, X_w: jax.Array, cam: Camera) -> jax.Array:
    """Analytic d(residual)/d(twist) for a left-multiplied update
    T <- exp(xi) T, xi = [rho, phi].  Returns (K, 2, 6).

    Same 2x6 block g2o hardcodes (types_six_dof_expmap.cpp:266-288), derived
    once here and evaluated for all points in parallel.
    """
    pc = lie.transform_points(T_cw, X_w)  # (K, 3)
    x, y = pc[..., 0], pc[..., 1]
    z = jnp.where(jnp.abs(pc[..., 2]) > 1e-6, pc[..., 2], 1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy = cam.fx, cam.fy
    # du/d[t, w], dv/d[t, w] with p_cam = exp(xi) applied on camera-frame point
    du = jnp.stack(
        [fx * iz, jnp.zeros_like(z), -fx * x * iz2,
         -fx * x * y * iz2, fx * (1.0 + x * x * iz2), -fx * y * iz],
        axis=-1,
    )
    dv = jnp.stack(
        [jnp.zeros_like(z), fy * iz, -fy * y * iz2,
         -fy * (1.0 + y * y * iz2), fy * x * y * iz2, fy * x * iz],
        axis=-1,
    )
    return jnp.stack([du, dv], axis=-2)


@f32_geometry
def motion_only_ba(
    T0_cw: jax.Array,
    X_w: jax.Array,
    uv: jax.Array,
    mask: jax.Array,
    cam: Camera,
    cfg: BAConfig,
    use_huber: bool = True,
    ur: jax.Array | None = None,
    ur_mask: jax.Array | None = None,
) -> BAResult:
    """Pose-only LM over masked reprojection residuals.

    T0_cw: (4, 4) initial pose; X_w: (K, 3); uv: (K, 2); mask: (K,) bool.

    ``ur``/``ur_mask`` (K,) add a per-observation STEREO residual row
    u_R = u - bf/z (the g2o EdgeStereoSE3ProjectXYZOnlyPose analogue;
    the reference's pose optimizer is mono-only, Optimizer.cc:42-74).
    Without it, a consensus dominated by far-field points leaves
    translation-along-depth near-unconstrained — at native 10 Hz motion a
    pose can satisfy every 8 px mono gate while being >1.5 m off
    (docs/ACCURACY.md "Native 10 Hz"); the stereo row pins that axis with
    the current frame's own disparity measurements.  The final inlier
    classification stays mono (reference chi2 semantics).

    When ``cfg.trim_px > 0`` the optimization is *trimmed*: observations whose
    residual at the seed pose exceeds trim_px are masked out, so the LM
    solves on the seed's consensus set.  This is the classify->optimize
    outlier handling of ORB-SLAM-style pose optimization that the
    reference's single ``optimize(10)`` pass (src/Optimizer.cc:75-76) lacks
    — without it a contaminated match set (gate-only matching has no
    guided-search prior) can drag the Huber cost basin off the consensus
    pose.  Classification happens once at the seed (a RANSAC-refined pose,
    so its inlier geometry is already trustworthy); an in-scan
    reclassification branch was measured to multiply XLA compile time ~7x
    for negligible accuracy difference.
    """
    chi2_th = cfg.huber_delta**2
    trim_on = use_huber and cfg.trim_px > 0.0
    m = mask.astype(jnp.float32)
    if trim_on:
        r0, z0 = reprojection_residuals(T0_cw, X_w, uv, cam)
        close0 = jnp.sum(r0 * r0, axis=-1) <= cfg.trim_px**2
        m = m * close0 * (z0 > 0.05)
    stereo = ur is not None
    if stereo:
        urm = (
            ur_mask.astype(jnp.float32)
            if ur_mask is not None
            else jnp.ones_like(ur)
        )


    def stereo_residual(T):
        """(K,) stereo-row residual (u_R pred - u_R obs) * mask, masked."""
        pc = lie.transform_points(T, X_w)
        z = jnp.where(jnp.abs(pc[..., 2]) > 1e-6, pc[..., 2], 1e-6)
        u_pred = cam.fx * pc[..., 0] / z + cam.cx
        return (u_pred - cam.bf / z - ur) * urm

    def robust_cost(T, mw):
        r, z = reprojection_residuals(T, X_w, uv, cam)
        w_geom = mw * (z > 0.05)
        r2 = jnp.sum(r * r, axis=-1)
        if stereo:
            rs = stereo_residual(T)
            r2 = r2 + rs * rs
        if use_huber:
            d = cfg.huber_delta
            rho = jnp.where(r2 <= d * d, r2, 2.0 * d * jnp.sqrt(jnp.maximum(r2, 1e-12)) - d * d)
        else:
            rho = r2
        return jnp.sum(w_geom * rho), (r, w_geom, r2)

    def step(carry, _):
        # the trim mask m is classified once at the seed and closed over —
        # it is loop-invariant, so it rides the trace, not the carry
        T, lam, cost = carry
        _, (r, w_geom, r2) = robust_cost(T, m)
        w = w_geom * (huber_weights(r2, cfg.huber_delta) if use_huber else 1.0)
        J = _pose_jacobian(T, X_w, cam)                   # (K, 2, 6)
        Jw = J * w[:, None, None]
        H = jnp.einsum("kif,kig->fg", Jw, J)              # (6, 6)
        g = jnp.einsum("kif,ki->f", Jw, r)                # (6,)
        if stereo:
            # stereo row: d(u_R)/dxi = d(u)/dxi + bf/z^2 * dz/dxi,
            # dz/dxi = [0, 0, 1, py, -px, 0] (left-mult twist)
            pc = lie.transform_points(T, X_w)
            x_, y_ = pc[..., 0], pc[..., 1]
            z_ = jnp.where(jnp.abs(pc[..., 2]) > 1e-6, pc[..., 2], 1e-6)
            b2 = cam.bf / (z_ * z_)
            zero = jnp.zeros_like(z_)
            one = jnp.ones_like(z_)
            dz = jnp.stack([zero, zero, one, y_, -x_, zero], axis=-1)
            Js = (J[:, 0, :] + b2[:, None] * dz) * urm[:, None]
            rs = stereo_residual(T)
            H = H + jnp.einsum("kf,kg->fg", Js * w[:, None], Js)
            g = g + jnp.einsum("kf,k->f", Js * w[:, None], rs)
        Hl = H + lam * jnp.diag(jnp.diagonal(H) + 1e-9)
        delta = -jnp.linalg.solve(Hl, g)
        T_new = lie.se3_exp(delta) @ T
        new_cost, _ = robust_cost(T_new, m)
        accept = new_cost < cost
        T = jnp.where(accept, T_new, T)
        lam = jnp.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up)
        lam = jnp.clip(lam, 1e-9, 1e6)
        cost = jnp.where(accept, new_cost, cost)
        return (T, lam, cost), accept

    cost0, _ = robust_cost(T0_cw, m)
    (T, _, cost), accepts = jax.lax.scan(
        step,
        (T0_cw, jnp.float32(cfg.init_lambda), cost0),
        None,
        length=cfg.iterations,
    )
    r, z = reprojection_residuals(T, X_w, uv, cam)
    r2 = jnp.sum(r * r, axis=-1)
    inliers = mask & (z > 0.05) & (r2 <= chi2_th * 4.0)
    return BAResult(T_cw=T, cost=cost, inlier_mask=inliers, n_iters=jnp.sum(accepts))
