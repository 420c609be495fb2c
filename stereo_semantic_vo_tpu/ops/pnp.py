"""RANSAC PnP with a fixed batch of vmapped hypotheses.

The reference calls cv::solvePnPRansac(iterations=100, reproj=8.0 px,
conf=0.99) per frame (pnpmatch.cc:227) — a sequential hypothesis loop.  The
This design evaluates ``num_hypotheses`` minimal DLT solves *in
parallel* (a vmapped batch of 12x12 eigenproblems) and scores every
hypothesis against every correspondence at once — a (B, K) reprojection
tensor — then polishes the argmax-inlier hypothesis with the same LM used by
motion-only BA.  Deterministic PRNG seeds make runs reproducible.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_semantic_vo_tpu.core import lie
from stereo_semantic_vo_tpu.core.camera import Camera
from stereo_semantic_vo_tpu.core.config import BAConfig, PnPConfig
from stereo_semantic_vo_tpu.ops import ba as ba_ops
from stereo_semantic_vo_tpu.core.precision import f32_geometry


class PnPResult(NamedTuple):
    T_cw: jax.Array        # (4, 4) world->camera
    inlier_mask: jax.Array  # (K,)
    n_inliers: jax.Array   # ()
    ok: jax.Array          # () bool — enough inliers to trust the pose


def _sample_indices(key: jax.Array, valid: jax.Array, B: int, S: int) -> jax.Array:
    """(B, S) indices of valid correspondences via Gumbel top-k (distinct
    within a hypothesis; masked entries never selected when >= S are valid)."""
    K = valid.shape[0]
    g = jax.random.gumbel(key, (B, K))
    scores = jnp.where(valid[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(scores, S)
    return idx


def smallest_eigvec(M: jax.Array, iters: int = 8) -> jax.Array:
    """Eigenvector of the smallest eigenvalue of a small PSD matrix by
    shifted inverse iteration (one Cholesky + ``iters`` triangular solves).

    Batch-friendly replacement for full eigh: batched 12x12 QR-iteration eigh
    dominated the RANSAC hypothesis batch (~9 ms); this runs in a fraction of
    that and vmaps cleanly.
    """
    n = M.shape[-1]
    shift = 1e-6 * jnp.trace(M) / n + 1e-12
    A = M + shift * jnp.eye(n, dtype=M.dtype)
    cho = jax.scipy.linalg.cho_factor(A)
    x = jnp.full((n,), 1.0 / jnp.sqrt(jnp.float32(n)), M.dtype)

    def body(x, _):
        y = jax.scipy.linalg.cho_solve(cho, x)
        return y / jnp.maximum(jnp.linalg.norm(y), 1e-30), None

    x, _ = jax.lax.scan(body, x, None, length=iters)
    return x


def _dlt_pose(Xs: jax.Array, xs: jax.Array) -> jax.Array:
    """Minimal DLT: S world points (S, 3) + normalized image points (S, 2)
    -> 3x4 projective pose [M | t], sign-fixed so sample depths are positive.

    Solved as the A^T A nullspace via :func:`smallest_eigvec`, with
    Hartley-style normalization of the WORLD side first: raw scene
    coordinates span ~1 (homogeneous) to ~70 (far-field meters), so the
    unnormalized A^T A is conditioned like (70^2)^2 ~ 2e7 — past what f32
    inverse iteration resolves, and the dominant source of backend-dependent
    hypothesis garbage at large per-frame motion (round-5 native-10 Hz
    debugging: identical consensus sets, CPU pose off by 1 m).  Centering +
    RMS-sqrt(3) scaling is the textbook conditioning fix; the pose is
    denormalized exactly afterwards.
    """
    S = Xs.shape[0]
    c = jnp.mean(Xs, axis=0)
    rms = jnp.sqrt(jnp.mean(jnp.sum((Xs - c) ** 2, axis=-1)) + 1e-12)
    s = jnp.sqrt(3.0) / jnp.maximum(rms, 1e-6)
    Xn = (Xs - c) * s
    ones = jnp.ones((S, 1), Xs.dtype)
    Xh_n = jnp.concatenate([Xn, ones], axis=1)  # (S, 4) normalized
    zeros = jnp.zeros_like(Xh_n)
    u = xs[:, 0:1]
    v = xs[:, 1:2]
    rows_u = jnp.concatenate([Xh_n, zeros, -u * Xh_n], axis=1)  # (S, 12)
    rows_v = jnp.concatenate([zeros, Xh_n, -v * Xh_n], axis=1)
    A = jnp.concatenate([rows_u, rows_v], axis=0)  # (2S, 12)
    M = A.T @ A
    p = smallest_eigvec(M)
    Pn = p.reshape(3, 4)
    # denormalize: X_n = s (X - c)  =>  P = Pn @ [[s I, -s c], [0, 1]]
    N4 = jnp.concatenate(
        [
            jnp.concatenate([s * jnp.eye(3, dtype=Xs.dtype), (-s * c)[:, None]], axis=1),
            jnp.array([[0.0, 0.0, 0.0, 1.0]], Xs.dtype),
        ],
        axis=0,
    )
    P = Pn @ N4
    # fix sign: majority of sample depths positive
    Xh = jnp.concatenate([Xs, ones], axis=1)
    depth = (Xh @ P[2])[..., None]
    sign = jnp.where(jnp.sum(jnp.sign(depth)) >= 0, 1.0, -1.0)
    # fix scale so that ||M3 rows|| ~ rotation (unit scale)
    M3 = P[:, :3] * sign
    scale = jnp.cbrt(jnp.abs(jnp.linalg.det(M3)) + 1e-12)
    return P * sign / scale


def _project_P(P: jax.Array, X: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Project (K, 3) world points with a 3x4 projective pose (normalized cam)."""
    Xh = jnp.concatenate([X, jnp.ones((X.shape[0], 1), X.dtype)], axis=1)
    pr = Xh @ P.T  # (K, 3)
    z = pr[:, 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
    return pr[:, :2] / safe_z[:, None], z


def _P_to_T(P: jax.Array) -> jax.Array:
    """Orthonormalize the projective pose into a rigid SE(3) transform."""
    M3 = P[:, :3]
    U, s, Vt = jnp.linalg.svd(M3)
    d = jnp.linalg.det(U @ Vt)
    R = U @ jnp.diag(jnp.array([1.0, 1.0, 1.0]) * jnp.array([1.0, 1.0, d])) @ Vt
    scale = jnp.mean(s)
    t = P[:, 3] / jnp.maximum(scale, 1e-9)
    return lie.rt_to_T(R, t)


@f32_geometry
def ransac_pnp(
    X_w: jax.Array,
    uv: jax.Array,
    valid: jax.Array,
    cam: Camera,
    cfg: PnPConfig,
    key: jax.Array | None = None,
    refine_cfg: BAConfig | None = None,
    T_seed: jax.Array | None = None,
    ur: jax.Array | None = None,
    ur_mask: jax.Array | None = None,
) -> PnPResult:
    """Estimate T_cw from (K, 3) world points and (K, 2) pixel observations.

    All shapes static; invalid correspondences are masked throughout.
    ``T_seed`` (optional 4x4) injects a motion-model prediction as hypothesis
    0 — the constant-velocity seeding the reference computes but leaves
    commented out (Tracking.cc:99-106, pnpmatch.cc:53), resurrected here
    because it costs nothing in the batched design.
    """
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    K = X_w.shape[0]
    B, S = cfg.num_hypotheses, cfg.sample_size

    # normalized image coordinates (undo intrinsics once)
    xn = jnp.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], axis=-1
    )

    idx = _sample_indices(key, valid, B, S)          # (B, S)
    Xs = X_w[idx]                                     # (B, S, 3)
    xs = xn[idx]                                      # (B, S, 2)
    Ps = jax.vmap(_dlt_pose)(Xs, xs)                  # (B, 3, 4)
    if T_seed is not None:
        Ps = Ps.at[0].set(T_seed[:3, :])

    proj, z = jax.vmap(_project_P, in_axes=(0, None))(Ps, X_w)  # (B, K, 2), (B, K)
    # reprojection error in pixels
    err = jnp.stack([proj[..., 0] * cam.fx, proj[..., 1] * cam.fy], axis=-1) - jnp.stack(
        [xn[:, 0] * cam.fx, xn[:, 1] * cam.fy], axis=-1
    )[None]
    e2 = jnp.sum(err * err, axis=-1)                  # (B, K)
    inl = valid[None, :] & (e2 < cfg.inlier_px**2) & (z > 0.05)
    counts = jnp.sum(inl, axis=1)                     # (B,)
    if T_seed is not None and cfg.seed_bonus > 0:
        # prior preference: a sampled hypothesis must beat the motion-model
        # seed by a real margin — under degenerate geometry many poses tie
        # within noise and bare argmax picks arbitrarily among them
        counts = counts.at[0].add(cfg.seed_bonus)
    best = jnp.argmax(counts)
    T0 = _P_to_T(Ps[best])
    best_inl = inl[best]

    rcfg = refine_cfg or BAConfig(iterations=cfg.refine_iters)
    res = ba_ops.motion_only_ba(
        T0, X_w, uv, best_inl, cam, rcfg, use_huber=False,
        ur=ur, ur_mask=ur_mask,
    )

    # recount inliers at the refined pose
    r, zf = ba_ops.reprojection_residuals(res.T_cw, X_w, uv, cam)
    e2f = jnp.sum(r * r, axis=-1)
    final_inl = valid & (e2f < cfg.inlier_px**2) & (zf > 0.05)
    # fall back to the unrefined hypothesis if refinement diverged
    use_refined = jnp.sum(final_inl) >= jnp.sum(best_inl)
    T = jnp.where(use_refined, res.T_cw, T0)
    inl_out = jnp.where(use_refined, final_inl, best_inl)
    n_out = jnp.sum(inl_out)
    # ok judges the pose actually returned — not the refined candidate's
    # count, which understates a healthy unrefined consensus
    ok = n_out >= cfg.min_inliers
    return PnPResult(T_cw=T, inlier_mask=inl_out, n_inliers=n_out, ok=ok)
