"""Fundamental-matrix estimation and the epipolar moving-object test.

The reference re-detects ORB on both frames, BF-matches, keeps matches
*outside* detection boxes, and fits F with OpenCV's 8-point solver
(pnpmatch.cc:302-337).  Matches that land *inside* a detection box are then
tested against F: a point-to-epipolar-line distance over 0.1 px brands the
map point a moving object and poisons it (mp->bad, pnpmatch.cc:103-144).

Batched version: one normalized least-squares 8-point fit over *all*
masked background matches at once (a 9x9 eigenproblem instead of a RANSAC
loop), hardened with a few IRLS reweighting rounds on the Sampson distance —
the Hamming gate (<15) reduces but does not eliminate gross outliers, and a
single bad background match at full weight would skew F and with it the
0.1 px dynamic-culling verdict.  A batched point-line distance implements
the dynamic test itself.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from stereo_semantic_vo_tpu.core.precision import f32_geometry


def _normalize_points(uv: jax.Array, w: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Hartley normalization (weighted): centroid 0, mean distance sqrt(2)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    mean = jnp.sum(uv * w[:, None], axis=0) / wsum
    d = jnp.sqrt(jnp.sum((uv - mean) ** 2, axis=-1) + 1e-12)
    mean_d = jnp.sum(d * w) / wsum
    s = jnp.sqrt(2.0) / jnp.maximum(mean_d, 1e-6)
    T = jnp.array(
        [[s, 0.0, -s * mean[0]], [0.0, s, -s * mean[1]], [0.0, 0.0, 1.0]],
        uv.dtype,
    )
    uvn = (uv - mean) * s
    return uvn, T


def _fit_fundamental_once(
    uv1: jax.Array, uv2: jax.Array, weight: jax.Array
) -> jax.Array:
    """One weighted normalized 8-point solve (no robustness)."""
    x1, T1 = _normalize_points(uv1, weight)
    x2, T2 = _normalize_points(uv2, weight)
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    ones = jnp.ones_like(u1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=-1
    )  # (K, 9)
    Aw = A * weight[:, None]
    M = Aw.T @ A  # (9, 9)
    from stereo_semantic_vo_tpu.ops.pnp import smallest_eigvec

    f = smallest_eigvec(M)
    F = f.reshape(3, 3)
    # rank-2 projection
    U, s, Vt = jnp.linalg.svd(F)
    F = U @ jnp.diag(s.at[2].set(0.0)) @ Vt
    F = T2.T @ F @ T1
    # scale-normalize for a comparable distance threshold
    return F / jnp.maximum(jnp.abs(F[2, 2]), 1e-9)


def sampson_distance(F: jax.Array, uv1: jax.Array, uv2: jax.Array) -> jax.Array:
    """First-order geometric reprojection error of the epipolar constraint,
    symmetric in both images.  uv1/uv2: (K, 2) -> (K,) pixels."""
    p1 = jnp.concatenate([uv1, jnp.ones_like(uv1[:, :1])], axis=-1)
    p2 = jnp.concatenate([uv2, jnp.ones_like(uv2[:, :1])], axis=-1)
    l2 = p1 @ F.T  # (K, 3): epiline of p1 in image 2
    l1 = p2 @ F   # (K, 3): epiline of p2 in image 1
    e = jnp.sum(p2 * l2, axis=-1)  # p2^T F p1
    den = l2[:, 0] ** 2 + l2[:, 1] ** 2 + l1[:, 0] ** 2 + l1[:, 1] ** 2
    return jnp.abs(e) / jnp.sqrt(den + 1e-12)


@f32_geometry
def fit_fundamental(
    uv1: jax.Array, uv2: jax.Array, weight: jax.Array, irls_iters: int = 3
) -> jax.Array:
    """Robust weighted 8-point fundamental matrix from (K, 2) correspondences.

    ``weight`` masks invalid / in-box matches to zero.  After the initial
    least-squares fit, ``irls_iters`` Cauchy-reweighting rounds on the Sampson
    distance pull gross background outliers out of the solution (the reference
    instead relies on OpenCV's FM_8POINT over ratio-filtered fresh matches,
    pnpmatch.cc:302-337).  Returns F (3, 3) with rank-2 enforcement, mapping
    p1 -> epiline in image 2 (l2 = F @ p1h).
    """
    F = _fit_fundamental_once(uv1, uv2, weight)
    # Cauchy scale: generous vs the 0.1 px culling threshold so legitimate
    # static matches keep ~full weight while multi-pixel outliers are crushed
    c2 = jnp.float32(1.0)  # (1 px)^2
    for _ in range(irls_iters):
        d = sampson_distance(F, uv1, uv2)
        w = weight / (1.0 + (d * d) / c2)
        F = _fit_fundamental_once(uv1, uv2, w)
    return F


def epipolar_distance(F: jax.Array, uv1: jax.Array, uv2: jax.Array) -> jax.Array:
    """Distance of p2 to the epipolar line of p1 (the reference's moving-object
    metric, pnpmatch.cc:110-119). uv1/uv2: (K, 2) -> (K,) pixels."""
    p1 = jnp.concatenate([uv1, jnp.ones_like(uv1[:, :1])], axis=-1)
    l = p1 @ F.T  # (K, 3) lines a,b,c in image 2
    num = jnp.abs(jnp.sum(l[:, :2] * uv2, axis=-1) + l[:, 2])
    den = jnp.sqrt(l[:, 0] ** 2 + l[:, 1] ** 2 + 1e-12)
    return num / den


def fundamental_from_pose(T_21: jax.Array, K: jax.Array) -> jax.Array:
    """F from a relative pose T_21 (cam1 -> cam2) and intrinsics K — the
    calibrated shortcut available once the motion model is trusted."""
    R = T_21[:3, :3]
    t = T_21[:3, 3]
    tx = jnp.array(
        [[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]], T_21.dtype
    )
    E = tx @ R
    Kinv = jnp.linalg.inv(K)
    F = Kinv.T @ E @ Kinv
    return F / jnp.maximum(jnp.abs(F[2, 2]), 1e-9)


def in_box_mask(uv: jax.Array, boxes: jax.Array, box_valid: jax.Array, margin: float) -> jax.Array:
    """(K,) bool: is each pixel inside any detection box grown by ``margin``
    (the reference's +-5 px creation margin / +-10 px matching margin,
    Tracking.cc:61, pnpmatch.cc:108). boxes: (B, 4) [x1, y1, x2, y2]."""
    x, y = uv[:, 0:1], uv[:, 1:2]
    x1 = boxes[None, :, 0] - margin
    y1 = boxes[None, :, 1] - margin
    x2 = boxes[None, :, 2] + margin
    y2 = boxes[None, :, 3] + margin
    inside = (x >= x1) & (x <= x2) & (y >= y1) & (y <= y2)
    return jnp.any(inside & box_valid[None, :], axis=1)
