"""SO(3)/SE(3) Lie-group operations as pure JAX functions.

Replaces the reference's g2o `SE3Quat` exp/log (Thirdparty/g2o/g2o/types/
se3quat.h) and the cv::Mat pose plumbing in src/convert.cc with batched,
differentiable, jit-friendly tensor ops.  Everything is written to vmap
cleanly so RANSAC hypotheses and BA residuals can be evaluated for thousands
of poses at once.

Conventions: poses are 4x4 row-major world->camera transforms ``Tcw`` unless
noted, matching the reference (frame.cc:66-73 maintains Tcw plus cached
inverses).  Twists are (6,) vectors ``[rho, phi]`` = [translation, rotation],
the g2o ordering used by its SE3 exp map.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(phi: jax.Array) -> jax.Array:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(Phi: jax.Array) -> jax.Array:
    """Inverse of :func:`hat`."""
    return jnp.stack([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]], axis=-1)


def so3_exp(phi: jax.Array) -> jax.Array:
    """Rodrigues' formula: (..., 3) axis-angle -> (..., 3, 3) rotation.

    Taylor-guarded near zero so it is safe under jit/grad.
    """
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    K = hat(phi)
    KK = K @ K
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a * K + b * KK


def so3_log(R: jax.Array) -> jax.Array:
    """(..., 3, 3) rotation -> (..., 3) axis-angle, guarded near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5   # = sin(theta) * axis
    sin_theta = jnp.sin(theta)
    small = theta[..., None] < 1e-6
    scale = jnp.where(
        small,
        1.0 + theta[..., None] ** 2 / 6.0,
        theta[..., None] / jnp.maximum(sin_theta[..., None], _EPS),
    )
    # near pi the above is ill-conditioned; fall back to diagonal extraction
    near_pi = theta[..., None] > 3.0
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis_sq = jnp.maximum((diag - cos_theta[..., None]) / jnp.maximum(1.0 - cos_theta[..., None], _EPS), 0.0)
    axis = jnp.sqrt(axis_sq)
    # sign from the off-diagonal skew part (or +1 where it vanishes)
    axis = axis * jnp.where(w >= 0, 1.0, -1.0)
    pi_branch = axis * theta[..., None]
    return jnp.where(near_pi, pi_branch, w * scale)


def _so3_left_jacobian(phi: jax.Array) -> jax.Array:
    """Left Jacobian J_l of SO(3) — couples rotation and translation in SE(3) exp."""
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    K = hat(phi)
    KK = K @ K
    small = theta2 < 1e-8
    a = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    b = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a * K + b * KK


def se3_exp(xi: jax.Array) -> jax.Array:
    """se(3) exponential: (..., 6) twist [rho, phi] -> (..., 4, 4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return rt_to_T(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """(..., 4, 4) -> (..., 6) twist [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    Jl = _so3_left_jacobian(phi)
    rho = jnp.linalg.solve(Jl, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def rt_to_T(R: jax.Array, t: jax.Array) -> jax.Array:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def T_inv(T: jax.Array) -> jax.Array:
    """Closed-form inverse of a rigid transform (cheaper + stabler than solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_T(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply (..., 4, 4) to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def rotation_to_quaternion(R: jax.Array) -> jax.Array:
    """(3, 3) -> (4,) quaternion [qx, qy, qz, qw], TUM trajectory ordering.

    Mirrors convert::toQuaternion (src/convert.cc:76-88) which feeds the TUM
    writer at Tracking.cc:129-130.  Shepperd's method, branch-free via argmax.
    """
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def case_w(_):
        s = jnp.sqrt(jnp.maximum(tr + 1.0, _EPS)) * 2.0
        return jnp.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s])

    def case_x(_):
        s = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) * 2.0
        return jnp.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s])

    def case_y(_):
        s = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, _EPS)) * 2.0
        return jnp.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s])

    def case_z(_):
        s = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, _EPS)) * 2.0
        return jnp.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s])

    diag = jnp.stack([m00, m11, m22])
    use_w = tr > 0.0
    branch = jnp.where(use_w, 0, jnp.argmax(diag) + 1)
    q = jax.lax.switch(branch, [case_w, case_x, case_y, case_z], None)
    return q / jnp.linalg.norm(q)


def quaternion_to_rotation(q: jax.Array) -> jax.Array:
    """(4,) [qx, qy, qz, qw] -> (3, 3)."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    n = x * x + y * y + z * z + w * w
    s = jnp.where(n > _EPS, 2.0 / n, 0.0)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return jnp.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )
