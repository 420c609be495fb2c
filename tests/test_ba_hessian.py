"""XLA normal-equation builds of motion-only and local BA vs ``jax.jacfwd``.

The analytic Jacobians (ops/ba._pose_jacobian, ops/local_ba.
_residual_and_jacobians) and the blocks built from them must equal the
automatic derivative of the residual functions under the same
left-multiplied twist convention; the full LM loops must converge to the
true pose and landmarks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.core import Camera, CameraConfig, lie
from stereo_semantic_vo_tpu.core.config import BAConfig
from stereo_semantic_vo_tpu.ops import ba as ba_ops
from stereo_semantic_vo_tpu.ops import local_ba

CAM = Camera.from_config(CameraConfig())
DELTA = float(BAConfig().huber_delta)


def _problem(seed=0, K=512, noise=0.4):
    rng = np.random.RandomState(seed)
    X = np.stack(
        [rng.uniform(-20, 20, K), rng.uniform(-5, 5, K), rng.uniform(5, 60, K)],
        axis=-1,
    ).astype(np.float32)
    T_true = np.asarray(
        lie.se3_exp(jnp.asarray([0.3, -0.1, 0.5, 0.02, -0.03, 0.01], jnp.float32))
    )
    pc = X @ T_true[:3, :3].T + T_true[:3, 3]
    u = float(CAM.fx) * pc[:, 0] / pc[:, 2] + float(CAM.cx)
    v = float(CAM.fy) * pc[:, 1] / pc[:, 2] + float(CAM.cy)
    uv = np.stack([u, v], axis=-1).astype(np.float32)
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    ur = (u - float(CAM.bf) / pc[:, 2]).astype(np.float32)
    mask = (pc[:, 2] > 0.5) & (rng.rand(K) > 0.1)
    return (jnp.asarray(X), jnp.asarray(uv), jnp.asarray(mask),
            jnp.asarray(T_true), jnp.asarray(ur))


def _window(seed, F, L, stereo):
    rng = np.random.RandomState(seed)
    X = np.stack(
        [rng.uniform(-15, 15, L), rng.uniform(-4, 4, L), rng.uniform(8, 50, L)],
        axis=-1,
    ).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * F)
    for f in range(F):
        poses[f][0, 3] = -0.8 * f
        poses[f][2, 3] = 0.3 * f
    pc = np.einsum("fij,lj->fli", poses[:, :3, :3], X) + poses[:, None, :3, 3]
    u = float(CAM.fx) * pc[..., 0] / pc[..., 2] + float(CAM.cx)
    v = float(CAM.fy) * pc[..., 1] / pc[..., 2] + float(CAM.cy)
    obs = np.stack([u, v], axis=-1).astype(np.float32)
    obs += rng.normal(0, 1.5, obs.shape).astype(np.float32)
    mask = (pc[..., 2] > 0.5) & (rng.rand(F, L) > 0.2)
    ur = rmask = None
    if stereo:
        ur = jnp.asarray((u - float(CAM.bf) / pc[..., 2]
                          + rng.normal(0, 0.8, u.shape)).astype(np.float32))
        rmask = jnp.asarray(mask & (rng.rand(F, L) > 0.3))
    return (jnp.asarray(poses), jnp.asarray(X), jnp.asarray(obs),
            jnp.asarray(mask), ur, rmask)


def _close(a, b, rtol, name=""):
    # f32 op-order noise scales with the magnitude of the summed terms, not
    # with the (possibly cancelled) entry
    a, b = np.asarray(a), np.asarray(b)
    atol = rtol * max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


class TestMotionBuild:
    def test_pose_jacobian_matches_jacfwd(self):
        X, uv, _, T_true, _ = _problem(K=128)
        T0 = lie.se3_exp(jnp.asarray([0.05, 0.0, -0.04, 0.004, 0.0, -0.003])) @ T_true

        def residual(xi):
            return ba_ops.reprojection_residuals(lie.se3_exp(xi) @ T0, X, uv, CAM)[0]

        J_ref = jax.jacfwd(residual)(jnp.zeros(6, jnp.float32))    # (K, 2, 6)
        _close(ba_ops._pose_jacobian(T0, X, CAM), J_ref, 1e-4)

    def test_normal_equations_match_jacfwd(self):
        """H = J' W J and g = J' W r of the LM step, with J from jacfwd."""
        X, uv, mask, T_true, _ = _problem(seed=1, K=256)
        T0 = lie.se3_exp(jnp.asarray([0.05, 0.0, -0.04, 0.004, 0.0, -0.003])) @ T_true
        r, z = ba_ops.reprojection_residuals(T0, X, uv, CAM)
        w = mask * (z > 0.05) * ba_ops.huber_weights(jnp.sum(r * r, -1), DELTA)
        J = ba_ops._pose_jacobian(T0, X, CAM)
        H = jnp.einsum("kif,kig->fg", J * w[:, None, None], J)
        g = jnp.einsum("kif,ki->f", J * w[:, None, None], r)
        J_ref = jax.jacfwd(
            lambda xi: ba_ops.reprojection_residuals(
                lie.se3_exp(xi) @ T0, X, uv, CAM)[0]
        )(jnp.zeros(6, jnp.float32))
        Jf = J_ref.reshape(-1, 6) * jnp.repeat(w, 2)[:, None]
        _close(H, Jf.T @ J_ref.reshape(-1, 6), 1e-4, "H")
        _close(g, Jf.T @ r.reshape(-1), 1e-4, "g")

    @pytest.mark.parametrize("stereo", [False, True])
    def test_full_ba_converges(self, stereo):
        X, uv, mask, T_true, ur = _problem(seed=3)
        T0 = lie.se3_exp(
            jnp.asarray([0.08, -0.02, -0.06, 0.006, -0.002, 0.004])) @ T_true
        res = ba_ops.motion_only_ba(
            T0, X, uv, mask, CAM, BAConfig(),
            ur=ur if stereo else None, ur_mask=mask if stereo else None,
        )
        np.testing.assert_allclose(np.asarray(res.T_cw), np.asarray(T_true),
                                   atol=5e-3)


class TestLocalBuild:
    @pytest.mark.parametrize("stereo", [False, True])
    def test_jacobians_match_jacfwd(self, stereo):
        F, L = 3, 40
        poses, X, obs, mask, ur, rmask = _window(1, F, L, stereo)

        def residual(xi, dp):
            po = jax.vmap(lambda d, T: lie.se3_exp(d) @ T)(xi, poses)
            return local_ba._residual_and_jacobians(
                po, X + dp, obs, mask, CAM, DELTA, ur, rmask)[0]

        zc = jnp.zeros((F, 6), jnp.float32)
        zp = jnp.zeros((L, 3), jnp.float32)
        dr_dc, dr_dp = jax.jacfwd(residual, argnums=(0, 1))(zc, zp)
        # dr_dc: (F, L, C, F, 6) -> the own-frame block; dr_dp likewise
        f_idx, l_idx = jnp.arange(F), jnp.arange(L)
        Jc_ref = dr_dc[f_idx, :, :, f_idx]                      # (F, L, C, 6)
        Jp_ref = jnp.moveaxis(dr_dp[:, l_idx, :, l_idx], 0, 1)  # (F, L, C, 3)
        _, _, Jc, Jp, _ = local_ba._residual_and_jacobians(
            poses, X, obs, mask, CAM, DELTA, ur, rmask)
        _close(Jc, Jc_ref, 1e-4, "Jc")
        _close(Jp, Jp_ref, 1e-4, "Jp")

    def test_normal_equations_match_jacfwd_blocks(self):
        F, L = 4, 64
        poses, X, obs, mask, ur, rmask = _window(2, F, L, stereo=True)
        eq = local_ba.build_normal_equations(
            poses, X, obs, mask, CAM, DELTA, obs_ur=ur, obs_r_mask=rmask)
        r, w, _, _, cost = local_ba._residual_and_jacobians(
            poses, X, obs, mask, CAM, DELTA, ur, rmask)

        def residual(xi, dp):
            po = jax.vmap(lambda d, T: lie.se3_exp(d) @ T)(xi, poses)
            return local_ba._residual_and_jacobians(
                po, X + dp, obs, mask, CAM, DELTA, ur, rmask)[0]

        dr_dc, dr_dp = jax.jacfwd(residual, argnums=(0, 1))(
            jnp.zeros((F, 6), jnp.float32), jnp.zeros((L, 3), jnp.float32))
        Jc = dr_dc[jnp.arange(F), :, :, jnp.arange(F)]
        Jp = jnp.moveaxis(dr_dp[:, jnp.arange(L), :, jnp.arange(L)], 0, 1)
        ww = w[..., None, None]
        _close(eq.Hcc, jnp.einsum("flia,flib->fab", Jc * ww, Jc), 1e-4, "Hcc")
        _close(eq.Hpp, jnp.einsum("flia,flib->lab", Jp * ww, Jp), 1e-4, "Hpp")
        _close(eq.Hcp, jnp.einsum("flia,flib->flab", Jc * ww, Jp), 1e-4, "Hcp")
        _close(eq.gc, jnp.einsum("flia,fli->fa", Jc * ww, r), 1e-4, "gc")
        _close(eq.gp, jnp.einsum("flia,fli->la", Jp * ww, r), 1e-4, "gp")
        np.testing.assert_allclose(float(eq.cost), float(cost), rtol=1e-6)

    def test_local_ba_converges(self):
        rng = np.random.RandomState(7)
        F, L = 4, 512
        X = np.stack(
            [rng.uniform(-15, 15, L), rng.uniform(-4, 4, L), rng.uniform(8, 50, L)],
            axis=-1,
        ).astype(np.float32)
        poses = np.stack([np.eye(4, dtype=np.float32)] * F)
        for f in range(F):
            poses[f][0, 3] = -0.8 * f
        pc = np.einsum("fij,lj->fli", poses[:, :3, :3], X) + poses[:, None, :3, 3]
        u = float(CAM.fx) * pc[..., 0] / pc[..., 2] + float(CAM.cx)
        v = float(CAM.fy) * pc[..., 1] / pc[..., 2] + float(CAM.cy)
        obs = np.stack([u, v], axis=-1).astype(np.float32)
        mask = pc[..., 2] > 0.5
        X0 = (X + rng.normal(0, 0.15, X.shape)).astype(np.float32)
        res = local_ba.local_ba(
            jnp.asarray(poses), jnp.asarray(X0), jnp.asarray(obs),
            jnp.asarray(mask), jnp.ones(L, bool), CAM,
            BAConfig(local_iterations=8),
        )
        err = np.abs(np.asarray(res.points) - X).max()
        assert err < 0.05, f"landmark error {err}"
