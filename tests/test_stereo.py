import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.signal import convolve2d

from stereo_semantic_vo_tpu.core import Camera, CameraConfig
from stereo_semantic_vo_tpu.core.config import StereoConfig
from stereo_semantic_vo_tpu.ops.stereo import sparse_disparity

CFG = StereoConfig()
CAM = Camera.from_config(CameraConfig())


def textured(seed, H=200, W=400):
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    return convolve2d(img, np.ones((3, 3)) / 9.0, mode="same").astype(np.float32)


def grid_keypoints(H, W, step=20, xmargin=80, ymargin=20):
    # x margin must cover the full disparity search strip (D + r)
    ys, xs = np.mgrid[ymargin : H - ymargin : step, xmargin : W - xmargin : step]
    uv = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float32)
    return uv


class TestSparseDisparity:
    def test_constant_shift(self):
        d_true = 12
        left = textured(0)
        right = np.roll(left, -d_true, axis=1)  # x_r = x_l - d
        uv = grid_keypoints(*left.shape)
        m = sparse_disparity(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv),
            jnp.ones(len(uv), bool), CAM, CFG,
        )
        valid = np.asarray(m.valid)
        assert valid.mean() > 0.8
        err = np.abs(np.asarray(m.disparity)[valid] - d_true)
        assert np.median(err) < 0.5
        # depth consistency
        z = np.asarray(m.depth)[valid]
        np.testing.assert_allclose(
            np.median(z), float(CAM.bf) / d_true, rtol=0.1
        )

    def test_two_plane_scene(self):
        left = textured(1)
        H, W = left.shape
        right = np.empty_like(left)
        right[: H // 2] = np.roll(left[: H // 2], -6, axis=1)
        right[H // 2 :] = np.roll(left[H // 2 :], -30, axis=1)
        uv = grid_keypoints(H, W)
        m = sparse_disparity(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv),
            jnp.ones(len(uv), bool), CAM, CFG,
        )
        valid = np.asarray(m.valid)
        disp = np.asarray(m.disparity)
        top = valid & (uv[:, 1] < H // 2 - 10)
        bot = valid & (uv[:, 1] > H // 2 + 10)
        assert abs(np.median(disp[top]) - 6) < 1.0
        assert abs(np.median(disp[bot]) - 30) < 1.0

    def test_flat_image_invalid(self):
        left = np.full((200, 400), 100.0, np.float32)
        uv = grid_keypoints(200, 400)
        m = sparse_disparity(
            jnp.asarray(left), jnp.asarray(left), jnp.asarray(uv),
            jnp.ones(len(uv), bool), CAM, CFG,
        )
        assert np.asarray(m.valid).mean() < 0.1

    def test_jit_fixed_shape(self):
        left = textured(2)
        right = np.roll(left, -8, axis=1)
        uv = grid_keypoints(*left.shape)
        f = jax.jit(
            lambda l, r, u, v: sparse_disparity(l, r, u, v, CAM, CFG)
        )
        m = f(jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv), jnp.ones(len(uv), bool))
        assert m.disparity.shape == (len(uv),)

    def test_invalid_keypoints_propagate(self):
        left = textured(3)
        right = np.roll(left, -8, axis=1)
        uv = grid_keypoints(*left.shape)
        kv = jnp.zeros(len(uv), bool)
        m = sparse_disparity(jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv), kv, CAM, CFG)
        assert not bool(m.valid.any())


class TestSparseModes:
    """The two whole-XLA sparse forms (StereoConfig.sparse_mode) compute the
    same window cost: per-keypoint strips and the whole-image shifted-map
    volume must agree on validity and sub-pixel disparity away from the
    image edges (where the volume's wrapped shifts and zero-padded box
    filter differ from the strips' clamped windows by design)."""

    @pytest.mark.parametrize("d_true,seed", [(5, 4), (12, 5), (30, 6)])
    def test_strips_match_volume(self, d_true, seed):
        left = textured(seed)
        right = np.roll(left, -d_true, axis=1)
        uv = grid_keypoints(*left.shape)
        args = (jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv),
                jnp.ones(len(uv), bool), CAM)
        a = sparse_disparity(*args, StereoConfig(sparse_mode="strips"))
        b = sparse_disparity(*args, StereoConfig(sparse_mode="volume"))
        np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
        va = np.asarray(a.valid)
        assert va.mean() > 0.8
        # float32 sums in another order: sub-pixel interpolation noise only
        np.testing.assert_allclose(
            np.asarray(a.disparity)[va], np.asarray(b.disparity)[va], atol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(a.cost)[va], np.asarray(b.cost)[va], rtol=1e-4
        )
