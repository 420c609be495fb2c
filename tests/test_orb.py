import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.core.config import ORBConfig
from stereo_semantic_vo_tpu.kernels import hamming
from stereo_semantic_vo_tpu.ops import orb


def synth_image(key, H=256, W=320, n_squares=30):
    """Black canvas with random bright squares — square corners are FAST corners."""
    img = np.zeros((H, W), np.float32)
    rng = np.random.RandomState(int(jax.random.randint(key, (), 0, 1 << 30)))
    for _ in range(n_squares):
        y = rng.randint(20, H - 40)
        x = rng.randint(20, W - 40)
        s = rng.randint(8, 25)
        img[y : y + s, x : x + s] = rng.uniform(120, 255)
    return jnp.asarray(img)


CFG = ORBConfig(max_keypoints=256, n_levels=4)


class TestFAST:
    def test_detects_square_corners(self):
        img = synth_image(jax.random.PRNGKey(0))
        kp = orb.extract_orb(img, CFG)
        assert int(kp.valid.sum()) > 30
        # all valid keypoints inside the image
        uv = np.asarray(kp.uv)[np.asarray(kp.valid)]
        assert (uv[:, 0] >= 0).all() and (uv[:, 0] < img.shape[1]).all()
        assert (uv[:, 1] >= 0).all() and (uv[:, 1] < img.shape[0]).all()

    def test_blank_image_no_keypoints(self):
        img = jnp.zeros((256, 320), jnp.float32)
        kp = orb.extract_orb(img, CFG)
        assert int(kp.valid.sum()) == 0

    def test_deterministic(self):
        img = synth_image(jax.random.PRNGKey(1))
        kp1 = orb.extract_orb(img, CFG)
        kp2 = orb.extract_orb(img, CFG)
        np.testing.assert_array_equal(kp1.uv, kp2.uv)
        np.testing.assert_array_equal(kp1.desc, kp2.desc)

    def test_fixed_shapes_and_jit(self):
        img = synth_image(jax.random.PRNGKey(2))
        f = jax.jit(lambda im: orb.extract_orb(im, CFG))
        kp = f(img)
        assert kp.uv.shape == (CFG.max_keypoints, 2)
        assert kp.desc.shape == (CFG.max_keypoints, 8)
        assert kp.desc.dtype == jnp.uint32


class TestDescriptors:
    def test_translation_matching(self):
        """Same content shifted by 16px: descriptors should match across images."""
        img = np.asarray(synth_image(jax.random.PRNGKey(3)))
        shifted = np.roll(img, (0, 16), axis=(0, 1))
        kp1 = orb.extract_orb(jnp.asarray(img), CFG)
        kp2 = orb.extract_orb(jnp.asarray(shifted), CFG)
        d = hamming.hamming_distance_matrix(kp1.desc, kp2.desc)
        idx, best, _ = hamming.masked_best_match(d, kp1.valid, kp2.valid)
        v1 = np.asarray(kp1.valid)
        matched = np.asarray(best) < 40
        good = matched & v1
        assert good.sum() > 0.5 * v1.sum()
        # matched pairs should be displaced by ~(16, 0)
        uv1 = np.asarray(kp1.uv)[good]
        uv2 = np.asarray(kp2.uv)[np.asarray(idx)[good]]
        disp = uv2 - uv1
        med = np.median(disp, axis=0)
        assert abs(med[0] - 16) < 1.5 and abs(med[1]) < 1.5

    def test_distinct_random_patches_far(self):
        """Descriptors of unrelated *textured* images should be far apart.

        (Blurred noise, not squares: axis-aligned square corners are genuinely
        near-identical patches, so they legitimately match across images.)
        """

        def noise_img(seed):
            rng = np.random.RandomState(seed)
            im = rng.uniform(0, 255, (256, 320)).astype(np.float32)
            k = np.ones((5, 5)) / 25.0
            from scipy.signal import convolve2d  # noqa: PLC0415

            return jnp.asarray(convolve2d(im, k, mode="same").astype(np.float32))

        img1 = noise_img(10)
        img2 = noise_img(11)
        kp1 = orb.extract_orb(img1, CFG)
        kp2 = orb.extract_orb(img2, CFG)
        d = hamming.hamming_distance_matrix(kp1.desc, kp2.desc)
        valid = np.asarray(kp1.valid)[:, None] & np.asarray(kp2.valid)[None, :]
        mean_d = np.asarray(d)[valid].mean()
        assert 70 < mean_d < 190


class TestPattern:
    def test_pattern_cached_and_bounded(self):
        p = orb.brief_pattern(0x0B5E55ED)
        assert p.shape == (256, 4)
        assert np.abs(p).max() <= 15
        p2 = orb.brief_pattern(0x0B5E55ED)
        assert p is p2


class TestRotationInvariance:
    def test_90_degree_rotation(self):
        """Steered BRIEF must match across a 90-degree rotation (exact pixels)
        with geometrically consistent correspondences."""
        from scipy.signal import convolve2d

        rng = np.random.RandomState(0)
        img = convolve2d(
            rng.uniform(0, 255, (256, 256)).astype(np.float32),
            np.ones((4, 4)) / 16.0, mode="same",
        ).astype(np.float32)
        rot = np.rot90(img).copy()
        cfg = ORBConfig(max_keypoints=256, n_levels=3)
        kp1 = orb.extract_orb(jnp.asarray(img), cfg)
        kp2 = orb.extract_orb(jnp.asarray(rot), cfg)
        d = hamming.hamming_distance_matrix(kp1.desc, kp2.desc)
        idx, best, _ = hamming.masked_best_match(d, kp1.valid, kp2.valid)
        v = np.asarray(kp1.valid)
        matched = (np.asarray(best) < 50) & v
        assert matched.sum() > 0.6 * v.sum()
        # np.rot90 (ccw): (x, y) -> (y, W-1-x)
        W = img.shape[1]
        uv1 = np.asarray(kp1.uv)
        uv2 = np.asarray(kp2.uv)[np.asarray(idx)]
        expect = np.stack([uv1[matched, 1], W - 1 - uv1[matched, 0]], axis=1)
        err = np.linalg.norm(uv2[matched] - expect, axis=1)
        assert np.median(err) < 1.0


class TestMinThresholdFallback:
    """The reference's two-threshold detect: iniThFAST=20 normally, minThFAST
    as a retry for cells the strong pass leaves empty (KITTI00-02.yaml:38-42
    intent).  Weak-contrast corners (between the two thresholds) must be
    picked up only where strong ones are absent, and never displace them."""

    def _half_and_half(self):
        # left half: strong squares (contrast >> 20); right half: faint
        # squares whose contrast sits between minThFAST(7) and iniThFAST(20)
        img = np.full((256, 320), 100.0, np.float32)
        rng = np.random.RandomState(11)
        for _ in range(12):
            y, x = rng.randint(30, 200), rng.randint(30, 120)
            img[y : y + 14, x : x + 14] = 255.0
        for _ in range(12):
            y, x = rng.randint(30, 200), rng.randint(190, 280)
            img[y : y + 14, x : x + 14] = 114.0  # +14: detectable only at t=7
        return jnp.asarray(img)

    def test_weak_cells_filled(self):
        img = self._half_and_half()
        cfg_fb = ORBConfig(max_keypoints=256, n_levels=1, fast_threshold=20, fast_min_threshold=7)
        cfg_no = ORBConfig(max_keypoints=256, n_levels=1, fast_threshold=20, fast_min_threshold=20)
        kp_fb = orb.extract_orb(img, cfg_fb)
        kp_no = orb.extract_orb(img, cfg_no)
        right_fb = int((kp_fb.valid & (kp_fb.uv[:, 0] > 170)).sum())
        right_no = int((kp_no.valid & (kp_no.uv[:, 0] > 170)).sum())
        assert right_no == 0, "faint corners should be invisible at iniThFAST"
        assert right_fb > 8, "minThFAST fallback should recover the faint half"

    def test_strong_corners_not_displaced(self):
        img = self._half_and_half()
        cfg_fb = ORBConfig(max_keypoints=256, n_levels=1, fast_threshold=20, fast_min_threshold=7)
        cfg_no = ORBConfig(max_keypoints=256, n_levels=1, fast_threshold=20, fast_min_threshold=20)
        kp_fb = orb.extract_orb(img, cfg_fb)
        kp_no = orb.extract_orb(img, cfg_no)
        strong_no = {
            (round(float(x)), round(float(y)))
            for (x, y), v in zip(np.asarray(kp_no.uv), np.asarray(kp_no.valid))
            if v
        }
        strong_fb = {
            (round(float(x)), round(float(y)))
            for (x, y), v, r in zip(
                np.asarray(kp_fb.uv), np.asarray(kp_fb.valid), np.asarray(kp_fb.response)
            )
            if v
        }
        assert strong_no <= strong_fb, "fallback must only add keypoints"


class TestPatches:
    """ops/orb._patches (the vmapped dynamic_slice that feeds orientation and
    upright BRIEF) against numpy slicing with the same clamped origin."""

    @pytest.mark.parametrize("case", ["interior", "edges", "corners"])
    def test_matches_numpy_at_borders(self, case):
        H, W, r = 120, 400, 15
        P = 2 * r + 1
        rng = np.random.RandomState(3)
        img = rng.uniform(0, 255, (H, W)).astype(np.float32)
        if case == "interior":
            xs = rng.randint(r, W - r, 40)
            ys = rng.randint(r, H - r, 40)
        elif case == "edges":
            xs = np.array([0, 3, W - 1, W - 4, 200, 200, 150, 151])
            ys = np.array([60, 61, 62, 63, 0, H - 1, 2, H - 3])
        else:
            xs = np.array([0, W - 1, 0, W - 1, 1, W - 2])
            ys = np.array([0, 0, H - 1, H - 1, 1, H - 2])
        xy = jnp.asarray(np.stack([xs, ys], -1).astype(np.int32))
        got = np.asarray(orb._patches(jnp.asarray(img), xy, r))
        assert got.shape == (len(xs), P, P)
        for i, (x, y) in enumerate(zip(xs, ys)):
            y0 = min(max(y - r, 0), H - P)
            x0 = min(max(x - r, 0), W - P)
            np.testing.assert_array_equal(got[i], img[y0 : y0 + P, x0 : x0 + P])
