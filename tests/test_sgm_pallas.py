"""Bit-parity of the Triton scanline SGM kernel vs the XLA lax.scan path.

The kernel (kernels/sgm_scan.py) replaces ops/dense_stereo._sgm_pass's
per-step scan with one program per tile of scanlines; its update uses the
identical min tree and add order, so outputs must be bit-equal.  Here it
runs in Pallas interpret mode; ``TestCompiledKernel`` runs the compiled
kernel and needs a CUDA GPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stereo_semantic_vo_tpu.kernels.sgm_scan import (
    sgm_aggregate_pallas,
    sgm_sweeps,
)
from stereo_semantic_vo_tpu.ops.dense_stereo import _sgm_pass, sgm_aggregate
from stereo_semantic_vo_tpu.core.config import StereoConfig


def _vol(h=40, w=150, d=48, seed=0):
    rng = np.random.RandomState(seed)
    return jnp.asarray(rng.uniform(0, 3, (h, w, d)).astype(np.float32))


P1, P2 = 1.0, 8.0


def _both(vol, axis, p2=P2, p2x=None):
    return (_sgm_pass(vol, P1, p2, axis, False, p2x)
            + _sgm_pass(vol, P1, p2, axis, True, p2x))


def _sum_sweeps(vol, axis, p2=P2, p2x=None):
    got = sgm_sweeps(vol, p2x, axis=axis, p1=P1, p2=p2, interpret=True)
    return got[0] + got[1]


class TestDirectionalParity:
    def test_horizontal_bidirectional(self):
        vol = _vol()
        np.testing.assert_array_equal(
            np.asarray(_sum_sweeps(vol, 1)), np.asarray(_both(vol, 1)))

    def test_vertical_bidirectional(self):
        vol = _vol(seed=1)
        np.testing.assert_array_equal(
            np.asarray(_sum_sweeps(vol, 0)), np.asarray(_both(vol, 0)))

    def test_four_path_aggregate(self):
        vol = _vol(seed=2)
        cfg = StereoConfig(dense_backend="xla")  # the lax.scan reference
        ref = sgm_aggregate(vol, cfg)
        got = sgm_aggregate_pallas(vol, cfg.p1, cfg.p2, interpret=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    def test_unaligned_shapes(self):
        # S and X both far from block multiples; padding must never leak
        vol = _vol(h=13, w=67, d=48, seed=3)
        np.testing.assert_array_equal(
            np.asarray(_sum_sweeps(vol, 1)), np.asarray(_both(vol, 1)))

    def test_edge_aware_p2_parity(self):
        # per-position P2 plane: XLA scan path vs the kernel path
        vol = _vol(seed=5)
        H, W, _ = vol.shape
        rng = np.random.RandomState(7)
        p2x = jnp.asarray(rng.uniform(1.0, 8.0, (H, W)).astype(np.float32))
        np.testing.assert_array_equal(
            np.asarray(_sum_sweeps(vol, 1, 0.0, p2x)),
            np.asarray(_both(vol, 1, 0.0, p2x)))

    def test_scalar_p2x_matches_scalar_p2(self):
        # a constant per-position P2 plane must reproduce the scalar path
        vol = _vol(seed=4)
        plane = jnp.full(vol.shape[:2], P2, jnp.float32)
        a = _sum_sweeps(vol, 0)
        b = _sum_sweeps(vol, 0, 0.0, plane)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestKernelShapes:
    @pytest.mark.parametrize("d", [48, 16, 64])
    def test_disparity_padded_to_power_of_two(self, d):
        # D=48 pads to 64 in registers, 16 and 64 need no padding
        vol = _vol(h=17, w=20, d=d, seed=6)
        got = sgm_sweeps(vol, None, axis=1, p1=P1, p2=P2, interpret=True)
        assert got.shape == (2, 17, 20, d)
        np.testing.assert_array_equal(
            np.asarray(got[0]), np.asarray(_sgm_pass(vol, P1, P2, 1, False)))

    @pytest.mark.parametrize("x", [1, 15, 17, 33])
    def test_unaligned_scanline_count(self, x):
        # the scanline tile is 16 wide: fewer, one more, and two more than a
        # tile; the masked rows of the last tile must not touch the output
        vol = _vol(h=9, w=x, d=48, seed=8)
        np.testing.assert_array_equal(
            np.asarray(_sum_sweeps(vol, 0)), np.asarray(_both(vol, 0)))

    @pytest.mark.parametrize("axis", [0, 1])
    def test_reverse_sweep_alone(self, axis):
        vol = _vol(h=21, w=37, d=48, seed=9)
        got = sgm_sweeps(vol, None, axis=axis, p1=P1, p2=P2, interpret=True)
        np.testing.assert_array_equal(
            np.asarray(got[1]), np.asarray(_sgm_pass(vol, P1, P2, axis, True)))


@pytest.mark.gpu
class TestCompiledKernel:
    def test_full_width_bit_parity(self, gpu_device):
        """The compiled kernel at KITTI width (376 x 1241 x 48) with an
        edge-aware P2 plane equals the lax.scan reference bit for bit."""
        vol = _vol(h=376, w=1241, d=48, seed=10)
        rng = np.random.RandomState(11)
        p2x = jnp.asarray(rng.uniform(1.0, 8.0, (376, 1241)).astype(np.float32))
        got = sgm_aggregate_pallas(vol, P1, 0.0, p2x, p2x)
        ref = jax.jit(lambda v, p: sgm_aggregate(
            v, StereoConfig(p2=0.0, dense_backend="xla"), p, p))(vol, p2x)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
