"""Stereo disparity at keypoints — the depth source for the VO pipeline.

The reference runs a full dense MSA spanning-tree disparity solve per frame
(frame.cc:82-91 -> Thirdparty/MB/MSA.cpp:1132) and then *samples it at the
~500 keypoints only* (computekeypoint_r frame.cc:122-138, disp2Depth
:140-164).  This design inverts that: correlate a small window
along the epipolar line at each keypoint directly — a (K, D) cost tensor
evaluated in one shot — which is all the pipeline consumes and is
orders of magnitude less work than the dense solve.  (A dense cost-volume
engine lives in ops/dense_stereo.py for the full-disparity use case.)

Cost mirrors MSA's mix: truncated absolute intensity difference plus
truncated x-gradient difference (MSA.cpp:78-108, weights 0.11/0.89,
truncations 7.0/2.0), aggregated over a (2r+1)^2 window.  Sub-pixel parabola
refinement, left-right uniqueness ratio, and minimum-disparity gating follow.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_semantic_vo_tpu.core.camera import Camera, disparity_to_depth
from stereo_semantic_vo_tpu.core.config import StereoConfig


class StereoMatch(NamedTuple):
    disparity: jax.Array  # (K,) float32 sub-pixel disparity (level-0 px)
    depth: jax.Array      # (K,) float32, 0 where invalid
    valid: jax.Array      # (K,) bool
    cost: jax.Array       # (K,) float32 best matching cost (diagnostics)


def _xgrad(img: jax.Array) -> jax.Array:
    g = (jnp.roll(img, -1, axis=1) - jnp.roll(img, 1, axis=1)) * 0.5
    return g


def sparse_disparity(
    left: jax.Array,
    right: jax.Array,
    uv: jax.Array,
    kp_valid: jax.Array,
    cam: Camera,
    cfg: StereoConfig,
) -> StereoMatch:
    """Per-keypoint epipolar window correlation.

    left/right: (H, W) float32 grayscale in [0, 255]
    uv: (K, 2) float32 keypoint pixel coords (x, y) in the left image
    """
    H, W = left.shape
    D = cfg.max_disparity
    r = cfg.block_radius
    P = 2 * r + 1
    big = jnp.float32(1e9)
    x = jnp.round(uv[:, 0]).astype(jnp.int32)
    y = jnp.round(uv[:, 1]).astype(jnp.int32)
    gl = _xgrad(left)
    gr = _xgrad(right)
    d_idx = jnp.arange(D)[None, :]

    mode = cfg.sparse_mode
    if mode == "dense":
        # reference-faithful path: full dense disparity (SGM engine standing
        # in for MSA), sampled at the keypoints (frame.cc:82-164 order)
        from stereo_semantic_vo_tpu.ops.dense_stereo import dense_disparity

        dd = dense_disparity(left, right, cfg)
        xc = jnp.clip(x, 0, W - 1)
        yc = jnp.clip(y, 0, H - 1)
        disp = dd.disparity[yc, xc]
        # gate on MEASURED (LR-consistent) pixels only: refine-repaired
        # disparities are inpainted, not observed, and must not seed map
        # points (MSA stable-pixel semantics, MSA.cpp:1027-1105)
        dvalid = dd.measured[yc, xc]
        valid = kp_valid & dvalid & (disp > cfg.min_disparity)
        depth = jnp.where(valid, disparity_to_depth(cam, disp, cfg.min_disparity), 0.0)
        return StereoMatch(
            disparity=jnp.where(valid, disp, -1.0),
            depth=depth,
            valid=valid,
            cost=jnp.zeros_like(disp),
        )
    if mode == "volume2":
        # One (H, W, D) tensor: stack the D shifted difference maps, then a
        # separable box filter applied to the whole volume (2 reduce_windows
        # total instead of 2 per disparity), then the keypoint gather.
        def diff_map(d):
            rs = jnp.roll(right, d, axis=1)
            gs = jnp.roll(gr, d, axis=1)
            ci = jnp.minimum(jnp.abs(left - rs), cfg.color_trunc)
            cg = jnp.minimum(jnp.abs(gl - gs), cfg.grad_trunc)
            return cfg.color_weight * ci + cfg.grad_weight * cg

        vol = jnp.stack([diff_map(d) for d in range(D)], axis=-1)
        vol = jax.lax.reduce_window(vol, 0.0, jax.lax.add, (1, P, 1), (1, 1, 1), "SAME")
        vol = jax.lax.reduce_window(vol, 0.0, jax.lax.add, (P, 1, 1), (1, 1, 1), "SAME")
        xc = jnp.clip(x, 0, W - 1)
        yc = jnp.clip(y, 0, H - 1)
        costs = vol[yc, xc]
        addressable = (x[:, None] - d_idx) >= r
        costs = jnp.where(addressable, costs, big)
    elif mode == "volume":
        # Whole-image formulation: D shifted truncated-difference maps with a
        # separable PxP box filter each, sampled at the keypoints.  Rolled up
        # as a lax.scan over the disparity axis so the XLA program stays small
        # (the unrolled form multiplied compile time by ~O(D)).
        xc = jnp.clip(x, 0, W - 1)
        yc = jnp.clip(y, 0, H - 1)

        def scan_body(_, d):
            rs = jnp.roll(right, d, axis=1)
            gs = jnp.roll(gr, d, axis=1)
            ci = jnp.minimum(jnp.abs(left - rs), cfg.color_trunc)
            cg = jnp.minimum(jnp.abs(gl - gs), cfg.grad_trunc)
            c = cfg.color_weight * ci + cfg.grad_weight * cg
            c = jax.lax.reduce_window(c, 0.0, jax.lax.add, (1, P), (1, 1), "SAME")
            c = jax.lax.reduce_window(c, 0.0, jax.lax.add, (P, 1), (1, 1), "SAME")
            return None, c[yc, xc]

        _, costs_dk = jax.lax.scan(scan_body, None, jnp.arange(D))  # (D, K)
        costs = costs_dk.T
        addressable = (x[:, None] - d_idx) >= r
        costs = jnp.where(addressable, costs, big)
    else:  # "strips": per-keypoint row strips (fewer FLOPs, gather-heavy)
        Ws = D + 2 * r
        y0 = jnp.clip(y - r, 0, H - P)
        xl0 = jnp.clip(x - r, 0, W - P)
        xr0_raw = x - (D - 1) - r
        xr0 = jnp.clip(xr0_raw, 0, W - Ws)
        shift = xr0 - xr0_raw  # >0 where clamped at the image edge

        def slice2(img, ys, xs, h, w):
            return jax.lax.dynamic_slice(img, (ys, xs), (h, w))

        lp = jax.vmap(lambda ys, xs: slice2(left, ys, xs, P, P))(y0, xl0)
        lg = jax.vmap(lambda ys, xs: slice2(gl, ys, xs, P, P))(y0, xl0)
        rp = jax.vmap(lambda ys, xs: slice2(right, ys, xs, P, Ws))(y0, xr0)
        rg = jax.vmap(lambda ys, xs: slice2(gr, ys, xs, P, Ws))(y0, xr0)

        def cost_at(d):
            s = D - 1 - d
            rp_d = jax.lax.dynamic_slice_in_dim(rp, s, P, axis=2)
            rg_d = jax.lax.dynamic_slice_in_dim(rg, s, P, axis=2)
            c_int = jnp.minimum(jnp.abs(lp - rp_d), cfg.color_trunc)
            c_grd = jnp.minimum(jnp.abs(lg - rg_d), cfg.grad_trunc)
            return jnp.sum(cfg.color_weight * c_int + cfg.grad_weight * c_grd, axis=(1, 2))

        costs = jnp.stack([cost_at(d) for d in range(D)], axis=1)
        addressable = (D - 1 - d_idx) >= shift[:, None]
        costs = jnp.where(addressable, costs, big)

    best = jnp.argmin(costs, axis=1)
    c0 = jnp.take_along_axis(costs, best[:, None], axis=1)[:, 0]
    # uniqueness: best must beat the runner-up (excluding +-1 neighbors)
    neighbor = jnp.abs(d_idx - best[:, None]) <= 1
    c_excl = jnp.where(neighbor, big, costs)
    c1 = jnp.min(c_excl, axis=1)
    unique = c0 < cfg.uniqueness_ratio * c1

    # sub-pixel refinement: SAD-style costs form a V around the true minimum,
    # so equiangular interpolation (two-line fit) has far less pixel-locking
    # bias than a parabola
    bm = jnp.clip(best - 1, 0, D - 1)
    bp = jnp.clip(best + 1, 0, D - 1)
    cm = jnp.take_along_axis(costs, bm[:, None], axis=1)[:, 0]
    cp = jnp.take_along_axis(costs, bp[:, None], axis=1)[:, 0]
    denom = 2.0 * (jnp.maximum(cm, cp) - c0)
    delta = jnp.where(denom > 1e-6, (cm - cp) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    disp = best.astype(jnp.float32) + delta

    max_win_cost = (cfg.color_weight * cfg.color_trunc + cfg.grad_weight * cfg.grad_trunc) * P * P
    valid = (
        kp_valid
        & unique
        & (disp > cfg.min_disparity)
        & (best > 0)
        & (best < D - 1)
        & (c0 < 0.8 * max_win_cost)
    )
    depth = jnp.where(valid, disparity_to_depth(cam, disp, cfg.min_disparity), 0.0)
    return StereoMatch(disparity=jnp.where(valid, disp, -1.0), depth=depth, valid=valid, cost=c0)
