"""Dense disparity engine: cost volume + semi-global scanline aggregation.

The reference's dense engine is MSA (Thirdparty/MB/MSA.cpp): a minimum-
spanning-arborescence segmentation + Kruskal merge + two-pass tree DP with
exponential similarity weights, run three times per frame (right base, left
base, refine — solve :1132-1169).  The tree sweeps are sequential over an
irregular spanning tree — hostile to any SIMD/systolic hardware (SURVEY.md §7
"Hard parts").  The accelerator replacement keeps MSA's *cost definition*
(truncated color + truncated gradient mix, MSA.cpp:78-108) and swaps the
aggregator for semi-global matching: 4 directional scanline DPs where each
``lax.scan`` step updates an entire row/column with the 64-wide disparity
axis vectorized — equivalent smoothing power, compiler-friendly
control flow.

Pipeline (mirrors solve()'s structure): cost volume -> 4-path SGM -> WTA +
sub-pixel -> left/right consistency check (LRcheck, MSA.cpp:1027-1105) ->
LR-guided refinement pass (cost reset to |d - d1| for consistent pixels, 0
for inconsistent, re-aggregated at reduced smoothing — MSA.cpp:1163-1167) ->
3x3 median (ctmf replacement).  The refinement repairs LR-failed pixels from
their consistent neighbours instead of discarding them, matching the
reference engine's dense output.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_semantic_vo_tpu.core.config import StereoConfig
from stereo_semantic_vo_tpu.kernels.median import median3x3
from stereo_semantic_vo_tpu.kernels.sgm_scan import sgm_aggregate_pallas


class DenseDisparity(NamedTuple):
    disparity: jax.Array  # (H, W) float32, -1 where invalid
    valid: jax.Array      # (H, W) bool: has a usable value (measured, or
                          #  repaired by the refinement pass when cfg.refine)
    measured: jax.Array   # (H, W) bool: passed the LR consistency check —
                          #  MSA's stable-pixel distinction (MSA.cpp:1027-1105).
                          #  valid & ~measured = inpainted by refinement;
                          #  docs/REAL_IMAGES.md shows repaired pixels agree
                          #  with the reference at only ~0.50-0.63, so depth
                          #  consumers (map-point creation) gate on `measured`


def _xgrad(img: jax.Array) -> jax.Array:
    return (jnp.roll(img, -1, axis=1) - jnp.roll(img, 1, axis=1)) * 0.5


def cost_volume(
    left: jax.Array,
    right: jax.Array,
    cfg: StereoConfig,
    right_base: bool = False,
    left_rgb: jax.Array | None = None,
    right_rgb: jax.Array | None = None,
) -> jax.Array:
    """(H, W, D) matching cost.  cost(x, d) compares left(x) with right(x-d)
    (or right(x) with left(x+d) when ``right_base``), mixing truncated
    absolute intensity and x-gradient differences with the MSA weights.

    With ``left_rgb/right_rgb`` (H, W, 3) the color term is the channel-MEAN
    absolute difference truncated after averaging — exactly MSA's 3-channel
    cost (MSA.cpp:88-93: ``dif_col = min(sum_k |.|/3, 7.0)``); the gradient
    term always comes from the grayscale images (MSA.cpp:53-56)."""
    D = cfg.max_disparity
    gl, gr = _xgrad(left), _xgrad(right)
    use_rgb = left_rgb is not None and right_rgb is not None

    def shift(img, d):
        if right_base:
            return jnp.roll(img, -d, axis=1)   # left sampled at x+d
        return jnp.roll(img, d, axis=1)        # right sampled at x-d

    if use_rgb:
        base_i = right_rgb if right_base else left_rgb
        match_i = left_rgb if right_base else right_rgb
    else:
        base_i = right if right_base else left
        match_i = left if right_base else right
    base_g = gr if right_base else gl
    match_g = gl if right_base else gr

    costs = []
    for d in range(D):
        diff = jnp.abs(base_i - shift(match_i, d))
        if use_rgb:
            diff = jnp.mean(diff, axis=-1)
        ci = jnp.minimum(diff, cfg.color_trunc)
        cg = jnp.minimum(jnp.abs(base_g - shift(match_g, d)), cfg.grad_trunc)
        costs.append(cfg.color_weight * ci + cfg.grad_weight * cg)
    vol = jnp.stack(costs, axis=-1)  # (H, W, D)
    # box-filter aggregation over the matching window
    r = cfg.block_radius
    k = 2 * r + 1
    vol = jax.lax.reduce_window(
        vol, 0.0, jax.lax.add, (k, k, 1), (1, 1, 1), "SAME"
    ) / (k * k)
    return vol


def _sgm_pass(vol: jax.Array, p1: float, p2: float, axis: int, reverse: bool,
              p2x: jax.Array | None = None) -> jax.Array:
    """One directional SGM sweep.  vol: (H, W, D); scan along ``axis`` with the
    whole cross-section (rows or columns) x D updated per step.  ``p2x``
    (H, W), if given, replaces the scalar P2 per position (edge-aware
    smoothing)."""
    D = vol.shape[-1]
    moved = jnp.moveaxis(vol, axis, 0)  # (S, X, D): scan over S
    if p2x is None:
        p2m = jnp.full(moved.shape[:2], jnp.float32(p2))
    else:
        p2m = jnp.moveaxis(p2x, axis, 0)
    big = jnp.float32(1e9)

    def step(prev, xs):
        # prev: (X, D) aggregated cost of previous position
        c, p2row = xs
        prev_min = jnp.min(prev, axis=-1, keepdims=True)
        shift_m = jnp.concatenate([jnp.full_like(prev[:, :1], big), prev[:, :-1]], axis=1)
        shift_p = jnp.concatenate([prev[:, 1:], jnp.full_like(prev[:, :1], big)], axis=1)
        best = jnp.minimum(
            jnp.minimum(prev, prev_min + p2row[:, None]),
            jnp.minimum(shift_m + p1, shift_p + p1),
        )
        out = c + best - prev_min
        return out, out

    # a reverse sweep is exactly the forward sweep on the flipped axis
    # (seeded with the far end's raw cost) — flip, scan, flip back
    if reverse:
        moved = moved[::-1]
        p2m = p2m[::-1]
    init = moved[0]
    _, agg = jax.lax.scan(step, init, (moved[1:], p2m[1:]))
    agg = jnp.concatenate([init[None], agg], axis=0)
    if reverse:
        agg = agg[::-1]
    return jnp.moveaxis(agg, 0, axis)


def edge_p2_planes(
    base: jax.Array, cfg: StereoConfig
) -> tuple[jax.Array, jax.Array]:
    """Per-position P2 for horizontal / vertical scans from the base image.

    P2'(p) = p1 + (p2 - p1) * exp(-|dI(p)| / gamma) with dI the central
    intensity gradient along the scan axis: smoothing keeps full strength in
    flat regions and collapses toward P1 across intensity edges — the SGM
    analogue of MSA's color-difference tree weights directed low->high
    gradient (Thirdparty/MB/MSA.cpp:152-191, setExp :1126-1130)."""
    gx = jnp.abs(_xgrad(base))
    gy = jnp.abs(jnp.moveaxis(_xgrad(jnp.moveaxis(base, 0, 1)), 0, 1))
    lo = jnp.float32(cfg.p1)
    span = jnp.float32(cfg.p2 - cfg.p1)
    inv_g = 1.0 / cfg.edge_p2_gamma
    return (
        lo + span * jnp.exp(-gx * inv_g),
        lo + span * jnp.exp(-gy * inv_g),
    )


def sgm_aggregate(
    vol: jax.Array,
    cfg: StereoConfig,
    p2x_h: jax.Array | None = None,
    p2x_v: jax.Array | None = None,
    scale: float = 1.0,
) -> jax.Array:
    """4-path SGM (horizontal both ways, vertical both ways).

    Backend per ``cfg.dense_backend``: ``"pallas"`` lowers to the Triton
    scanline kernel on CUDA GPUs and to the lax.scan formulation on every
    other platform (bit-identical, tests/test_sgm_pallas.py); ``"xla"`` is
    the lax.scan formulation everywhere.  ``p2x_h``/``p2x_v`` (H, W) are
    optional per-position P2 planes (edge_p2_planes); ``scale`` multiplies
    all penalties (the refine pass runs at 0.5 — MSA's setExp(sigma/2))."""
    p1 = cfg.p1 * scale
    p2 = cfg.p2 * scale
    if p2x_h is not None:
        p2x_h = p2x_h * scale
    if p2x_v is not None:
        p2x_v = p2x_v * scale

    def scan4(v):
        acc = _sgm_pass(v, p1, p2, 1, False, p2x_h)
        acc = acc + _sgm_pass(v, p1, p2, 1, True, p2x_h)
        acc = acc + _sgm_pass(v, p1, p2, 0, False, p2x_v)
        return acc + _sgm_pass(v, p1, p2, 0, True, p2x_v)

    if cfg.dense_backend == "xla":
        return scan4(vol)
    return jax.lax.platform_dependent(
        vol,
        cuda=lambda v: sgm_aggregate_pallas(v, p1, p2, p2x_h, p2x_v),
        default=scan4,
    )


def _wta_subpixel(agg: jax.Array, min_disp: float) -> jax.Array:
    """(H, W, D) -> (H, W) winner-take-all disparity with equiangular
    sub-pixel refinement (SAD costs are V-shaped; a two-line fit avoids the
    parabola's pixel-locking bias).

    Gather-free: the neighbours of the argmin are picked with one-hot
    masked reductions along D instead of ``take_along_axis``: the masked
    reductions fuse into two streaming traversals of agg."""
    D = agg.shape[-1]
    best = jnp.argmin(agg, axis=-1)
    d_iota = jnp.arange(D, dtype=jnp.int32)
    b = best[..., None]
    big = jnp.float32(1e9)
    c0 = jnp.min(jnp.where(d_iota == b, agg, big), axis=-1)
    cm = jnp.min(jnp.where(d_iota == jnp.clip(b - 1, 0, D - 1), agg, big), axis=-1)
    cp = jnp.min(jnp.where(d_iota == jnp.clip(b + 1, 0, D - 1), agg, big), axis=-1)
    denom = 2.0 * (jnp.maximum(cm, cp) - c0)
    delta = jnp.where(denom > 1e-6, (cm - cp) / denom, 0.0)
    return best.astype(jnp.float32) + jnp.clip(delta, -0.5, 0.5)


@functools.partial(jax.jit, static_argnames=("cfg",))
def dense_disparity(
    left: jax.Array,
    right: jax.Array,
    cfg: StereoConfig,
    left_rgb: jax.Array | None = None,
    right_rgb: jax.Array | None = None,
) -> DenseDisparity:
    """Full dense pipeline with LR consistency.  left/right: (H, W) float32
    grayscale; optionally pass the (H, W, 3) color images for MSA's
    3-channel color cost (cost_volume docstring)."""
    p2h_l = p2v_l = p2h_r = p2v_r = None
    if cfg.edge_p2:
        p2h_l, p2v_l = edge_p2_planes(left, cfg)
        p2h_r, p2v_r = edge_p2_planes(right, cfg)

    vol_l = cost_volume(left, right, cfg, right_base=False,
                        left_rgb=left_rgb, right_rgb=right_rgb)
    agg_l = sgm_aggregate(vol_l, cfg, p2h_l, p2v_l)
    disp_l = _wta_subpixel(agg_l, cfg.min_disparity)

    vol_r = cost_volume(left, right, cfg, right_base=True,
                        left_rgb=left_rgb, right_rgb=right_rgb)
    agg_r = sgm_aggregate(vol_r, cfg, p2h_r, p2v_r)
    disp_r = _wta_subpixel(agg_r, cfg.min_disparity)

    # LR check: d_l(x) vs d_r(x - d_l(x))  (MSA LRcheck semantics)
    H, W = left.shape
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    xr = jnp.clip(xs - jnp.round(disp_l).astype(jnp.int32), 0, W - 1)
    d_r_at = jnp.take_along_axis(disp_r, xr, axis=1)
    consistent = jnp.abs(disp_l - d_r_at) <= cfg.lr_consistency_px

    # disparity-range border: the first D columns cannot see their match
    in_range = xs - disp_l >= 0
    valid = consistent & in_range & (disp_l > cfg.min_disparity)
    measured = valid

    if cfg.refine:
        # MSA's third phase (solve :1163-1167): reset the cost volume from the
        # LR verdict — consistent pixels anchor at their disparity with a
        # unit-slope penalty |d - d1| (LRcheck, MSA.cpp:1027-1105), failed
        # pixels cost 0 everywhere — and re-aggregate at reduced smoothing
        # (setExp(o/2)).  Aggregation then interpolates the failed pixels
        # from their consistent neighbours instead of discarding them.
        D = cfg.max_disparity
        d_axis = jnp.arange(D, dtype=jnp.float32)
        vol_ref = jnp.where(
            valid[..., None],
            jnp.abs(d_axis - disp_l[..., None]),
            0.0,
        )
        agg_ref = sgm_aggregate(vol_ref, cfg, p2h_l, p2v_l, scale=0.5)
        disp_ref = _wta_subpixel(agg_ref, cfg.min_disparity)
        # consistent pixels keep their (sub-pixel) first-pass estimate; failed
        # pixels take the repaired value
        disp_l = jnp.where(valid, disp_l, disp_ref)
        valid = in_range & (disp_l > cfg.min_disparity)

    disp = median3x3(jnp.where(valid, disp_l, 0.0))
    disp = jnp.where(valid, disp, -1.0)
    return DenseDisparity(disparity=disp, valid=valid, measured=measured & valid)
