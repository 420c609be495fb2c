"""ORB feature frontend, fixed-shape and vectorized.

Replaces cv::ORB::detectAndCompute (reference frame.cc:75-79: 500 features,
8 levels, scale 1.2) with a fully vectorized, fixed-shape pipeline:

* FAST-9/16 corner test evaluated for *every* pixel at once (16 rolled copies
  of the image, boolean arc reduction in one fused pass) instead of a serial pixel
  scan.
* 3x3 non-max suppression + per-grid-cell top-k selection so the keypoint
  tensor has a static shape (the reference's fixed N=500 slot array,
  frame.cc:54-58, reborn as masked fixed-size arrays).
* Orientation by intensity centroid (the rBRIEF steering angle).
* 256-bit steered-BRIEF descriptors from a deterministic seeded sampling
  pattern, gathered for all keypoints in one batched lookup and packed into
  (K, 8) uint32 words for the Hamming matcher.

Detection runs per pyramid level (Python-unrolled: 8 static shapes), with a
geometric per-level feature budget like ORB-SLAM2's distribution.

The descriptor pattern is *self-consistent*, not OpenCV's learned table:
both ends of every match use this extractor, so any well-spread pattern
preserves the matcher's distance statistics (gates 15/30 in MatcherConfig).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_semantic_vo_tpu.core.config import ORBConfig

# FAST-9/16 Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx)
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
_ARC = 9


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (all arrays length K = cfg.max_keypoints)."""

    uv: jax.Array        # (K, 2) float32, level-0 pixel coordinates (x, y)
    response: jax.Array  # (K,) float32 FAST score
    angle: jax.Array     # (K,) float32 radians
    level: jax.Array     # (K,) int32 pyramid level
    valid: jax.Array     # (K,) bool
    desc: jax.Array      # (K, 8) uint32 packed 256-bit descriptors


@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int, n_bits: int = 256, patch: int = 31) -> np.ndarray:
    """Deterministic BRIEF point-pair pattern: (n_bits, 4) int32 = (y1,x1,y2,x2).

    Pairs drawn from a clipped Gaussian (sigma = patch/5) like the original
    BRIEF; fixed seed => identical descriptors across processes/runs.
    """
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    sigma = patch / 5.0
    lim = patch // 2
    pts = np.clip(np.round(rng.randn(n_bits, 4) * sigma), -lim, lim).astype(np.int32)
    return pts


def _fast_score(img: jax.Array, *thresholds: float) -> list[jax.Array]:
    """FAST-9/16 corner response for every pixel at one or more thresholds.
    img: (H, W) float32 [0,255].

    The circle gather (16 rolls) is the expensive part and is shared across
    thresholds — the reference's two-threshold detect (iniThFAST with a
    minThFAST retry for weak cells, ORBextractor semantics driven by
    KITTI00-02.yaml:38-42) costs only the cheap classify/score stage twice.
    Returns one (H, W) float32 score per threshold (0 where not a corner).
    """
    center = img
    # (16, H, W) circle samples via rolls (borders masked by caller)
    circ = jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), axis=(0, 1)) for dy, dx in _CIRCLE]
    )
    diff = circ - center[None]

    # circular >= _ARC run detection on packed 16-bit masks: duplicate the
    # ring (m | m<<16) and AND 9 shifted copies — ~18 integer ops instead of
    # 16x9 boolean ANDs (keeps the XLA program small: this runs per pyramid
    # level)
    weights = (jnp.uint32(1) << jnp.arange(16, dtype=jnp.uint32))[:, None, None]

    def arc_any(bits):
        m = jnp.sum(jnp.where(bits, weights, jnp.uint32(0)), axis=0)
        m2 = m | (m << 16)
        run = m2
        for k in range(1, _ARC):
            run = run & (m2 >> k)
        return (run & jnp.uint32(0xFFFF)) != 0

    scores = []
    for threshold in thresholds:
        brighter = diff > threshold
        darker = diff < -threshold
        is_corner = arc_any(brighter) | arc_any(darker)
        # response: sum of |diff| - t over the classified samples (NMS ranking)
        sb = jnp.sum(jnp.where(brighter, diff - threshold, 0.0), axis=0)
        sd = jnp.sum(jnp.where(darker, -diff - threshold, 0.0), axis=0)
        scores.append(jnp.where(is_corner, jnp.maximum(sb, sd), 0.0))
    return scores


def _nms3(score: jax.Array) -> jax.Array:
    """3x3 non-max suppression: keep strict local maxima."""
    m = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= m, score, 0.0)


def _grid_topk(score: jax.Array, rows: int, cols: int, k_cell: int):
    """Top-k responses per grid cell -> ((rows*cols*k_cell,) flat pixel index,
    score).  Static-shape replacement for retainBest: guarantees spatial
    spread (the YAML's grid-distribution intent, KITTI00-02.yaml:36-51)."""
    H, W = score.shape
    ch, cw = H // rows, W // cols
    Hc, Wc = ch * rows, cw * cols
    s = score[:Hc, :Wc].reshape(rows, ch, cols, cw).transpose(0, 2, 1, 3)
    s = s.reshape(rows * cols, ch * cw)
    top, idx = jax.lax.top_k(s, k_cell)  # (cells, k_cell)
    cell_ids = jnp.arange(rows * cols)
    cy = (cell_ids // cols) * ch
    cx = (cell_ids % cols) * cw
    py = cy[:, None] + idx // cw
    px = cx[:, None] + idx % cw
    flat = py * W + px
    return flat.reshape(-1), top.reshape(-1)


def _smooth(img: jax.Array, width: int = 5) -> jax.Array:
    """width x width box blur (separable) — BRIEF's noise-robust sampling
    surface.  Implemented as two reduce_window sums (XLA's conv path is
    tuned for many-channel NN convs, not 1-channel image filters;
    reduce_window lowers straight to shifted adds)."""
    inv = jnp.asarray(1.0 / (width * width), img.dtype)
    x = jax.lax.reduce_window(img, 0.0, jax.lax.add, (1, width), (1, 1), "SAME")
    x = jax.lax.reduce_window(x, 0.0, jax.lax.add, (width, 1), (1, 1), "SAME")
    return x * inv


def _patches(img: jax.Array, xy: jax.Array, r: int) -> jax.Array:
    """(N, 2r+1, 2r+1) square patches centered at integer coords xy (x, y).
    Keypoints respect cfg.border >= r, so the clip only fires on dead slots."""
    H, W = img.shape

    def one(p):
        y0 = jnp.clip(p[1] - r, 0, H - 2 * r - 1)
        x0 = jnp.clip(p[0] - r, 0, W - 2 * r - 1)
        return jax.lax.dynamic_slice(img, (y0, x0), (2 * r + 1, 2 * r + 1))

    return jax.vmap(one)(xy.astype(jnp.int32))


@functools.lru_cache(maxsize=None)
def _ic_weights(half: int) -> tuple[np.ndarray, np.ndarray]:
    """Intensity-centroid moment weights of a (2*half+1)^2 patch, flattened:
    x and y offsets inside the circular mask, zero outside it."""
    r = half
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    circle = (dx * dx + dy * dy) <= r * r
    return ((dx * circle).astype(np.float32).reshape(-1),
            (dy * circle).astype(np.float32).reshape(-1))


def _orientation_from_patches(patches: jax.Array, half: int) -> jax.Array:
    """Intensity-centroid angle from pre-extracted (N, P, P) patches. The
    circular-mask moment sums are two static matvecs."""
    wx_np, wy_np = _ic_weights(half)
    wx = jnp.asarray(wx_np)
    wy = jnp.asarray(wy_np)
    flat = patches.reshape(patches.shape[0], -1)
    # full f32 accumulation: a default-precision dot (TF32 on the GPU) would
    # jitter the angle and flip outer-radius BRIEF bits
    hp = jax.lax.Precision.HIGHEST
    m10 = jnp.dot(flat, wx, precision=hp)
    m01 = jnp.dot(flat, wy, precision=hp)
    return jnp.arctan2(m01, m10)


def _orientation(img: jax.Array, xy: jax.Array, half: int) -> jax.Array:
    """Intensity-centroid angle for keypoints at integer coords xy (N, 2)=(x,y)."""
    return _orientation_from_patches(_patches(img, xy, half), half)


@functools.lru_cache(maxsize=None)
def _upright_onehots(seed: int, n_bits: int, patch: int) -> tuple[np.ndarray, np.ndarray]:
    """Static (P*P, n_bits) one-hot sampling matrices for the un-rotated
    BRIEF pattern: endpoint intensities become two matmuls instead of
    2*n_bits scattered gathers per keypoint."""
    pts = brief_pattern(seed, n_bits, patch)  # (n_bits, 4): y1 x1 y2 x2
    r = patch // 2
    P = 2 * r + 1
    s1 = np.zeros((P * P, n_bits), np.float32)
    s2 = np.zeros((P * P, n_bits), np.float32)
    for j, (y1, x1, y2, x2) in enumerate(pts):
        s1[(y1 + r) * P + (x1 + r), j] = 1.0
        s2[(y2 + r) * P + (x2 + r), j] = 1.0
    return s1, s2


def _pack_bits(bits: jax.Array) -> jax.Array:
    """(N, 256) 0/1 -> (N, 8) uint32."""
    words = bits.astype(jnp.uint32).reshape(bits.shape[0], 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def _describe_upright(patches: jax.Array, seed: int, n_bits: int, patch: int) -> jax.Array:
    """Upright BRIEF from pre-extracted (N, P, P) patches: two static
    one-hot matmuls (the gather-free formulation; the pattern never rotates
    so the sampling matrix is shared by every keypoint)."""
    s1, s2 = _upright_onehots(seed, n_bits, patch)
    flat = patches.reshape(patches.shape[0], -1)
    # HIGHEST precision: a one-hot dot is an exact selection in full f32 but
    # a default-precision dot (TF32 on the GPU) would quantize intensities and
    # flip near-tie comparison bits
    hp = jax.lax.Precision.HIGHEST
    i1 = jnp.dot(flat, jnp.asarray(s1), precision=hp)
    i2 = jnp.dot(flat, jnp.asarray(s2), precision=hp)
    return _pack_bits(i1 < i2)


def _describe(img_s: jax.Array, xy: jax.Array, angle: jax.Array, pattern: jax.Array) -> jax.Array:
    """Steered-BRIEF: rotate the pattern by each keypoint's angle, compare
    smoothed intensities, pack 256 bits -> (N, 8) uint32."""
    H, W = img_s.shape
    ca, sa = jnp.cos(angle), jnp.sin(angle)  # (N,)
    p = pattern.astype(jnp.float32)  # (256, 4): y1 x1 y2 x2
    # rotate both endpoints: [x'; y'] = R(angle) [x; y]
    def rot(py, px):
        rx = ca[:, None] * px[None, :] - sa[:, None] * py[None, :]
        ry = sa[:, None] * px[None, :] + ca[:, None] * py[None, :]
        return ry, rx

    y1, x1 = rot(p[:, 0], p[:, 1])
    y2, x2 = rot(p[:, 2], p[:, 3])
    # absolute sample coords, rounded to nearest pixel, clamped
    ky = xy[:, 1:2].astype(jnp.float32)
    kx = xy[:, 0:1].astype(jnp.float32)
    sy1 = jnp.clip(jnp.round(ky + y1), 0, H - 1).astype(jnp.int32)
    sx1 = jnp.clip(jnp.round(kx + x1), 0, W - 1).astype(jnp.int32)
    sy2 = jnp.clip(jnp.round(ky + y2), 0, H - 1).astype(jnp.int32)
    sx2 = jnp.clip(jnp.round(kx + x2), 0, W - 1).astype(jnp.int32)
    i1 = img_s[sy1, sx1]
    i2 = img_s[sy2, sx2]
    return _pack_bits(i1 < i2)


def _level_budgets(cfg: ORBConfig, n_candidates: int) -> list[int]:
    """Geometric per-level candidate budget ~ 1/scale^l, ORB-SLAM2 style."""
    inv = [1.0 / (cfg.scale_factor**l) for l in range(cfg.n_levels)]
    s = sum(inv)
    return [max(8, int(round(n_candidates * w / s))) for w in inv]


def extract_orb(image: jax.Array, cfg: ORBConfig) -> Keypoints:
    """Full ORB pipeline on one grayscale image (H, W) float32 in [0, 255].

    Returns a fixed-capacity :class:`Keypoints` (K = cfg.max_keypoints),
    ranked by response, with validity masks for unfilled slots.
    """
    H, W = image.shape
    pattern = jnp.asarray(brief_pattern(cfg.brief_seed, cfg.descriptor_bits, cfg.patch_size))
    n_cand = 2 * cfg.max_keypoints
    budgets = _level_budgets(cfg, n_cand)

    all_uv, all_rank, all_score, all_angle, all_level, all_desc, all_valid = (
        [], [], [], [], [], [], [],
    )
    # strong (iniThFAST) corners must always outrank weak-cell (minThFAST)
    # fallbacks, both inside a grid cell and in the global top-K
    bonus = jnp.float32(1e6)
    img_l = image
    for level in range(cfg.n_levels):
        Hl, Wl = img_l.shape
        two_pass = cfg.fast_min_threshold < cfg.fast_threshold
        ths = (
            (float(cfg.fast_threshold), float(cfg.fast_min_threshold))
            if two_pass
            else (float(cfg.fast_threshold),)
        )
        scores = _fast_score(img_l, *ths)
        # kill borders (circle radius + descriptor patch)
        b = cfg.border
        border_mask = jnp.zeros((Hl, Wl), bool).at[b : Hl - b, b : Wl - b].set(True)
        scores = [_nms3(jnp.where(border_mask, sc, 0.0)) for sc in scores]
        if two_pass:
            hi, lo = scores
            # the minThFAST retry for cells the strong pass left empty
            # (ORBextractor's per-cell fallback): strong corners carry a rank
            # bonus so weak ones only fill otherwise-unused slots
            resp = jnp.where(hi > 0.0, hi, lo)
            rank = jnp.where(hi > 0.0, hi + bonus, lo)
        else:
            resp = rank = scores[0]

        k_cell = max(1, math.ceil(budgets[level] / (cfg.grid_rows * cfg.grid_cols)))
        flat_idx, s = _grid_topk(rank, cfg.grid_rows, cfg.grid_cols, k_cell)
        py = (flat_idx // Wl).astype(jnp.int32)
        px = (flat_idx % Wl).astype(jnp.int32)
        valid = s > 0.0

        xy = jnp.stack([px, py], axis=-1)
        img_s = _smooth(img_l, cfg.smooth_width)
        # orientation from the smoothed image: the IC angle jitters badly on
        # raw pixels and every degree of jitter flips outer-radius BRIEF bits
        if cfg.steer:
            angle = _orientation(img_s, xy, cfg.half_patch)
            desc = _describe(img_s, xy, angle, pattern)
        else:
            # upright BRIEF: one patch slab per keypoint + two static
            # one-hot matmuls — no scattered gathers at all
            angle = jnp.zeros(xy.shape[0], img_l.dtype)
            patches = _patches(img_s, xy, cfg.patch_size // 2)
            desc = _describe_upright(
                patches, cfg.brief_seed, cfg.descriptor_bits, cfg.patch_size
            )

        scale = cfg.scale_factor**level
        uv0 = xy.astype(jnp.float32) * scale
        all_uv.append(uv0)
        all_rank.append(s)
        all_score.append(resp.reshape(-1)[flat_idx])  # bonus-free response
        all_angle.append(angle)
        all_level.append(jnp.full(s.shape, level, jnp.int32))
        all_desc.append(desc)
        all_valid.append(valid)

        if level + 1 < cfg.n_levels:
            Hn = max(int(round(Hl / cfg.scale_factor)), 32)
            Wn = max(int(round(Wl / cfg.scale_factor)), 32)
            img_l = jax.image.resize(img_l, (Hn, Wn), "linear")

    uv = jnp.concatenate(all_uv)
    rank = jnp.concatenate(all_rank)
    score = jnp.concatenate(all_score)
    angle = jnp.concatenate(all_angle)
    level = jnp.concatenate(all_level)
    desc = jnp.concatenate(all_desc)
    valid = jnp.concatenate(all_valid)

    # global top-K among valid candidates: strong corners first (rank bonus),
    # weak-cell fallbacks fill remaining capacity
    ranked = jnp.where(valid, rank, -1.0)
    top_r, top_i = jax.lax.top_k(ranked, cfg.max_keypoints)
    return Keypoints(
        uv=uv[top_i],
        response=score[top_i],
        angle=angle[top_i],
        level=level[top_i],
        valid=top_r > 0.0,
        desc=desc[top_i],
    )
