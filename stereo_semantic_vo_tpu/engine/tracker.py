"""The per-frame tracking step — the reference's Tracking::Track
(src/Tracking.cc:180-252) re-designed as one pure jitted function.

Per frame (all fixed shapes, everything masked):

1. ORB extract on the left image (frame.cc:75-79 -> ops/orb.py).
2. Sparse epipolar stereo -> per-keypoint depth (frame.cc:82-164 ->
   ops/stereo.py).
3. Match last frame's map-point-bearing keypoints to current keypoints
   (Hamming gate < 15, pnpmatch.cc:61-101) with per-target conflict
   resolution by scatter-min.
4. Epipolar moving-object test for matches inside detection boxes
   (F from background matches, distance > 0.1 px => map point poisoned;
   pnpmatch.cc:103-144) — the semantic dynamic-culling step.
5. Match surviving local-map points (window regions older than the last
   frame) with gate < 30 and second/best ratio > 2 (pnpmatch.cc:160-199).
6. Batched RANSAC-PnP seeded with the constant-velocity prediction
   (pnpmatch.cc:212-247) + motion-only LM BA with Huber (Optimizer.cc).
7. Create map points for unmatched keypoints with valid depth outside
   detection boxes (frame.cc:182-238), writing the ring-buffer region of
   this frame; window pruning falls out of the create-id age mask
   (Tracking.cc:239-250).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_semantic_vo_tpu.core import lie
from stereo_semantic_vo_tpu.core.camera import Camera, backproject
from stereo_semantic_vo_tpu.core.config import VOConfig
from stereo_semantic_vo_tpu.engine.state import TrackOutputs, VOState, init_state
from stereo_semantic_vo_tpu.kernels import hamming
from stereo_semantic_vo_tpu.ops import ba as ba_ops
from stereo_semantic_vo_tpu.ops import epipolar as epi_ops
from stereo_semantic_vo_tpu.ops import orb as orb_ops
from stereo_semantic_vo_tpu.ops import pnp as pnp_ops
from stereo_semantic_vo_tpu.ops import stereo as stereo_ops
from stereo_semantic_vo_tpu.core.precision import f32_geometry

_BIG = jnp.int32(1 << 30)


class FrameInput(NamedTuple):
    left: jax.Array       # (H, W) float32 grayscale [0, 255]
    right: jax.Array      # (H, W) float32
    boxes: jax.Array      # (B, 4) float32 [x1, y1, x2, y2] detection boxes
    boxes_valid: jax.Array  # (B,) bool


def _resolve_matches(q_valid, best_tidx, best_dist, accept, n_train):
    """Many queries may claim one train keypoint; keep the lowest distance.

    Encodes (dist, query) into one int so a single scatter-min resolves both
    the winner and its distance.  Returns per-train (matched, q_idx)."""
    Kq = q_valid.shape[0]
    qidx = jnp.arange(Kq)
    code = best_dist * Kq + qidx
    code = jnp.where(accept & q_valid, code, _BIG)
    per_train = jnp.full((n_train,), _BIG, jnp.int32).at[best_tidx].min(code)
    matched = per_train < _BIG
    q_of_train = jnp.where(matched, per_train % Kq, 0)
    return matched, q_of_train


def _project_uv(cam, T_cw, Xw):
    """Project (N, 3) world points under T_cw -> ((N, 2) pixels, (N,) depth)."""
    pc = lie.transform_points(T_cw, Xw)
    z = pc[..., 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-6, z, 1e-6)
    u = cam.fx * pc[..., 0] / safe_z + cam.cx
    v = cam.fy * pc[..., 1] / safe_z + cam.cy
    return jnp.stack([u, v], axis=-1), z


def _region_slots(frame_idx, region_frame, K, W):
    """Slot offsets of the ring region belonging to ``region_frame``."""
    r = jnp.mod(region_frame, W)
    return r * K + jnp.arange(K)


def _set_region(arr, region_frame, K, W, src):
    """Write a whole ring region as a dynamic_update_slice — the region is
    contiguous, and DUS compiles to a copy instead of a scatter."""
    start = jnp.mod(region_frame, W) * K
    idx = (start,) + (jnp.zeros((), jnp.int32),) * (arr.ndim - 1)
    return jax.lax.dynamic_update_slice(arr, src.astype(arr.dtype), idx)


@functools.partial(jax.jit, static_argnames=("cfg",))
@f32_geometry
def init_step(state: VOState, frame: FrameInput, cfg: VOConfig) -> tuple[VOState, TrackOutputs]:
    """Map (re)initialization.

    Frame-0 path (Tracking::init, Tracking.cc:42-97): pose = I (fresh state),
    back-project every keypoint with valid depth outside detection boxes.
    Called on a mid-sequence state it *reseeds* instead: keeps the current
    pose, rebuilds the map from this frame — the tracking-lost recovery the
    reference lacks (SURVEY §5: PnP degeneration silently produces garbage).
    """
    cam = Camera.from_config(cfg.camera)
    kp = orb_ops.extract_orb(frame.left, cfg.orb)
    st = stereo_ops.sparse_disparity(frame.left, frame.right, kp.uv, kp.valid, cam, cfg.stereo)

    in_box = epi_ops.in_box_mask(kp.uv, frame.boxes, frame.boxes_valid, cfg.matcher.box_margin_init)
    # far-point gate: stereo depth beyond ThDepth baselines is too uncertain
    # to seed the map (ThDepth, Stereo/KITTI00-02.yaml:31 — vestigial in the
    # reference's code but honored here as the ORB-SLAM close/far semantics)
    near = st.depth <= (cfg.camera.bf / cfg.camera.fx) * cfg.camera.th_depth
    create = kp.valid & st.valid & near & ~in_box

    t = jnp.maximum(state.frame_idx + 1, 0)
    T_cw = state.T_cw  # identity on a fresh state; current pose on reseed
    Xc = backproject(cam, kp.uv, st.depth)
    Xw = lie.transform_points(lie.T_inv(T_cw), Xc[None])[0]

    K = cfg.orb.max_keypoints
    W = cfg.window.window_frames
    if cfg.matcher.use_mxu:
        kp_pm1 = hamming.unpack_descriptors_pm1(kp.desc)
    else:
        kp_pm1 = jnp.zeros((K, 256), jnp.int8)
    uid = t * K + jnp.arange(K)
    new_state = state._replace(
        frame_idx=t,
        T_cw=T_cw,
        # a mid-sequence reseed usually follows a lost stretch whose velocity
        # estimate can no longer be trusted — restart the motion model from
        # rest so the prior-driven gates cannot deadlock on a stale prediction
        velocity=jnp.eye(4, dtype=state.velocity.dtype),
        last_uv=kp.uv,
        last_desc=kp.desc,
        last_desc_pm1=kp_pm1,
        last_valid=kp.valid,
        map_Xw=_set_region(state.map_Xw, t, K, W, Xw),
        map_desc=_set_region(state.map_desc, t, K, W, kp.desc),
        map_desc_pm1=_set_region(state.map_desc_pm1, t, K, W, kp_pm1),
        map_valid=_set_region(state.map_valid, t, K, W, create),
        map_bad=_set_region(state.map_bad, t, K, W, jnp.zeros((K,), bool)),
        map_create_id=_set_region(state.map_create_id, t, K, W, jnp.where(create, t, -100)),
        map_uid=_set_region(state.map_uid, t, K, W, jnp.where(create, uid, -1)),
        win_T_cw=state.win_T_cw.at[jnp.mod(t, W)].set(T_cw),
        win_uv=state.win_uv.at[jnp.mod(t, W)].set(kp.uv),
        win_disp=state.win_disp.at[jnp.mod(t, W)].set(
            jnp.where(st.valid, st.disparity, -1.0)
        ),
    )
    n = jnp.sum(create)
    zero = jnp.asarray(0, jnp.int32)
    return new_state, TrackOutputs(
        T_cw=T_cw, T_wc=lie.T_inv(T_cw),
        n_keypoints=jnp.sum(kp.valid), n_stereo=jnp.sum(st.valid),
        n_matches_last=zero, n_matches_map=zero, n_pnp_inliers=zero,
        n_ba_inliers=zero, n_new_points=n, n_culled_dynamic=zero,
        pnp_ok=jnp.asarray(True),
        kp_uv=kp.uv, obs_uid=jnp.where(create, uid, -1), obs_valid=create,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
@f32_geometry
def track_step(state: VOState, frame: FrameInput, cfg: VOConfig) -> tuple[VOState, TrackOutputs]:
    cam = Camera.from_config(cfg.camera)
    K = cfg.orb.max_keypoints
    W = cfg.window.window_frames
    t = state.frame_idx + 1  # index of the frame being processed

    # ---- 1+2. frontend -----------------------------------------------------
    kp = orb_ops.extract_orb(frame.left, cfg.orb)
    st = stereo_ops.sparse_disparity(frame.left, frame.right, kp.uv, kp.valid, cam, cfg.stereo)

    age_ok = state.map_create_id > t - W
    live = state.map_valid & ~state.map_bad & age_ok

    # ---- 3. last-frame matching (gate < 15) --------------------------------
    # int8 matmul form: hamming = (256 - <+-1 descs>) / 2;
    # popcount form: XOR + lax.population_count on the packed words
    if cfg.matcher.use_mxu:
        kp_pm1 = hamming.unpack_descriptors_pm1(kp.desc)
    else:
        kp_pm1 = jnp.zeros((K, 256), jnp.int8)
    last_slots = _region_slots(t, t - 1, K, W)
    live_last = jax.lax.dynamic_slice_in_dim(live, jnp.mod(t - 1, W) * K, K, axis=0)
    last_has_mp = state.last_valid & live_last
    T_pred = state.velocity @ state.T_cw
    if cfg.matcher.use_mxu:
        dist_last = hamming.hamming_distance_matrix_mxu(state.last_desc_pm1, kp_pm1)
    else:
        dist_last = hamming.hamming_distance_matrix(state.last_desc, kp.desc)
    b_idx, b_dist, _ = hamming.masked_best_match(dist_last, last_has_mp, kp.valid)
    accept3 = b_dist < cfg.matcher.last_frame_max_dist
    if cfg.matcher.search_radius_px > 0:
        # motion-prior gate: the winner must land near its map point's
        # projection under the constant-velocity prediction (kills the
        # consistent aliases repetitive street texture produces, which
        # RANSAC would otherwise *accept* as a wrong consensus)
        uv_pred3, z_pred3 = _project_uv(
            cam, T_pred, state.map_Xw[last_slots]
        )
        d3 = jnp.sum((kp.uv[b_idx] - uv_pred3) ** 2, axis=-1)
        accept3 = accept3 & (d3 <= cfg.matcher.search_radius_px**2) & (z_pred3 > 0.05)
    m3, q3 = _resolve_matches(last_has_mp, b_idx, b_dist, accept3, K)
    # per-cur-kp slot of the matched map point
    slot3 = last_slots[q3]

    # ---- 4. semantic dynamic culling ---------------------------------------
    matched_uv_last = state.last_uv[q3]
    in_box_cur = epi_ops.in_box_mask(kp.uv, frame.boxes, frame.boxes_valid, cfg.matcher.box_margin_match)
    background = m3 & ~in_box_cur
    F = epi_ops.fit_fundamental(matched_uv_last, kp.uv, background.astype(jnp.float32))
    dd = epi_ops.epipolar_distance(F, matched_uv_last, kp.uv)
    dynamic = m3 & in_box_cur & (dd > cfg.matcher.epipolar_threshold) if cfg.use_semantics else jnp.zeros_like(m3)
    n_culled = jnp.sum(dynamic)
    # poison the map point and drop the match (pnpmatch.cc:141); scatter-max
    # ORs the dynamic verdicts into the bad bitmask (duplicate slots safe)
    map_bad = state.map_bad.at[slot3].max(dynamic)
    m3 = m3 & ~dynamic

    # ---- 5. local-map matching (gate < 30, ratio > 2) ----------------------
    # regions older than the last frame (the last frame's own points were
    # already candidates in stage 3)
    slot_ids = jnp.arange(state.map_valid.shape[0])
    last_region = jnp.mod(t - 1, W)
    region_of_slot = slot_ids // K
    in_last_region = region_of_slot == last_region
    map_candidates = live & ~in_last_region & ~map_bad
    cur_free = kp.valid & ~m3
    if cfg.use_local_map:
        if cfg.matcher.use_mxu:
            dist_map = hamming.hamming_distance_matrix_mxu(state.map_desc_pm1, kp_pm1)
        else:
            dist_map = hamming.hamming_distance_matrix(state.map_desc, kp.desc)
        mb_idx, mb_dist, mb_second = hamming.masked_best_match(dist_map, map_candidates, cur_free)
        accept5 = (mb_dist < cfg.matcher.local_map_max_dist) & (
            mb_second.astype(jnp.float32) > cfg.matcher.local_map_ratio * mb_dist.astype(jnp.float32)
        )
        if cfg.matcher.search_radius_px > 0:
            uv_pred5, z_pred5 = _project_uv(cam, T_pred, state.map_Xw)
            d5 = jnp.sum((kp.uv[mb_idx] - uv_pred5) ** 2, axis=-1)
            accept5 = accept5 & (d5 <= cfg.matcher.search_radius_px**2) & (
                z_pred5 > 0.05
            )
        m5, q5 = _resolve_matches(map_candidates, mb_idx, mb_dist, accept5, K)
        m5 = m5 & ~m3
    else:
        m5 = jnp.zeros_like(m3)
        q5 = jnp.zeros((K,), jnp.int32)
    slot5 = q5

    # ---- 6. pose estimation -------------------------------------------------
    mp_slot = jnp.where(m3, slot3, slot5)
    has_obs = m3 | m5
    obs_Xw = state.map_Xw[mp_slot]
    ur = urm = None
    if cfg.ba.stereo_pose:
        # stereo residual row for pose optimization: the current frame's
        # own disparity measurement u_R = u - d pins translation-along-
        # depth where a far-field-dominated mono consensus cannot
        # (BAConfig.stereo_pose; the reference's pose optimizer is
        # mono-only, Optimizer.cc:42-74)
        ur = kp.uv[:, 0] - st.disparity
        urm = has_obs & st.valid
    pnp = pnp_ops.ransac_pnp(
        obs_Xw, kp.uv, has_obs, cam, cfg.pnp,
        key=jax.random.fold_in(jax.random.PRNGKey(cfg.pnp.seed), t),
        T_seed=T_pred,
        ur=ur, ur_mask=urm,
    )
    ba = ba_ops.motion_only_ba(
        pnp.T_cw, obs_Xw, kp.uv, has_obs, cam, cfg.ba, ur=ur, ur_mask=urm
    )
    # consensus guard: accept the BA pose only if it keeps (most of) the
    # RANSAC consensus — an optimization that sheds the inlier set was
    # captured by outliers, and the PnP pose is the better estimate.  The
    # reference trusts optimize(10) unconditionally (Tracking.cc via
    # Optimizer.cc:75-86); this is part of the §5 failure-detection layer.
    ba_keeps = jnp.sum(ba.inlier_mask) >= jnp.maximum(
        pnp.n_inliers // 2, cfg.pnp.min_inliers
    )
    T_est = jnp.where(ba_keeps, ba.T_cw, pnp.T_cw)
    # guard: if PnP failed (too few inliers), fall back to the motion model
    ok = pnp.ok
    if cfg.pnp.pose_jump_max_m > 0:
        # physical plausibility: a pose that teleports away from the motion
        # prediction is an aliased or degenerate consensus — a vehicle cannot
        # move that far between frames.  Rejecting it (falling back to the
        # prediction, with reseed-after-lost as the re-lock path) keeps the
        # velocity model sane, so the motion-prior gates recover instead of
        # deadlocking.  By default there is no inlier-count escape hatch
        # (repetitive texture can assemble arbitrarily large wrong consensus
        # sets — 56 m scene twins); at high per-frame motion the opposite
        # failure dominates (a poisoned prediction rejects every correct
        # pose), so cfg.pnp.pose_jump_escape_inliers > 0 lets an
        # overwhelming consensus override the gate and re-lock tracking.
        jump = jnp.linalg.norm((T_est @ lie.T_inv(T_pred))[:3, 3])
        plausible = jump <= cfg.pnp.pose_jump_max_m
        if cfg.pnp.pose_jump_escape_inliers > 0:
            plausible = plausible | (
                pnp.n_inliers >= cfg.pnp.pose_jump_escape_inliers
            )
        ok = ok & plausible & jnp.all(jnp.isfinite(T_est))
    T_cw = jnp.where(ok, T_est, T_pred)

    # ---- 7. map maintenance -------------------------------------------------
    in_box_create = epi_ops.in_box_mask(kp.uv, frame.boxes, frame.boxes_valid, cfg.matcher.box_margin_init)
    # same ThDepth far-point creation gate as init_step
    near = st.depth <= (cfg.camera.bf / cfg.camera.fx) * cfg.camera.th_depth
    create = kp.valid & st.valid & near & ~has_obs & ~in_box_create
    T_wc = lie.T_inv(T_cw)
    Xc = backproject(cam, kp.uv, st.depth)
    Xw_new = lie.transform_points(T_wc, Xc[None])[0]

    slots_t = _region_slots(t, t, K, W)
    # every current keypoint's attached map point lands in region t:
    # matched -> copy of the matched slot (original create_id preserved),
    # created -> fresh entry, else -> invalid slot
    src_Xw = jnp.where(has_obs[:, None], state.map_Xw[mp_slot], Xw_new)
    src_desc = jnp.where(has_obs[:, None], state.map_desc[mp_slot], kp.desc)
    src_pm1 = jnp.where(
        has_obs[:, None], state.map_desc_pm1[mp_slot], kp_pm1
    )
    src_create = jnp.where(has_obs, state.map_create_id[mp_slot], t)
    src_uid = jnp.where(has_obs, state.map_uid[mp_slot], t * K + jnp.arange(K))
    src_valid = has_obs | create
    src_bad = jnp.where(has_obs, map_bad[mp_slot], False)

    velocity = T_cw @ lie.T_inv(state.T_cw)
    if cfg.pnp.max_velocity_m > 0:
        vel_sane = (
            jnp.linalg.norm(velocity[:3, 3]) <= cfg.pnp.max_velocity_m
        ) & jnp.all(jnp.isfinite(velocity))
        velocity = jnp.where(vel_sane, velocity, state.velocity)

    new_state = state._replace(
        frame_idx=t,
        T_cw=T_cw,
        velocity=velocity,
        last_uv=kp.uv,
        last_desc=kp.desc,
        last_desc_pm1=kp_pm1,
        last_valid=kp.valid,
        map_Xw=_set_region(state.map_Xw, t, K, W, src_Xw),
        map_desc=_set_region(state.map_desc, t, K, W, src_desc),
        map_desc_pm1=_set_region(state.map_desc_pm1, t, K, W, src_pm1),
        map_valid=_set_region(state.map_valid, t, K, W, src_valid),
        map_bad=_set_region(map_bad, t, K, W, src_bad),
        map_create_id=_set_region(state.map_create_id, t, K, W, jnp.where(src_valid, src_create, -100)),
        map_uid=_set_region(state.map_uid, t, K, W, jnp.where(src_valid, src_uid, -1)),
        win_T_cw=state.win_T_cw.at[jnp.mod(t, W)].set(T_cw),
        win_uv=state.win_uv.at[jnp.mod(t, W)].set(kp.uv),
        win_disp=state.win_disp.at[jnp.mod(t, W)].set(
            jnp.where(st.valid, st.disparity, -1.0)
        ),
    )
    return new_state, TrackOutputs(
        T_cw=T_cw,
        T_wc=T_wc,
        n_keypoints=jnp.sum(kp.valid),
        n_stereo=jnp.sum(st.valid),
        n_matches_last=jnp.sum(m3),
        n_matches_map=jnp.sum(m5),
        n_pnp_inliers=pnp.n_inliers,
        n_ba_inliers=jnp.sum(ba.inlier_mask),
        n_new_points=jnp.sum(create),
        n_culled_dynamic=n_culled,
        pnp_ok=ok,
        kp_uv=kp.uv,
        obs_uid=jnp.where(src_valid, src_uid, -1),
        obs_valid=src_valid,
    )


def make_tracker(cfg: VOConfig):
    """Returns (state0, step) where step(state, frame) dispatches init/track."""
    state0 = init_state(cfg)

    def step(state: VOState, frame: FrameInput):
        return jax.lax.cond(
            state.frame_idx < 0,
            lambda s, f: init_step(s, f, cfg),
            lambda s, f: track_step(s, f, cfg),
            state, frame,
        )

    return state0, step
