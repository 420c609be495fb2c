"""Fixed-shape VO state: the device-resident replacement for the reference's
heap object graph.

The reference threads mutable ``frame*`` / ``mappoint*`` pointers and a
static ``std::vector<mappoint*> LocalMapPoints`` through the tracker
(Tracking.cc:19-20, frame.h:23-77, mappoint.h:13-34).  Here the whole thing
is one immutable pytree of fixed-size arrays:

* last-frame keypoints as (K,) masked arrays;
* the 4-frame sliding-window local map (Tracking.cc:239-250) as a ring
  buffer of W*K slots where slot ``(f % W) * K + k`` holds the map point
  attached to keypoint ``k`` of frame ``f`` — the ring layout *is* the
  frame->map-point binding, so window pruning is a create-id mask instead of
  heap erasure, and "bad" (dynamic) flags are a bitmask instead of a poisoned
  pointer (mappoint.cc bad flag set at pnpmatch.cc:141).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_semantic_vo_tpu.core.config import VOConfig


class VOState(NamedTuple):
    frame_idx: jax.Array    # () int32, index of the *last processed* frame
    T_cw: jax.Array         # (4, 4) pose of last processed frame (world->cam)
    velocity: jax.Array     # (4, 4) T_cl: last frame <- frame before it

    # last processed frame's keypoints
    last_uv: jax.Array        # (K, 2)
    last_desc: jax.Array      # (K, 8) uint32
    last_desc_pm1: jax.Array  # (K, 256) int8 +-1 — int8-matmul matching form
    last_valid: jax.Array     # (K,)

    # sliding-window local map ring buffer (M = window * K slots)
    map_Xw: jax.Array        # (M, 3) world positions
    map_desc: jax.Array      # (M, 8) uint32 descriptor snapshots
    map_desc_pm1: jax.Array  # (M, 256) int8 unpacked +-1 (int8-matmul matching form)
    map_valid: jax.Array     # (M,) slot occupied
    map_bad: jax.Array       # (M,) judged dynamic (epipolar test)
    map_create_id: jax.Array  # (M,) int32 creating frame index
    map_uid: jax.Array        # (M,) int32 globally-unique landmark id
                              # (creation frame * K + creating kp index);
                              # survives the per-frame region copies so
                              # window BA can group observations by landmark

    # device-resident observation window for local BA (ring on axis 0 by
    # frame mod W): pose and keypoint pixels of each window frame.  The uid
    # bindings live in the map ring already (slot (f%W)*K+k is keypoint k of
    # frame f), so these two tensors complete the observation graph without
    # any host-side assembly (engine/window_ba.refine_state).
    win_T_cw: jax.Array      # (W, 4, 4)
    win_uv: jax.Array        # (W, K, 2)
    win_disp: jax.Array      # (W, K) stereo disparity per keypoint (-1 none)
                             # — feeds the u_R stereo BA edge, which anchors
                             # landmark depth the way each frame measured it

    @property
    def T_wc(self) -> jax.Array:
        from stereo_semantic_vo_tpu.core import lie

        return lie.T_inv(self.T_cw)


def init_state(cfg: VOConfig) -> VOState:
    K = cfg.orb.max_keypoints
    M = cfg.window.window_frames * K
    f32, i32 = jnp.float32, jnp.int32
    return VOState(
        frame_idx=jnp.asarray(-1, i32),
        T_cw=jnp.eye(4, dtype=f32),
        velocity=jnp.eye(4, dtype=f32),
        last_uv=jnp.zeros((K, 2), f32),
        last_desc=jnp.zeros((K, 8), jnp.uint32),
        last_desc_pm1=jnp.zeros((K, 256), jnp.int8),
        last_valid=jnp.zeros((K,), bool),
        map_Xw=jnp.zeros((M, 3), f32),
        map_desc=jnp.zeros((M, 8), jnp.uint32),
        map_desc_pm1=jnp.zeros((M, 256), jnp.int8),
        map_valid=jnp.zeros((M,), bool),
        map_bad=jnp.zeros((M,), bool),
        map_create_id=jnp.full((M,), -100, i32),
        map_uid=jnp.full((M,), -1, i32),
        win_T_cw=jnp.tile(jnp.eye(4, dtype=f32), (cfg.window.window_frames, 1, 1)),
        win_uv=jnp.zeros((cfg.window.window_frames, K, 2), f32),
        win_disp=jnp.full((cfg.window.window_frames, K), -1.0, f32),
    )


class TrackOutputs(NamedTuple):
    """Per-frame diagnostics + observation bindings surfaced to the host.

    kp_uv/obs_slot/obs_valid expose which map-ring slot each current keypoint
    observed — the raw material for windowed local BA (engine/window_ba.py).
    """

    T_cw: jax.Array
    T_wc: jax.Array
    n_keypoints: jax.Array
    n_stereo: jax.Array
    n_matches_last: jax.Array
    n_matches_map: jax.Array
    n_pnp_inliers: jax.Array
    n_ba_inliers: jax.Array
    n_new_points: jax.Array
    n_culled_dynamic: jax.Array
    pnp_ok: jax.Array
    kp_uv: jax.Array     # (K, 2) current keypoint pixels
    obs_uid: jax.Array   # (K,) stable uid of the map point each kp observes (-1 none)
    obs_valid: jax.Array  # (K,) kp has a bound map point (matched or created)
