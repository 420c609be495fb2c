"""Typed configuration for the whole VO pipeline.

The reference scatters its operating constants across hard-coded literals
(box margins at Tracking.cc:61 / pnpmatch.cc:108, Hamming gates at
pnpmatch.cc:101,192, epipolar threshold at pnpmatch.cc:115, RANSAC params at
pnpmatch.cc:227, window size at Tracking.cc:244, MSA cost constants at
Thirdparty/MB/MSA.cpp:30-32, N=500 keypoint capacity at frame.cc:54) plus an
OpenCV YAML file for intrinsics (Tracking.cc:24-39).  Here every knob lives in
one frozen dataclass tree so jitted functions can close over static values and
the whole pipeline is reproducible from a single object.

All shapes are static: keypoint/map capacities are fixed and masked, which is
what XLA needs and also removes the reference's out-of-bounds classes of bug
(SURVEY.md §7 "Behavioral quirks").
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Stereo pinhole camera (reference: Stereo/KITTI00-02.yaml, Tracking.cc:24-39)."""

    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    bf: float = 386.1448       # baseline * fx  (depth = bf / disparity, frame.cc:160)
    width: int = 1241
    height: int = 376
    fps: float = 10.0
    th_depth: float = 35.0     # close/far threshold in units of baseline

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @classmethod
    def kitti_00_02(cls) -> "CameraConfig":
        return cls()

    @classmethod
    def kitti_04_12(cls) -> "CameraConfig":
        # reference: Stereo/KITTI04-12.yaml
        return cls(fx=707.0912, fy=707.0912, cx=601.8873, cy=183.1104,
                   bf=379.8145, width=1226, height=370, th_depth=40.0)


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB frontend. The reference uses cv::ORB defaults (500 features, 8
    levels, scale 1.2 — frame.cc:75-79); its YAML asks for 2000/grid
    distribution (KITTI00-02.yaml:36-51) but that section is vestigial.

    This design detects on a fixed pyramid with per-cell top-k selection so
    every shape is static.  max_keypoints is padded to a power-of-two 512.
    """

    max_keypoints: int = 512          # fixed slot count (reference N=500, frame.cc:54)
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: int = 20          # iniThFAST
    fast_min_threshold: int = 7       # minThFAST fallback
    patch_size: int = 31              # rBRIEF sampling patch
    half_patch: int = 15              # orientation intensity-centroid radius
    grid_rows: int = 8                # per-cell top-k keypoint distribution
    grid_cols: int = 16
    border: int = 19                  # no detection within this margin
    descriptor_bits: int = 256
    brief_seed: int = 0x0B5E55ED      # deterministic rBRIEF sampling pattern
    smooth_width: int = 9             # box-blur width before BRIEF sampling
                                      # (wide blur = fewer bit flips under
                                      # sub-pixel appearance change)
    steer: bool = True                # rotate the pattern by the IC angle
                                      # (False = upright BRIEF: more stable
                                      # bits when the platform has no roll)


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Stereo disparity. Sparse mode correlates a 1-D window along the
    epipolar line at keypoints only (all the VO pipeline consumes,
    frame.cc:122-164); dense mode is the full cost-volume engine standing in
    for the reference's MSA spanning-tree aggregation (Thirdparty/MB/MSA.cpp).
    """

    max_disparity: int = 48           # reference solves d∈[0,48] (frame.cc:87)
    block_radius: int = 3             # matching window radius (sparse + dense)
    # cost-volume mixing, mirrors MSA's 0.11*color + 0.89*gradient with
    # truncations 7.0 / 2.0 (MSA.cpp:30-32, 78-108)
    color_weight: float = 0.11
    grad_weight: float = 0.89
    color_trunc: float = 7.0
    grad_trunc: float = 2.0
    # SGM-style scanline aggregation penalties (dense mode)
    p1: float = 1.0
    p2: float = 8.0
    # edge-aware smoothing: P2 shrinks across intensity edges,
    # P2'(p) = p1 + (p2 - p1) * exp(-|dI(p)| / edge_p2_gamma) along each
    # scan direction — the SGM analogue of MSA's color-difference tree
    # weights (Thirdparty/MB/MSA.cpp:152-191: edges directed low->high
    # gradient with exp(-c/(sigma*255)) similarity).  False = classic
    # constant-P2 SGM (the pre-round-5 behavior).
    edge_p2: bool = False
    edge_p2_gamma: float = 10.0
    # scanline aggregation backend: "pallas" (the Triton scanline kernel,
    # kernels/sgm_scan.py, on CUDA GPUs; lax.scan on every other platform)
    # | "xla" (lax.scan everywhere, one cross-section per step)
    dense_backend: str = "pallas"
    lr_consistency_px: float = 1.0    # LR check tolerance (MSA LRcheck, MSA.cpp:1027)
    refine: bool = True               # LR-guided third aggregation pass that
                                      # repairs inconsistent pixels
                                      # (MSA solve :1163-1167)
    uniqueness_ratio: float = 0.95
    min_disparity: float = 0.5        # below this the match is invalid
    sparse_mode: str = "strips"       # "strips" (per-keypoint gathers) |
                                      # "volume" (whole-image shifted maps) |
                                      # "dense" (dense_disparity sampled at
                                      # the keypoints)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Brute-force 256-bit Hamming matching gates (pnpmatch.cc:61-199)."""

    last_frame_max_dist: int = 15     # accept gate vs last frame (pnpmatch.cc:101)
    local_map_max_dist: int = 30      # accept gate vs local map (pnpmatch.cc:192)
    local_map_ratio: float = 2.0      # second-best / best ratio gate (pnpmatch.cc:192)
    epipolar_threshold: float = 0.1   # point-to-epiline distance: moving object test (pnpmatch.cc:115)
    box_margin_init: float = 5.0      # detection-box margin when creating points (Tracking.cc:61)
    box_margin_match: float = 10.0    # detection-box margin in 2D-2D matching (pnpmatch.cc:108)
    # motion-prior spatial gate: reject a descriptor match whose keypoint
    # lies farther than this (px) from the map point's projection under the
    # constant-velocity pose prediction.  Repetitive street texture (fence
    # pickets, lane dashes) aliases pure-descriptor matching into consistent
    # wrong consensus sets that RANSAC *accepts* — the guided-search window every
    # ORB-SLAM-class matcher uses, absent from the reference's free matching
    # (pnpmatch.cc:61-199).  0 disables (reference-faithful).
    search_radius_px: float = 0.0
    backend: str = "popcount"         # "popcount" (XOR + population count) |
                                      # "mxu" (+-1 int8 matmul)

    @property
    def use_mxu(self) -> bool:
        return self.backend == "mxu"


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    """RANSAC PnP (reference cv::solvePnPRansac(100, 8.0, 0.99), pnpmatch.cc:227).

    Accelerator-shaped: a fixed batch of hypotheses solved in parallel with
    vmapped minimal solvers and argmax-by-inlier-count instead of a
    sequential loop.
    """

    num_hypotheses: int = 256
    sample_size: int = 6              # DLT minimal-ish sample
    inlier_px: float = 8.0
    refine_iters: int = 5             # Gauss-Newton polish on best inlier set
    min_inliers: int = 10
    seed: int = 0
    # physical plausibility: reject a pose that lands farther than this (m)
    # from the constant-velocity prediction.  Repetitive-texture aliasing can
    # assemble a consistent wrong consensus that teleports the pose by tens
    # of meters (and poisons the velocity model with it); a vehicle cannot
    # do that between frames.  0 disables (reference-faithful: the reference
    # accepts any solvePnPRansac result, pnpmatch.cc:245-247).
    pose_jump_max_m: float = 0.0
    # inlier-count escape hatch for the jump gate: accept a "jumping" pose
    # anyway when its consensus has at least this many inliers (0 = no
    # escape, the pre-round-5 behavior).  Trade-off by operating point: at
    # 20 Hz the dominant threat is aliased consensus (56 m texture twins
    # CAN assemble large wrong consensus sets — keep 0); at native 10 Hz
    # per-frame motion, one bad pose poisons the velocity model and the
    # unconditional gate then rejects every CORRECT pose as a jump — a
    # measured death spiral (0 matches for 30+ frames, docs/ACCURACY.md
    # "Native 10 Hz") that a strong-consensus escape breaks.
    pose_jump_escape_inliers: int = 0
    # motion-model sanity cap: a per-frame velocity update whose translation
    # exceeds this (m/frame) is discarded (the previous velocity is kept).
    # A poisoned velocity poisons every downstream prior — the spatial match
    # gate, PnP seeding, and the plausibility gate all predict with it.
    # 0 disables.
    max_velocity_m: float = 0.0
    # inlier-count bonus for the constant-velocity seed hypothesis: under
    # degenerate geometry (matches clustered on one structure) several poses
    # tie within noise, and argmax picks arbitrarily — the prior should win
    # unless a sampled hypothesis beats it by a real margin.  0 disables.
    seed_bonus: int = 0


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Levenberg-Marquardt bundle adjustment (reference g2o motion-only BA:
    Huber delta sqrt(5.991), 10 iterations, dense 6x6 solve, Optimizer.cc:15-86).
    """

    iterations: int = 10
    huber_delta: float = 5.991 ** 0.5
    init_lambda: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    # trimmed motion BA: observations farther than this (px) from the seed
    # pose are excluded (classified once at the seed pose; a mid-scan
    # reclassification was removed for its ~7x compile-time cost) — the
    # outlier rejection of ORB-SLAM-class pose optimizers that the
    # reference's single optimize(10) lacks (Optimizer.cc:75-86).
    # 0 disables (reference-faithful single pass; the default — trimming
    # assumes a RANSAC-grade seed, which bare motion_only_ba callers may
    # not have).
    trim_px: float = 0.0
    # local BA (sliding window poses + landmarks, Schur complement)
    local_iterations: int = 5
    max_landmarks: int = 2048
    # stereo residual row (u_R = u - bf/z) in POSE optimization — motion BA
    # and the RANSAC polish.  The reference's pose optimizer is mono-only
    # (Optimizer.cc:42-74, EdgeSE3ProjectXYZOnlyPose), which leaves
    # translation-along-depth weakly constrained when the consensus is
    # far-field-dominated (at native 10 Hz motion: >1.5 m pose error with
    # every mono gate satisfied — docs/ACCURACY.md).  False =
    # reference-faithful mono.
    stereo_pose: bool = False


@dataclasses.dataclass(frozen=True)
class SemanticConfig:
    """Semantic dynamic-object masking (reference: YOLO thread semantic.cc /
    offline boxes main.cpp:59-97)."""

    max_boxes: int = 32               # fixed detection-box slots per frame
    online_conf_threshold: float = 0.8   # online yolov2-tiny gate (semantic.cc:31)
    offline_conf_threshold: float = 0.05  # offline YOLOv3 boxes (bin/Readme.txt)
    nms_iou: float = 0.45             # darknet do_nms_sort default (yolo_v3.c:31)
    input_size: int = 352             # yolov2-tiny.cfg width/height


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    """Sliding-window local map (reference prunes create_id <= frame_num-4,
    Tracking.cc:239-250: a 4-frame window; capacity = window * max_keypoints)."""

    window_frames: int = 4
    # ring-buffer capacity for local map points
    max_map_points: int = 2048


@dataclasses.dataclass(frozen=True)
class VOConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    stereo: StereoConfig = dataclasses.field(default_factory=StereoConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    pnp: PnPConfig = dataclasses.field(default_factory=PnPConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    semantic: SemanticConfig = dataclasses.field(default_factory=SemanticConfig)
    window: WindowConfig = dataclasses.field(default_factory=WindowConfig)
    use_semantics: bool = True
    use_local_map: bool = True
    dtype: str = "float32"

    @classmethod
    def kitti(cls, sequence: str = "00") -> "VOConfig":
        """KITTI intrinsics + the execution forms that won on an H100.

        The two XLA forms of sparse stereo and of the Hamming matcher were
        timed against each other at these widths on the card (PERF.md,
        "Findings"); the winners are set here.  Upright BRIEF
        (steer=False) turns description into two static one-hot matmuls and
        is *more* stable than steered BRIEF on a roll-free vehicle
        platform."""
        seq = int(sequence)
        cam = CameraConfig.kitti_00_02() if seq <= 3 else CameraConfig.kitti_04_12()
        return cls(
            camera=cam,
            orb=ORBConfig(steer=False),
            matcher=MatcherConfig(backend="popcount", search_radius_px=150.0),
            pnp=PnPConfig(pose_jump_max_m=1.5, seed_bonus=8, max_velocity_m=4.0),
            # edge-aware P2 (gamma=5): measured winner on every urban
            # fixture vs the MSA goldens (+2-4.5pp agree@3px; the 8-path
            # variant measured a wash and stays out — docs/REAL_IMAGES.md)
            stereo=StereoConfig(sparse_mode="strips", edge_p2=True,
                                edge_p2_gamma=5.0),
            ba=BAConfig(trim_px=10.0),
        )

    @property
    def image_shape(self) -> Tuple[int, int]:
        return (self.camera.height, self.camera.width)
