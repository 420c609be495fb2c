"""stereo_semantic_vo_tpu — a stereo semantic visual-odometry framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
``zssjh/stereo-semantic-vo`` (C++/CUDA): ORB feature extraction, stereo
disparity/depth, YOLO semantic masking of dynamic objects, brute-force Hamming
matching, RANSAC-PnP pose estimation, motion-only and local bundle adjustment,
and KITTI/TUM trajectory output — all as pure-functional, fixed-shape, jitted
computations for one accelerator (an NVIDIA GPU), with multi-device scaling via
``jax.sharding`` meshes (sharded Schur-complement BA, replicated semantic head).

Layout:
  core/      SE3/SO3 Lie groups, camera models, typed configuration
  kernels/   Hamming matcher forms, median filters, and the Pallas
             (Triton) scanline SGM kernel of the dense engine
  ops/       ORB frontend, stereo matching, RANSAC-PnP, epipolar tests,
             LM bundle adjustment, YOLO CNN + NMS
  engine/    per-frame jitted tracking step, sliding-window local map,
             trajectory writers
  parallel/  device mesh setup, sharded Schur-complement BA, replicated
             detection head
  io/        KITTI sequence loader, offline detection boxes, darknet
             cfg/weights loaders
  eval/      ATE / RPE trajectory metrics
  models/    semantic-detector model zoo (tiny-YOLOv2, YOLOv3 graphs)
  utils/     profiling, logging, checkpointing helpers
"""

__version__ = "0.1.0"

from stereo_semantic_vo_tpu.core.config import (  # noqa: F401
    CameraConfig,
    MatcherConfig,
    ORBConfig,
    PnPConfig,
    BAConfig,
    StereoConfig,
    SemanticConfig,
    VOConfig,
)
