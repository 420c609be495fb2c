"""Online-mode (detector-in-loop) throughput vs offline mode, one device.

The reference's online mode runs yolov2-tiny on a GPU thread so detection
latency overlaps tracking on the CPU (/root/reference/src/semantic.cc:13-45).
Here the CNN and the tracker share one device,
so "hiding" means the detector adds its own device time to the stream but
never blocks the host (engine/pipeline.py async_detect) — the honest online
number is throughput with the CNN dispatched every frame.

Measured here with the same chunk-scan methodology as bench.py: each scan
step tracks frame t using the boxes detected on frame t-1 (the one-frame
staleness the reference's thread exhibits), then runs the detector on frame
t for the next step.  Detector: the KITTI tiny-v2 replica (models/zoo.py,
layer-by-layer per bin/kitti/yolov2-tiny.cfg) with random weights — the
reference's .weights blobs are stripped from this environment; random
weights exercise identical FLOPs/memory, only the box contents differ.

Run: python benchmarks/online_bench.py   (writes benchmarks/online_bench.json)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from stereo_semantic_vo_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from bench import real_frame_source, synthetic_frame_source
    from stereo_semantic_vo_tpu.core.config import VOConfig
    from stereo_semantic_vo_tpu.engine.state import init_state
    from stereo_semantic_vo_tpu.engine.tracker import FrameInput, init_step, track_step
    from stereo_semantic_vo_tpu.models.zoo import kitti_tiny_v2

    cfg = VOConfig.kitti("00")
    H, W = cfg.camera.height, cfg.camera.width
    nb = cfg.semantic.max_boxes
    src = real_frame_source() or synthetic_frame_source()

    detector = kitti_tiny_v2(conf_threshold=cfg.semantic.online_conf_threshold,
                             max_boxes=nb)
    detect = detector._build(H, W)  # jitted (H, W, 3) -> Detections

    def frame_pair(t):
        left, right = src(t)
        return jnp.asarray(left), jnp.asarray(right)

    def frame_input(t, boxes, valid):
        left, right = frame_pair(t)
        return FrameInput(left=left, right=right, boxes=boxes, boxes_valid=valid)

    no_boxes = (jnp.zeros((nb, 4), jnp.float32), jnp.zeros((nb,), bool))

    C = 16
    reps = 4
    pairs = [frame_pair(t) for t in range(1, 1 + 2 * C)]
    stack = lambda xs: jnp.stack(xs)
    chunks = []
    for half in (pairs[:C], pairs[C:]):
        chunks.append((stack([p[0] for p in half]), stack([p[1] for p in half])))

    def make_run(online: bool):
        @jax.jit
        def run(s0, boxes0, valid0, lefts, rights):
            def step(carry, fr):
                s, boxes, valid = carry
                left, right = fr
                f = FrameInput(left=left, right=right, boxes=boxes, boxes_valid=valid)
                s2, out = track_step(s, f, cfg)
                if online:
                    det = detect(jnp.stack([left, left, left], axis=-1) / 255.0)
                    boxes, valid = det.boxes, det.valid
                return (s2, boxes, valid), out.T_cw

            (s, b, v), poses = jax.lax.scan(step, (s0, boxes0, valid0), (lefts, rights))
            return s, b, v, poses

        return run

    results = {"backend": jax.default_backend(), "chunk": C, "modes": {}}
    for mode, online in (("offline_no_detector", False), ("online_tinyv2_every_frame", True)):
        state = init_state(cfg)
        state, _ = init_step(state, frame_input(0, *no_boxes), cfg)
        run = make_run(online)
        state, b, v, poses = run(state, *no_boxes, *chunks[0])
        poses.block_until_ready()  # compile + warm
        t0 = time.perf_counter()
        for i in range(reps):
            state, b, v, poses = run(state, b, v, *chunks[i % 2])
        poses.block_until_ready()
        per_frame = (time.perf_counter() - t0) / (reps * C)
        results["modes"][mode] = {
            "fps": round(1.0 / per_frame, 2),
            "ms_per_frame": round(per_frame * 1e3, 3),
        }

    off = results["modes"]["offline_no_detector"]["ms_per_frame"]
    on = results["modes"]["online_tinyv2_every_frame"]["ms_per_frame"]
    results["detector_added_ms_per_frame"] = round(on - off, 3)
    print(json.dumps(results, indent=2))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "online_bench.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
