"""Multi-stream tracking throughput on ONE device: the batch probe.

The single-stream tracking step is a chain of small ops (512-keypoint
tensors), so batch is the structural lever — SURVEY.md §2.3-1's in-device
data parallelism, with no reference analogue (the reference tracks one
sequence on one CPU, main.cpp:159-195).  This benchmark measures it: B
independent sequence streams vmapped through the full tracking step.

For each B in {1, 2, 4, 8, 16}: B VOStates, frames batched (B, H, W),
``vmap(track_step)`` inside bench.py's chunk-scan streaming harness
(completion is a pose-tensor readback).  Reported: aggregate frames/sec,
per-stream fps, and scaling efficiency vs B=1.

Each stream slides over a different offset of the real urban texture so the
B streams do not share identical control flow outcomes.

Run: python benchmarks/multistream_bench.py   (writes multistream_bench.json)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCHES = (1, 2, 4, 8, 16)
CHUNK = 16
REPS = 6


def main() -> None:
    import jax
    import jax.numpy as jnp

    from stereo_semantic_vo_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from bench import real_frame_source, synthetic_frame_source
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

    results = {"chunk": CHUNK, "reps": REPS, "batches": {}}
    base_fps = None
    for B in BATCHES:
        # per-stream time offsets decorrelate the control flow across streams
        def bframe(t):
            fs = [frame_input(t + 7 * b) for b in range(B)]
            return jax.tree.map(lambda *xs: jnp.stack(xs), *fs)

        states = jax.vmap(lambda i: init_state(cfg))(jnp.arange(B))
        s0f = bframe(0)
        states, _ = jax.jit(jax.vmap(lambda s, f: init_step(s, f, cfg)))(states, s0f)

        chunks = []
        for c in range(2):
            frames = [bframe(1 + c * CHUNK + t) for t in range(CHUNK)]
            chunks.append(jax.tree.map(lambda *xs: jnp.stack(xs), *frames))

        @jax.jit
        def run_chunk(s0, chunk):
            def step(s, f):
                s2, out = jax.vmap(lambda si, fi: track_step(si, fi, cfg))(s, f)
                return s2, out.T_cw

            return jax.lax.scan(step, s0, chunk)

        t_c0 = time.perf_counter()
        states, poses = run_chunk(states, chunks[0])  # compile + warm
        poses.block_until_ready()
        compile_s = time.perf_counter() - t_c0

        t0 = time.perf_counter()
        for i in range(REPS):
            states, poses = run_chunk(states, chunks[i % 2])
        poses.block_until_ready()
        frame_s = (time.perf_counter() - t0) / (REPS * CHUNK)
        agg_fps = B / frame_s
        if base_fps is None:
            base_fps = agg_fps
        results["batches"][str(B)] = {
            "aggregate_fps": round(agg_fps, 1),
            "per_stream_fps": round(agg_fps / B, 1),
            "efficiency_vs_b1": round(agg_fps / (base_fps * B), 3),
            "compile_s": round(compile_s, 1),
        }
        print(
            f"B={B:2d}: aggregate {agg_fps:8.1f} fps | per-stream "
            f"{agg_fps / B:6.1f} fps | eff {agg_fps / (base_fps * B):.2f} "
            f"| compile {compile_s:.0f}s",
            flush=True,
        )

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "multistream_bench.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
