"""Scaling-efficiency benchmark for the distributed Schur-complement BA.

BASELINE.md target: >= 70% scaling efficiency from 1 device to N devices.
Measures BA iterations/sec for a fixed-size problem (strong scaling) at mesh
sizes 1, 2, 4, 8 and reports efficiency relative to the single-device run.

Runs on whatever devices are visible; force a virtual CPU mesh with
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
or run on a multi-GPU host unmodified.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    import jax.numpy as jnp

    from stereo_semantic_vo_tpu.core import Camera, CameraConfig, lie
    from stereo_semantic_vo_tpu.core.config import BAConfig
    from stereo_semantic_vo_tpu.parallel import mesh as mesh_utils
    from stereo_semantic_vo_tpu.parallel.sharded_ba import make_sharded_local_ba

    cam = Camera.from_config(CameraConfig())
    F, L = 4, 8192  # fixed problem: 4 poses, 8k landmarks
    rng = np.random.RandomState(0)
    X = np.stack(
        [rng.uniform(-15, 15, L), rng.uniform(-4, 4, L), rng.uniform(8, 50, L)],
        axis=-1,
    ).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * F)
    for f in range(F):
        poses[f][0, 3] = -0.8 * f
    pc = np.einsum("fij,lj->fli", poses[:, :3, :3], X) + poses[:, None, :3, 3]
    u = float(cam.fx) * pc[..., 0] / pc[..., 2] + float(cam.cx)
    v = float(cam.fy) * pc[..., 1] / pc[..., 2] + float(cam.cy)
    obs = np.stack([u, v], axis=-1).astype(np.float32)
    obs += rng.normal(0, 0.3, obs.shape).astype(np.float32)
    mask = pc[..., 2] > 0.5
    X0 = (X + rng.normal(0, 0.2, X.shape)).astype(np.float32)

    cfg = BAConfig(local_iterations=20)
    n_avail = len(jax.devices())
    results = {}
    base_rate = None
    for n in [1, 2, 4, 8]:
        if n > n_avail:
            break
        m = mesh_utils.make_mesh(n)
        run = make_sharded_local_ba(m, cam, cfg)
        args = (
            jnp.asarray(poses),
            jnp.asarray(X0),
            jnp.asarray(obs),
            jnp.asarray(mask),
            jnp.ones(L, bool),
        )
        r = run(*args)
        r.poses.block_until_ready()  # compile
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            r = run(*args)
        r.poses.block_until_ready()
        dt = (time.perf_counter() - t0) / reps
        iters_per_s = cfg.local_iterations / dt
        if base_rate is None:
            base_rate = iters_per_s
        results[n] = {
            "ba_iters_per_s": round(iters_per_s, 2),
            "efficiency": round(iters_per_s / (base_rate * n), 3),
        }
    out = {"problem": {"F": F, "L": L}, "scaling": results}
    if jax.default_backend() == "cpu":
        out["note"] = (
            "virtual CPU mesh: all devices share one physical CPU, so strong-"
            "scaling efficiency is not meaningful here — this mode validates "
            "correctness/compilation only; run on a multi-GPU host for numbers"
        )
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
