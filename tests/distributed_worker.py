"""Worker for the 2-process jax.distributed BA test (test_multiprocess_ba.py).

Each process owns 2 virtual CPU devices; the global mesh spans 4 devices
across both processes.  The landmark-sharded Schur BA
(parallel/sharded_ba.make_sharded_local_ba) runs over the *global* mesh —
its psum collectives cross the process boundary through the coordination
service, exercising the real multi-host code path
(parallel/mesh.init_distributed) that single-process virtual meshes cannot.

Each process independently builds the same BA problem (fixed seed), runs the
distributed solve, and checks its *addressable shards* of the result against
a process-local single-device reference solve.  Prints PARITY_OK on success.

Usage: python distributed_worker.py <coordinator_addr> <num_procs> <proc_id>
"""

import os
import sys

# two virtual CPU devices per process, as in tests/conftest.py
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    coord, n_proc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import jax

    jax.config.update("jax_platforms", "cpu")

    from stereo_semantic_vo_tpu.parallel.mesh import LANDMARK_AXIS, init_distributed

    init_distributed(
        coordinator_address=coord, num_processes=n_proc, process_id=pid
    )

    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    assert jax.process_count() == n_proc, jax.process_count()
    devs = jax.devices()
    assert len(devs) == 2 * n_proc, devs
    mesh = Mesh(np.array(devs), (LANDMARK_AXIS,))

    from stereo_semantic_vo_tpu.core.camera import Camera
    from stereo_semantic_vo_tpu.core.config import BAConfig, CameraConfig
    from stereo_semantic_vo_tpu.ops.local_ba import local_ba
    from stereo_semantic_vo_tpu.parallel.sharded_ba import make_sharded_local_ba

    cam = Camera.from_config(CameraConfig())
    cfg = BAConfig(local_iterations=4)
    F, L = 4, 64
    rng = np.random.RandomState(0)
    X = np.stack(
        [rng.uniform(-8, 8, L), rng.uniform(-3, 3, L), rng.uniform(5, 30, L)],
        axis=-1,
    ).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * F)
    for f in range(F):
        poses[f, 0, 3] = 0.1 * f
    uv = np.zeros((F, L, 2), np.float32)
    for f in range(F):
        pc = X @ poses[f, :3, :3].T + poses[f, :3, 3]
        uv[f, :, 0] = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
        uv[f, :, 1] = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
    uv += rng.randn(F, L, 2).astype(np.float32) * 0.5
    X_noisy = X + rng.randn(L, 3).astype(np.float32) * 0.05
    mask = np.ones((F, L), bool)
    pv = np.ones((L,), bool)
    ur = uv[..., 0] - cam.bf / np.maximum(X[None, :, 2], 1e-3)
    urm = np.ones((F, L), bool)

    def gput(arr, spec):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: jnp.asarray(arr[idx])
        )

    lm = P(LANDMARK_AXIS)
    rep = P()
    run = make_sharded_local_ba(mesh, cam, cfg, stereo_edges=True)
    res = run(
        gput(poses, rep),
        gput(X_noisy, lm),
        gput(uv, P(None, LANDMARK_AXIS)),
        gput(mask, P(None, LANDMARK_AXIS)),
        gput(pv, lm),
        gput(ur, P(None, LANDMARK_AXIS)),
        gput(urm, P(None, LANDMARK_AXIS)),
    )

    # process-local single-device reference
    ref = local_ba(
        jnp.asarray(poses), jnp.asarray(X_noisy), jnp.asarray(uv),
        jnp.asarray(mask), jnp.asarray(pv), cam, cfg,
        obs_ur=jnp.asarray(ur), obs_r_mask=jnp.asarray(urm),
    )

    np.testing.assert_allclose(
        np.asarray(res.poses.addressable_shards[0].data),
        np.asarray(ref.poses), atol=1e-4,
    )
    ref_pts = np.asarray(ref.points)
    for shard in res.points.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(shard.data), ref_pts[shard.index], atol=1e-3,
        )
    print(f"PARITY_OK pid={pid} procs={jax.process_count()} "
          f"devices={len(devs)} cost={float(res.cost):.4f}", flush=True)


if __name__ == "__main__":
    main()
