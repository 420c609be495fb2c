#!/usr/bin/env python3
"""Smoke test of the stereo VO system on NVIDIA GPUs.

Run from the repository root on a machine with a CUDA GPU:

    python chip_smoke.py            # phases (a)-(f) on one GPU
    python chip_smoke.py --multi    # phase (g) only, on four GPUs

Phases, each at the full width of ``VOConfig.kitti("00")`` (1241x376, K=512,
8 ORB levels, W=4, 256 RANSAC hypotheses, D=48) on stereo frames rendered
from the in-repo textured world (tests/synthetic_world.py) at KITTI 00
intrinsics along a turning trajectory with exact ground truth:

  (a) device check: JAX must report a GPU; prints the card's name and power
      limit and the compile-cache directory;
  (b) main path: ~30 frames through ``engine.pipeline.VOPipeline``; every
      frame tracked, poses finite, ATE <= 2 % of the path length;
  (c) online detector: a seeded tiny-YOLOv2 with asynchronous detection,
      and its raw head outputs against the same call on the host CPU;
  (d) dense disparity: the Triton SGM kernel against the lax.scan reference
      on a full volume, ``dense_disparity`` timed with each backend, then
      the pipeline in dense mode with each backend;
  (e) one device-resident window-BA refine (``engine.window_ba``);
  (f) timings of the XLA forms that stand in for retired hand-written kernels:
      sparse stereo strips vs volume, matcher popcount vs int8 matmul, and
      patch extraction;
  (g) ``--multi``: data-parallel tracking over a 4-GPU mesh against the same
      streams one after another on GPU 0, and landmark-sharded Schur BA
      against the single-device solver.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
The script exits non-zero, without that line, when JAX finds no GPU or when
any check fails.  It is one process; its only child is ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# the frame renderer lives with the tests; import it from that directory,
# since an installed distribution may also ship a package named ``tests``
sys.path.insert(1, os.path.join(REPO, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from stereo_semantic_vo_tpu.core.camera import Camera  # noqa: E402
from stereo_semantic_vo_tpu.core.config import BAConfig, VOConfig  # noqa: E402
from stereo_semantic_vo_tpu.engine.pipeline import VOPipeline  # noqa: E402
from stereo_semantic_vo_tpu.engine.tracker import FrameInput  # noqa: E402
from stereo_semantic_vo_tpu.engine.window_ba import refine_state  # noqa: E402
from stereo_semantic_vo_tpu.eval.ate import ate_rmse  # noqa: E402
from stereo_semantic_vo_tpu.kernels import hamming  # noqa: E402
from stereo_semantic_vo_tpu.models.yolo import YoloDetector, forward, letterbox  # noqa: E402
from stereo_semantic_vo_tpu.models.zoo import KITTI_TINY_V2_CFG  # noqa: E402
from stereo_semantic_vo_tpu.ops import dense_stereo, local_ba, orb, stereo  # noqa: E402
from stereo_semantic_vo_tpu.parallel.dp_tracker import (  # noqa: E402
    batched_init_state,
    make_dp_tracker,
)
from stereo_semantic_vo_tpu.parallel.mesh import DATA_AXIS, LANDMARK_AXIS  # noqa: E402
from stereo_semantic_vo_tpu.parallel.sharded_ba import make_sharded_local_ba  # noqa: E402
from stereo_semantic_vo_tpu.utils.cache import enable_persistent_cache  # noqa: E402
from synthetic_world import PlanarWorld, turning_trajectory  # noqa: E402

ATE_BOUND = 0.02          # of path length (tests/test_full_sequence.py)
# the detector's convolutions run at default precision, which is TF32 on the
# card (10-bit mantissa, ~5e-4 relative per operand) and exact float32 on the
# host; nine stacked conv layers compound that to ~1e-2 of the output range
HEAD_RTOL = 5e-2
# multi-GPU comparisons, at the bounds of tests/test_dp_tracker.py and
# tests/test_sharded_ba.py: data-parallel streams run the same per-device
# program on the same inputs; the sharded BA sums its reduced camera system
# over cards in another order, and that 24x24 float32 solve (fx^2-scale
# entries beside a 1e8 gauge prior) moves poses by about a millimetre while
# the cost it minimises agrees far closer
DP_POSE_ATOL = 1e-5
BA_POSE_ATOL = 5e-3
BA_COST_RTOL = 1e-3


def card_info() -> str:
    """``nvidia-smi``'s name and power limit for every card (one per line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip())


def p50_ms(fn, *args, n: int = 10) -> float:
    """Median wall time of ``fn(*args)`` ending in ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3)


def render_frames(cfg: VOConfig, n: int, seed: int):
    """(n stereo pairs as float32 (H, W) arrays, (n, 4, 4) T_wc ground truth)
    from the textured planar world at the config's intrinsics."""
    cam = cfg.camera
    world = PlanarWorld(seed=seed, wall_z=35.0)
    gt = turning_trajectory(n, speed=0.2, yaw_rate=0.008)
    frames = [
        world.render_stereo(T, cam.fx, cam.fy, cam.cx, cam.cy,
                            cam.height, cam.width, cam.baseline)
        for T in gt
    ]
    return frames, gt


def run_pipeline(cfg: VOConfig, frames, detector=None) -> tuple[dict, VOPipeline]:
    """Drive ``VOPipeline`` frame by frame, timing each frame to
    ``block_until_ready`` of the tracker state."""
    pipe = VOPipeline(cfg, detector=detector, write_trajectory=False)
    times = []
    for t, (left, right) in enumerate(frames):
        t0 = time.perf_counter()
        pipe.process_frame(left, right, None, None, 0.1 * t)
        jax.block_until_ready(pipe.state)
        times.append(time.perf_counter() - t0)
    pipe.flush()
    p50 = float(np.median(times[2:]))
    est = np.stack([np.asarray(o.T_wc, np.float64) for o in pipe.outputs])
    ok = [bool(o.pnp_ok) for o in pipe.outputs]
    stats = {
        "frames": len(frames),
        "tracked": int(sum(ok)),
        "lost": [i for i, o in enumerate(ok) if not o],
        "reinits": pipe.n_reinits,
        "finite": bool(np.isfinite(est).all()),
        "p50_ms": p50 * 1e3,
        # first init_step + first track_step call, compile included
        "compile_s": times[0] + times[1] - 2 * p50,
        "est": est,
    }
    return stats, pipe


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def phase_main(cfg, frames, gt, card):
    stats, pipe = run_pipeline(cfg, frames)
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)))
    ate = ate_rmse(stats["est"], gt, align=False)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", -1)
    print(f"[b] main path: {stats['tracked']}/{stats['frames']} frames tracked, "
          f"ATE {ate:.4f} m over {path:.2f} m ({100 * ate / path:.2f} %), "
          f"p50 frame {stats['p50_ms']:.3f} ms, compile {stats['compile_s']:.1f} s, "
          f"peak_bytes_in_use {peak} | {card}")
    check(stats["lost"] == [] and stats["reinits"] == 0,
          f"main path lost frames {stats['lost']}")
    check(stats["finite"], "main path poses not finite")
    check(ate <= ATE_BOUND * path, f"ATE {ate:.4f} m > {ATE_BOUND} x {path:.2f} m")
    return pipe


def phase_detector(cfg, frames, card, seed):
    det = YoloDetector(
        KITTI_TINY_V2_CFG, conf_threshold=cfg.semantic.online_conf_threshold,
        max_boxes=cfg.semantic.max_boxes, seed=seed,
    )
    stats, _ = run_pipeline(cfg, frames, detector=det)
    print(f"[c] online detector: {stats['tracked']}/{stats['frames']} frames "
          f"tracked, p50 frame with async detection {stats['p50_ms']:.3f} ms | {card}")
    check(stats["lost"] == [] and stats["finite"], "detector path lost tracking")

    left = frames[0][0]
    H, W = left.shape
    img = np.repeat(left[..., None] / 255.0, 3, axis=-1).astype(np.float32)
    x = np.asarray(letterbox(jnp.asarray(img), det.net_w, det.net_h, W, H))[None]
    heads = jax.jit(lambda a: [f for _, f in forward(det.params, det.sections, a)])
    gpu = [np.asarray(h) for h in heads(jax.device_put(x, jax.devices()[0]))]
    cpu = [np.asarray(h) for h in heads(jax.device_put(x, jax.devices("cpu")[0]))]
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        err = float(np.abs(g - c).max())
        scale = float(np.abs(c).max())
        print(f"[c] head {i} {g.shape}: max |gpu - cpu| {err:.3e}, "
              f"max |cpu| {scale:.3e}, bound {HEAD_RTOL} x max |cpu|")
        check(g.shape == c.shape and err <= HEAD_RTOL * scale,
              f"detector head {i} differs from the host by {err}")


def phase_dense(cfg, frames, card):
    scfg = cfg.stereo
    left, right = (jnp.asarray(a) for a in frames[len(frames) // 2])
    vol = dense_stereo.cost_volume(left, right, scfg)
    p2h, p2v = dense_stereo.edge_p2_planes(left, scfg)
    backends = ("pallas", "xla")
    agg = {}
    for be in backends:
        c = dataclasses.replace(scfg, dense_backend=be)
        agg[be] = np.asarray(jax.jit(
            lambda v, a, b, c=c: dense_stereo.sgm_aggregate(v, c, a, b))(vol, p2h, p2v))
    d_agg = float(np.abs(agg["pallas"] - agg["xla"]).max())
    disp, ms = {}, {}
    for be in backends + backends:
        c = dataclasses.replace(scfg, dense_backend=be)
        disp[be] = dense_stereo.dense_disparity(left, right, c)
        ms.setdefault(be, []).append(p50_ms(dense_stereo.dense_disparity, left, right, c))
    d_disp = float(jnp.abs(disp["pallas"].disparity - disp["xla"].disparity).max())
    same_valid = bool(jnp.all(disp["pallas"].valid == disp["xla"].valid))
    print(f"[d] SGM aggregate {tuple(vol.shape)}: max |triton - lax.scan| {d_agg}; "
          f"dense_disparity max |diff| {d_disp} px, valid masks equal {same_valid}")
    print(f"[d] dense_disparity p50: triton kernel {min(ms['pallas']):.3f} ms, "
          f"lax.scan {min(ms['xla']):.3f} ms | {card}")
    check(d_agg == 0.0 and d_disp == 0.0 and same_valid,
          "SGM kernel not bit-equal to the lax.scan reference")
    for be in backends:
        c = dataclasses.replace(
            cfg, stereo=dataclasses.replace(scfg, sparse_mode="dense", dense_backend=be))
        stats, _ = run_pipeline(c, frames[:8])
        print(f"[d] dense-mode pipeline ({be}): {stats['tracked']}/{stats['frames']} "
              f"tracked, p50 frame {stats['p50_ms']:.3f} ms, compile "
              f"{stats['compile_s']:.1f} s | {card}")
        check(stats["lost"] == [] and stats["finite"], f"dense mode ({be}) lost tracking")


def phase_window_ba(cfg, pipe, card):
    state = pipe.state
    t0 = time.perf_counter()
    new = jax.block_until_ready(refine_state(state, cfg))
    first = time.perf_counter() - t0
    ms = p50_ms(refine_state, state, cfg, n=5)
    moved = float(jnp.abs(new.T_cw - state.T_cw).max())
    print(f"[e] window BA refine (W={cfg.window.window_frames}, M="
          f"{cfg.window.max_map_points}): first call {first:.1f} s, p50 {ms:.3f} ms, "
          f"max |pose change| {moved:.2e} | {card}")
    check(bool(jnp.all(jnp.isfinite(new.T_cw)) & jnp.all(jnp.isfinite(new.map_Xw))),
          "window BA result not finite")


def phase_xla_forms(cfg, frames, card):
    left, right = (jnp.asarray(a) for a in frames[1])
    kp = jax.jit(orb.extract_orb, static_argnums=1)(left, cfg.orb)
    cam = Camera.from_config(cfg.camera)
    for mode in ("strips", "volume", "strips", "volume"):
        c = dataclasses.replace(cfg.stereo, sparse_mode=mode)
        f = jax.jit(lambda l, r, uv, v, c=c: stereo.sparse_disparity(l, r, uv, v, cam, c).disparity)
        print(f"[f] sparse stereo {mode} (K={kp.uv.shape[0]}, D={c.max_disparity}): "
              f"p50 {p50_ms(f, left, right, kp.uv, kp.valid):.4f} ms | {card}")

    K, M = cfg.orb.max_keypoints, cfg.window.max_map_points
    rng = np.random.RandomState(0)
    words = lambda n: jnp.asarray(rng.randint(0, 2**31, (n, 8)).astype(np.uint32))
    last, cur, mp = words(K), words(K), words(M)
    lv, cv, mv = (jnp.asarray(rng.rand(n) > 0.2) for n in (K, K, M))

    @jax.jit
    def popcount(last, cur, mp):
        a = hamming.masked_best_match(hamming.hamming_distance_matrix(last, cur), lv, cv)
        b = hamming.masked_best_match(hamming.hamming_distance_matrix(mp, cur), mv, cv)
        return a, b

    @jax.jit
    def mxu(last_pm1, cur, mp_pm1):
        cur_pm1 = hamming.unpack_descriptors_pm1(cur)
        a = hamming.masked_best_match(
            hamming.hamming_distance_matrix_mxu(last_pm1, cur_pm1), lv, cv)
        b = hamming.masked_best_match(
            hamming.hamming_distance_matrix_mxu(mp_pm1, cur_pm1), mv, cv)
        return a, b

    last_pm1 = hamming.unpack_descriptors_pm1(last)
    mp_pm1 = hamming.unpack_descriptors_pm1(mp)
    same = all(bool(jnp.all(x == y)) for x, y in zip(
        jax.tree.leaves(popcount(last, cur, mp)), jax.tree.leaves(mxu(last_pm1, cur, mp_pm1))))
    for _ in range(2):
        print(f"[f] matcher popcount ({K}x{K} + {M}x{K}): "
              f"p50 {p50_ms(popcount, last, cur, mp):.4f} ms | {card}")
        print(f"[f] matcher int8 matmul ({K}x{K} + {M}x{K}): "
              f"p50 {p50_ms(mxu, last_pm1, cur, mp_pm1):.4f} ms | {card}")
    check(same, "matcher forms disagree")

    img_s = orb._smooth(left, cfg.orb.smooth_width)
    xy = jnp.stack([rng.randint(19, left.shape[1] - 19, 2 * K),
                    rng.randint(19, left.shape[0] - 19, 2 * K)], axis=-1).astype(np.int32)
    patches = jax.jit(orb._patches, static_argnums=2)
    print(f"[f] patch extraction ({2 * K} x 31x31): "
          f"p50 {p50_ms(patches, img_s, jnp.asarray(xy), 15):.4f} ms | {card}")
    print(f"[f] extract_orb (full pyramid): "
          f"p50 {p50_ms(jax.jit(orb.extract_orb, static_argnums=1), left, cfg.orb):.4f} ms | {card}")


def phase_multi(cfg, seed, card, n_dev=4, n_frames=6):
    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"--multi needs {n_dev} GPUs, JAX sees {len(jax.devices())}")

    # data-parallel tracking: one full-width stream per card
    streams = [render_frames(cfg, n_frames, seed + b)[0] for b in range(n_dev)]
    nb = cfg.semantic.max_boxes

    def batch(t, members):
        return FrameInput(
            left=jnp.stack([jnp.asarray(streams[b][t][0]) for b in members]),
            right=jnp.stack([jnp.asarray(streams[b][t][1]) for b in members]),
            boxes=jnp.zeros((len(members), nb, 4), jnp.float32),
            boxes_valid=jnp.zeros((len(members), nb), bool),
        )

    def run(mesh, members):
        step = make_dp_tracker(mesh, cfg)
        states = batched_init_state(cfg, len(members))
        poses, oks, times = [], [], []
        for t in range(n_frames):
            t0 = time.perf_counter()
            states, out = step(states, batch(t, members))
            jax.block_until_ready(states)
            times.append(time.perf_counter() - t0)
            poses.append(np.asarray(out.T_cw))
            oks.append(np.asarray(out.pnp_ok))
        return np.stack(poses, 1), np.stack(oks, 1), float(np.median(times[2:])) * 1e3

    p_mesh, ok_mesh, ms_mesh = run(Mesh(np.array(devs), (DATA_AXIS,)), list(range(n_dev)))
    one = Mesh(np.array(devs[:1]), (DATA_AXIS,))
    seq = [run(one, [b]) for b in range(n_dev)]
    p_seq = np.concatenate([s[0] for s in seq])
    ok_seq = np.concatenate([s[1] for s in seq])
    d_pose = float(np.abs(p_mesh - p_seq).max())
    print(f"[g] dp tracking, {n_dev} streams on {n_dev} cards: p50 step {ms_mesh:.3f} ms; "
          f"one after another on card 0: p50 step {np.median([s[2] for s in seq]):.3f} ms; "
          f"max |pose diff| {d_pose:.2e} (bound {DP_POSE_ATOL}); tracked "
          f"{int(ok_mesh.sum())}/{ok_mesh.size} | {card}")
    check(bool(ok_mesh.all()) and bool((ok_mesh == ok_seq).all()), "dp tracking lost frames")
    check(d_pose <= DP_POSE_ATOL, f"dp poses differ by {d_pose}")

    # landmark-sharded Schur BA at F=4, L=2048 per card, with the stereo
    # edges the production window BA (engine/window_ba.WindowBA) uses
    F, L = 4, 2048 * n_dev
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-15, 15, L), rng.uniform(-4, 4, L), rng.uniform(8, 50, L)],
                 axis=-1).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * F)
    for f in range(F):
        poses[f][0, 3] = -0.8 * f
        poses[f][2, 3] = -0.5 * f
    c = cfg.camera
    pc = np.einsum("fij,lj->fli", poses[:, :3, :3], X) + poses[:, None, :3, 3]
    u = c.fx * pc[..., 0] / pc[..., 2] + c.cx
    obs = np.stack([u, c.fy * pc[..., 1] / pc[..., 2] + c.cy], -1).astype(np.float32)
    obs += rng.normal(0, 0.5, obs.shape).astype(np.float32)
    mask = (pc[..., 2] > 0.5) & (rng.rand(F, L) > 0.2)
    ur = (u - c.bf / pc[..., 2] + rng.normal(0, 0.5, u.shape)).astype(np.float32)
    poses0 = poses.copy()
    poses0[1:, :3, 3] += rng.normal(0, 0.05, (F - 1, 3)).astype(np.float32)
    X0 = (X + rng.normal(0, 0.1, X.shape)).astype(np.float32)
    cam = Camera.from_config(c)
    bcfg = BAConfig()
    args = (jnp.asarray(poses0), jnp.asarray(X0), jnp.asarray(obs), jnp.asarray(mask),
            jnp.ones(L, bool), jnp.asarray(ur), jnp.asarray(mask))
    sharded = make_sharded_local_ba(
        Mesh(np.array(devs), (LANDMARK_AXIS,)), cam, bcfg, stereo_edges=True)
    single = jax.jit(lambda p, x, o, m, v, r, rm: local_ba.local_ba(
        p, x, o, m, v, cam, bcfg, obs_ur=r, obs_r_mask=rm))
    rs, r1 = sharded(*args), single(*args)
    d_pose = float(jnp.abs(rs.poses - r1.poses).max())
    err = [float(np.abs(np.asarray(r.poses) - poses).max()) for r in (rs, r1)]
    d_cost = abs(float(rs.cost) - float(r1.cost)) / max(abs(float(r1.cost)), 1e-9)
    print(f"[g] sharded Schur BA F={F} L={L} ({L // n_dev} per card): p50 "
          f"{p50_ms(sharded, *args, n=5):.3f} ms on {n_dev} cards vs "
          f"{p50_ms(single, *args, n=5):.3f} ms on one; max |pose diff| {d_pose:.2e} "
          f"(bound {BA_POSE_ATOL}), relative cost diff {d_cost:.2e} (bound {BA_COST_RTOL}); "
          f"max |pose - truth| {err[0]:.2e} sharded, {err[1]:.2e} single | {card}")
    check(d_pose <= BA_POSE_ATOL and d_cost <= BA_COST_RTOL,
          "sharded BA disagrees with the single-device solver")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only phase (g), on four GPUs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args()

    # (a) device check
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX reports platform {dev.platform!r}")
    card = card_info()
    print(f"[a] {len(jax.devices())} x {dev.device_kind} ({dev.platform}); "
          f"compile cache {enable_persistent_cache()}")
    print(card)

    cfg = VOConfig.kitti("00")
    if args.multi:
        phase_multi(cfg, args.seed, card)
    else:
        frames, gt = render_frames(cfg, args.frames, args.seed)
        pipe = phase_main(cfg, frames, gt, card)
        phase_detector(cfg, frames[:6], card, args.seed)
        phase_dense(cfg, frames, card)
        phase_window_ba(cfg, pipe, card)
        phase_xla_forms(cfg, frames, card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
