"""Sequence driver — the reference's main.cpp per-frame loop, device-shaped.

Responsibilities (cf. main.cpp:100-208): load frames, obtain detection boxes
(offline files or the online YOLO head — here a jitted call, not a thread),
run the tracking step, append both trajectory formats, report median/mean
per-frame time.  Host IO (decode, trajectory writes) stays off the device
path; frame decode is overlapped with device compute via a background
prefetch thread (the native C++ loader can replace it).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Iterable

import jax
import jax.numpy as jnp
import numpy as np

from stereo_semantic_vo_tpu.core.config import VOConfig
from stereo_semantic_vo_tpu.engine.state import init_state
from stereo_semantic_vo_tpu.engine.tracker import FrameInput, init_step, track_step
from stereo_semantic_vo_tpu.engine.trajectory import TrajectoryWriter


def _prefetch(iterator: Iterable, depth: int = 2):
    """Run an iterator in a daemon thread with a bounded queue."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item


class VOPipeline:
    def __init__(
        self,
        cfg: VOConfig,
        detector: Any | None = None,
        out_dir: str | None = None,
        write_trajectory: bool = True,
        local_ba_every: int = 0,
        ba_mesh=None,
        reinit_after_lost: int = 3,
        async_detect: bool = True,
    ):
        self.cfg = cfg
        self.detector = detector
        # asynchronous online semantics: the on-device analogue of the
        # reference's detector thread (src/semantic.cc:13-45, main.cpp:152).
        # Frame t tracks with the boxes detected on frame t-1 (the same one
        # -frame staleness the reference's thread exhibits); detection for
        # frame t is dispatched *after* the tracking step with no host sync,
        # so the CNN runs while the host prepares frame t+1 instead of
        # blocking the tracking dispatch.
        self.async_detect = async_detect
        self._det_pending: tuple[jax.Array, jax.Array] | None = None
        self.state = init_state(cfg)
        self.local_ba_every = local_ba_every
        # tracking-lost recovery: reseed the map after N consecutive PnP
        # failures (0 disables; the reference has no recovery at all)
        self.reinit_after_lost = reinit_after_lost
        self._consecutive_lost = 0
        self.n_reinits = 0
        self.window_ba = None
        if local_ba_every > 0 and ba_mesh is not None:
            # multi-device landmark-sharded refinement keeps its own pjit
            # program; single-device refinement is the pure jitted
            # window_ba.refine_state dispatched inline below
            from stereo_semantic_vo_tpu.engine.window_ba import WindowBA

            self.window_ba = WindowBA(cfg, mesh=ba_mesh)
        kitti_path = tum_path = None
        if write_trajectory and out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            kitti_path = os.path.join(out_dir, "cameratrajectory_kitti.txt")
            tum_path = os.path.join(out_dir, "cameratrajectory_tum.txt")
        self.writer = TrajectoryWriter(kitti_path, tum_path)
        self.frame_times: list[float] = []
        self.outputs: list[Any] = []
        # one-frame-deferred host readback: dispatch frame t, read frame t-1's
        # results — hides device->host sync latency behind compute.  The
        # device-resident window BA (window_ba.refine_state) dispatches
        # without host syncs, so deferral survives per-frame local BA.
        self.defer_readback = True
        self._pending: tuple[Any, float] | None = None
        self._n_processed = 0

    def _detect(self, left: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        det = self.detector.detect(jnp.asarray(left) / 255.0)
        nb = self.cfg.semantic.max_boxes
        boxes = np.zeros((nb, 4), np.float32)
        valid = np.zeros(nb, bool)
        b = np.asarray(det.boxes)[:nb]
        v = np.asarray(det.valid)[:nb]
        boxes[: len(b)] = b
        valid[: len(v)] = v
        return boxes, valid

    def _detect_async(self, left: jax.Array) -> None:
        """Dispatch detection for this frame; results consumed next frame.
        Stays on device — no host sync anywhere on this path."""
        det = self.detector.detect(left / 255.0)
        nb = self.cfg.semantic.max_boxes
        boxes, valid = det.boxes, det.valid
        n = boxes.shape[0]
        if n >= nb:
            boxes, valid = boxes[:nb], valid[:nb]
        else:
            boxes = jnp.zeros((nb, 4), jnp.float32).at[:n].set(boxes)
            valid = jnp.zeros((nb,), bool).at[:n].set(valid)
        self._det_pending = (boxes, valid)

    def _stale_boxes(self) -> tuple[jax.Array, jax.Array]:
        """Previous frame's detections (or empty on the first frame)."""
        if self._det_pending is not None:
            return self._det_pending
        nb = self.cfg.semantic.max_boxes
        return jnp.zeros((nb, 4), jnp.float32), jnp.zeros((nb,), bool)

    def process_frame(
        self,
        left: np.ndarray,
        right: np.ndarray,
        boxes: np.ndarray | None,
        boxes_valid: np.ndarray | None,
        timestamp: float,
    ):
        t0 = time.perf_counter()
        left_dev = jnp.asarray(left)
        dispatch_detect = False
        if boxes is None:
            if self.detector is not None and self.async_detect:
                boxes, boxes_valid = self._stale_boxes()
                dispatch_detect = True
            elif self.detector is not None:
                boxes, boxes_valid = self._detect(left)
            else:
                nb = self.cfg.semantic.max_boxes
                boxes = np.zeros((nb, 4), np.float32)
                boxes_valid = np.zeros(nb, bool)
        frame = FrameInput(
            left=left_dev,
            right=jnp.asarray(right),
            boxes=jnp.asarray(boxes),
            boxes_valid=jnp.asarray(boxes_valid),
        )
        reseed = (
            self.reinit_after_lost > 0
            and self._consecutive_lost >= self.reinit_after_lost
        )
        if self._n_processed == 0 or reseed:
            self.state, out = init_step(self.state, frame, self.cfg)
            if reseed:
                self.n_reinits += 1
            self._consecutive_lost = 0
        else:
            self.state, out = track_step(self.state, frame, self.cfg)
        self._n_processed += 1
        if dispatch_detect:
            # enqueue the CNN after the tracking step: same device stream, so
            # tracking never waits on it, and it completes while the host
            # stages frame t+1 (used by that frame's tracking step)
            self._detect_async(left_dev)

        fidx = self._n_processed - 1
        if (
            self.local_ba_every > 0
            and fidx % self.local_ba_every == 0
            and self._n_processed >= self.cfg.window.window_frames
        ):
            if self.window_ba is not None:
                self.state, _ = self.window_ba.refine(self.state)
            else:
                from stereo_semantic_vo_tpu.engine.window_ba import refine_state

                self.state = refine_state(self.state, self.cfg)
            out = out._replace(
                T_cw=self.state.T_cw,
                T_wc=jnp.linalg.inv(self.state.T_cw),
            )

        if self.defer_readback:
            prev = self._pending
            self._pending = (out, timestamp)
            if prev is not None:
                self._finalize(*prev)
        else:
            self._finalize(out, timestamp)
        self.frame_times.append(time.perf_counter() - t0)
        return out

    def _finalize(self, out, timestamp: float) -> None:
        """Host-side consumption of a step's outputs (sync point)."""
        if bool(out.pnp_ok):
            self._consecutive_lost = 0
        else:
            self._consecutive_lost += 1
        self.writer.append(np.asarray(out.T_wc), timestamp)
        self.outputs.append(out)

    def flush(self) -> None:
        if self._pending is not None:
            self._finalize(*self._pending)
            self._pending = None

    def run(self, frames: Iterable, prefetch: bool = True) -> dict:
        """frames yields (idx, left, right, boxes, boxes_valid, timestamp)
        (io/kitti.iter_frames format). Returns a summary dict."""
        it = _prefetch(frames) if prefetch else frames
        for _, left, right, boxes, bv, ts in it:
            if self.detector is not None:
                boxes, bv = None, None
            self.process_frame(left, right, boxes, bv, ts)
        self.flush()
        self.writer.close()
        times = np.array(self.frame_times[1:]) if len(self.frame_times) > 1 else np.array(
            self.frame_times
        )
        return {
            "n_frames": len(self.frame_times),
            "median_s": float(np.median(times)) if len(times) else 0.0,
            "mean_s": float(np.mean(times)) if len(times) else 0.0,
            "fps": float(1.0 / np.median(times)) if len(times) else 0.0,
            "positions": self.writer.positions(),
        }
