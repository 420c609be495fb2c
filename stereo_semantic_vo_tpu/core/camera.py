"""Stereo pinhole camera model as pure JAX functions.

Covers the geometry the reference spreads across frame.cc (UnprojectStereo
:166-180, disp2Depth :140-164) and pnpmatch.cc (projection inside the matching
loops) — batched over points so the whole keypoint set projects in one fused op.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_semantic_vo_tpu.core.config import CameraConfig


class Camera(NamedTuple):
    """Device-resident camera intrinsics (a pytree; safe to close over or pass)."""

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    bf: jax.Array  # baseline * fx

    @classmethod
    def from_config(cls, cfg: CameraConfig, dtype=jnp.float32) -> "Camera":
        return cls(
            fx=jnp.asarray(cfg.fx, dtype),
            fy=jnp.asarray(cfg.fy, dtype),
            cx=jnp.asarray(cfg.cx, dtype),
            cy=jnp.asarray(cfg.cy, dtype),
            bf=jnp.asarray(cfg.bf, dtype),
        )

    @property
    def K(self) -> jax.Array:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx]),
                jnp.stack([z, self.fy, self.cy]),
                jnp.stack([z, z, o]),
            ]
        )


def project(cam: Camera, pts_cam: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Camera-frame points (..., 3) -> pixel coords (..., 2) and depth (...,).

    Depth is returned so callers can mask points behind the camera (the
    reference's scattered ``z > 0`` checks, frame.cc:171,227).
    """
    z = pts_cam[..., 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-6, z, 1e-6)
    u = cam.fx * pts_cam[..., 0] / safe_z + cam.cx
    v = cam.fy * pts_cam[..., 1] / safe_z + cam.cy
    return jnp.stack([u, v], axis=-1), z


def backproject(cam: Camera, uv: jax.Array, depth: jax.Array) -> jax.Array:
    """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3).

    Mirrors frame::UnprojectStereo's pixel->camera step (frame.cc:166-180).
    """
    x = (uv[..., 0] - cam.cx) * depth / cam.fx
    y = (uv[..., 1] - cam.cy) * depth / cam.fy
    return jnp.stack([x, y, depth], axis=-1)


def disparity_to_depth(cam: Camera, disparity: jax.Array, min_disp: float = 0.5) -> jax.Array:
    """depth = bf / disparity, invalid (<= min_disp) -> 0.

    The reference does this per pixel in disp2Depth (frame.cc:140-164); here it
    is one masked elementwise divide.  Returning 0 for invalid matches the reference's
    downstream ``z > 0`` filtering.
    """
    valid = disparity > min_disp
    return jnp.where(valid, cam.bf / jnp.where(valid, disparity, 1.0), 0.0)


def right_keypoint_x(uv: jax.Array, disparity: jax.Array) -> jax.Array:
    """x-coordinate of the right-image correspondence: x_r = x_l - d
    (frame::computekeypoint_r, frame.cc:122-138)."""
    return uv[..., 0] - disparity
