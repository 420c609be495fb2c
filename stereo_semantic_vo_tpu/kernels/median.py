"""Small median filters.

Replaces the reference's vendored Perreault constant-time median filter
(Thirdparty/MB/ctmf.c, 447 LoC of sliding histograms) — used there on color
images pre-gradient (MSA.cpp:58-59) and on raw disparity (MSA.cpp:1006).
On an accelerator a 3x3 median is just a 9-element sort across stacked
shifts: one fused sort, no histograms.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def median3x3(img: jax.Array) -> jax.Array:
    """(H, W) -> (H, W) 3x3 median (edge-replicated borders)."""
    padded = jnp.pad(img, 1, mode="edge")
    H, W = img.shape
    shifts = [padded[dy : dy + H, dx : dx + W] for dy in range(3) for dx in range(3)]
    stack = jnp.stack(shifts)           # (9, H, W)
    return jnp.sort(stack, axis=0)[4]


def median5x5(img: jax.Array) -> jax.Array:
    """(H, W) -> (H, W) 5x5 median."""
    padded = jnp.pad(img, 2, mode="edge")
    H, W = img.shape
    shifts = [padded[dy : dy + H, dx : dx + W] for dy in range(5) for dx in range(5)]
    stack = jnp.stack(shifts)           # (25, H, W)
    return jnp.sort(stack, axis=0)[12]
