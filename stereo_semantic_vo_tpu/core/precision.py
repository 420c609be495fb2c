"""Float32 matmul precision for geometry code.

On an NVIDIA GPU from Ampere on (the H100 included), a float32 matmul or
einsum at JAX's default precision runs on the tensor cores in TF32, which
keeps 10 mantissa bits: a projected pixel coordinate (~600 px) computed
through such an einsum carries ~0.3 px of rounding error, and normal
equations built from fx^2-scale Jacobian products lose far more.  CPU tests
never see this (CPU dots are float32), so the trap only fires on the card.

The fix is structural, not per-call: every jitted *geometry* entry point
(tracking step, PnP, BA builds/solves, triangulation, F-fit) is traced under
``jax.default_matmul_precision("highest")``, pinning each dot inside to full
float32 and keeping it out of TF32.  Cost is negligible — geometry matrices
are 3x3..6x6, the descriptor matmuls are int8 (integer dots are exact at any
precision setting), and the one-hot BRIEF and intensity-centroid dots
request HIGHEST explicitly.  The YOLO CNN stays at default precision by
design: its convolutions run in TF32 on the card, so a comparison of its
outputs with a float32 host run needs a tolerance (chip_smoke.py phase (c)).
"""

from __future__ import annotations

import functools

import jax


def f32_geometry(fn):
    """Decorator: trace ``fn`` under float32 matmul precision.

    Stack UNDER the jit decorator (``jit(f32_geometry(fn))``) so the context
    is active while the body traces."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
