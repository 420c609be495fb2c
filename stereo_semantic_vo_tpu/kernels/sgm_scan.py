"""Pallas kernel (Triton route): directional SGM scanline aggregation.

The reference's dense engine spends its 2.41 s/frame in MSA's sequential
two-pass tree DP (Thirdparty/MB/MSA.cpp:929-990, solve :1132-1169).  The XLA
replacement (ops/dense_stereo._sgm_pass) reformulates that as four
directional scanline DPs, but a ``lax.scan`` whose step updates one (X, D)
cross-section runs W=1241 (or H=376) dependent loop iterations, and on a GPU
each iteration costs at least one kernel launch.  The recurrence is
latency-bound, and it is the one op of the dense path that XLA cannot fuse.

This kernel keeps the whole recurrence inside one program per tile of
scanlines:

* grid ``(2, X tiles)``: axis 0 picks the sweep (0 forward, 1 backward),
  axis 1 a tile of ``BLOCK_X`` independent scanlines.  Programs share
  nothing, so they may run in any order on any SM.
* the volume stays in its natural ``(H, W, D)`` layout; a horizontal sweep
  reads ``vol[rows, s, :]``, a vertical one ``vol[s, cols, :]``, so no
  transpose is materialized.  D is padded to the next power of two in
  registers and masked on every load and store.
* a ``fori_loop`` over the scan axis carries the ``(BLOCK_X, Dp)`` aggregate
  of the previous position in registers.  The d-1 / d+1 neighbours come from
  two products with 0/1 shift matrices at full float32 precision: each output
  is exactly one input times 1.0 plus zeros, so the shift is exact.  (Triton
  has no register shift along a tensor axis.)
* the update uses the same min tree and add order as ``_sgm_pass``, so the
  result is bit-identical to it (tests/test_sgm_pallas.py).
* an optional per-position penalty plane (edge-aware P2, the SGM analogue of
  MSA's color-difference tree weights, MSA.cpp:152-191) rides as a second
  input; scalar-P2 callers skip it.

The two sweeps land in one ``(2, H, W, D)`` output that the caller sums.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_X = 16    # scanlines per program: the smallest row count tl.dot takes
NUM_WARPS = 4
_BIG = 1e9      # matches ops/dense_stereo._sgm_pass's boundary sentinel


def _kernel(vol_ref, *refs, axis, D, Dp, S, X, p1, p2, with_p2x):
    if with_p2x:
        p2x_ref, out_ref = refs
    else:
        (out_ref,) = refs
    sweep = pl.program_id(0)          # 0 forward, 1 backward
    x0 = pl.program_id(1) * BLOCK_X
    rows = x0 + jnp.arange(BLOCK_X)
    d_iota = jnp.arange(Dp)
    real_d = d_iota < D
    mask = (rows < X)[:, None] & real_d[None, :]
    hp = jax.lax.Precision.HIGHEST
    e_i = jax.lax.broadcasted_iota(jnp.int32, (Dp, Dp), 0)
    d_i = jax.lax.broadcasted_iota(jnp.int32, (Dp, Dp), 1)
    shift_m_mat = (e_i == d_i - 1).astype(jnp.float32)   # [:, d] <- [:, d-1]
    shift_p_mat = (e_i == d_i + 1).astype(jnp.float32)   # [:, d] <- [:, d+1]

    def at(ref, s):
        if axis == 1:
            return ref.at[pl.ds(x0, BLOCK_X), s, pl.ds(0, Dp)]
        return ref.at[s, pl.ds(x0, BLOCK_X), pl.ds(0, Dp)]

    def out_at(s):
        if axis == 1:
            return out_ref.at[sweep, pl.ds(x0, BLOCK_X), s, pl.ds(0, Dp)]
        return out_ref.at[sweep, s, pl.ds(x0, BLOCK_X), pl.ds(0, Dp)]

    def body(i, prev):
        s = jnp.where(sweep == 0, i, S - 1 - i)
        c = plgpu.load(at(vol_ref, s), mask=mask, other=0.0)
        if with_p2x:
            if axis == 1:
                p2_ref_s = p2x_ref.at[pl.ds(x0, BLOCK_X), s]
            else:
                p2_ref_s = p2x_ref.at[s, pl.ds(x0, BLOCK_X)]
            p2v = plgpu.load(p2_ref_s, mask=rows < X, other=0.0)[:, None]
        else:
            p2v = p2
        # EXACTLY _sgm_pass's min tree + op order (bit parity)
        prev_min = jnp.min(jnp.where(real_d[None, :], prev, _BIG), axis=1,
                           keepdims=True)
        shift_m = jnp.dot(prev, shift_m_mat, precision=hp)
        shift_m = jnp.where(d_iota[None, :] == 0, _BIG, shift_m)
        shift_p = jnp.dot(prev, shift_p_mat, precision=hp)
        shift_p = jnp.where(d_iota[None, :] >= D - 1, _BIG, shift_p)
        best = jnp.minimum(
            jnp.minimum(prev, prev_min + p2v),
            jnp.minimum(shift_m + p1, shift_p + p1),
        )
        out = jnp.where(real_d[None, :], c + best - prev_min, 0.0)
        # the sweep starts from the raw cost of its first position
        out = jnp.where(i == 0, c, out)
        plgpu.store(out_at(s), out, mask=mask)
        return out

    jax.lax.fori_loop(0, S, body, jnp.zeros((BLOCK_X, Dp), jnp.float32))


@functools.partial(
    jax.jit, static_argnames=("axis", "p1", "p2", "interpret")
)
def sgm_sweeps(vol: jax.Array, p2x: jax.Array | None, *, axis: int,
               p1: float, p2: float, interpret: bool = False) -> jax.Array:
    """Forward and backward SGM sweeps of an (H, W, D) volume along ``axis``
    (1 = horizontal, 0 = vertical).  Returns (2, H, W, D): [forward,
    backward].  ``p2x`` (H, W), if given, replaces the scalar ``p2`` per
    position."""
    H, W, D = vol.shape
    S, X = (W, H) if axis == 1 else (H, W)
    with_p2x = p2x is not None
    kernel = functools.partial(
        _kernel, axis=axis, D=D, Dp=pl.next_power_of_2(D), S=S, X=X,
        p1=float(p1), p2=float(p2), with_p2x=with_p2x,
    )
    operands = (vol, p2x) if with_p2x else (vol,)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((2, H, W, D), jnp.float32),
        grid=(2, pl.cdiv(X, BLOCK_X)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=f"sgm_sweeps_axis{axis}",
    )(*operands)


def sgm_aggregate_pallas(vol: jax.Array, p1: float, p2: float,
                         p2x_h: jax.Array | None = None,
                         p2x_v: jax.Array | None = None,
                         interpret: bool = False) -> jax.Array:
    """4-path SGM on an (H, W, D) volume via the scanline kernel.

    Drop-in for the lax.scan form of ops/dense_stereo.sgm_aggregate, with
    the same summation order (horizontal forward, horizontal backward,
    vertical forward, vertical backward).  ``p2x_h`` / ``p2x_v`` (H, W) are
    the optional per-position P2 planes of the two directions."""
    h = sgm_sweeps(vol, p2x_h, axis=1, p1=p1, p2=p2, interpret=interpret)
    v = sgm_sweeps(vol, p2x_v, axis=0, p1=p1, p2=p2, interpret=interpret)
    return h[0] + h[1] + v[0] + v[1]
