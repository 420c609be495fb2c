"""Bulk 256-bit Hamming distance — the matching hot loop.

The reference computes Hamming distances one pair at a time with a SWAR
popcount inside doubly-nested scans over keypoints (pnpmatch.cc:14-30, used
at :61-95 and :160-199).  Here the whole N_query x N_train distance matrix
is computed at once, two ways:

* ``hamming_distance_matrix`` — exact XOR + population count on uint32
  words; XLA fuses XOR, popcount and the word sum into one pass.
* ``hamming_distance_matrix_mxu`` — descriptors are unpacked once per frame
  to +-1 int8 vectors, and ``hamming = (bits - dot(q, t)) / 2`` turns the
  distance matrix into a single int8 matmul with int32 accumulation.

Both agree bit-exactly; tests assert it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DESC_WORDS = 8  # 256 bits as 8 x uint32
DESC_BITS = 256


def hamming_distance_matrix(query: jax.Array, train: jax.Array) -> jax.Array:
    """(Q, 8) uint32 x (T, 8) uint32 -> (Q, T) int32 Hamming distances."""
    x = jnp.bitwise_xor(query[:, None, :], train[None, :, :])
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)


def unpack_descriptors_pm1(desc: jax.Array) -> jax.Array:
    """(N, 8) uint32 -> (N, 256) int8 in {-1, +1} (bit b set -> +1).

    Done once per frame; afterwards every matching step is an int8 matmul.
    """
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(desc.shape[0], DESC_BITS)
    return (bits.astype(jnp.int8) * 2 - 1).astype(jnp.int8)


def hamming_distance_matrix_mxu(query_pm1: jax.Array, train_pm1: jax.Array) -> jax.Array:
    """(Q, 256) int8 +-1 x (T, 256) int8 +-1 -> (Q, T) int32 Hamming.

    dot(q, t) = (#agree - #disagree) = 256 - 2*hamming, so
    hamming = (256 - dot) / 2.  The matmul is int8 with int32 accumulation,
    exact at any precision setting.
    """
    dot = jax.lax.dot_general(
        query_pm1,
        train_pm1,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (DESC_BITS - dot) >> 1


def masked_best_match(
    dist: jax.Array,
    query_valid: jax.Array,
    train_valid: jax.Array,
    big: int = DESC_BITS + 1,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Row-wise best + second-best over a masked distance matrix.

    Returns (best_idx (Q,), best_dist (Q,), second_dist (Q,)) with invalid
    entries pushed to ``big``.  This is the primitive under both matching
    stages' gates (best<15 vs last frame, best<30 & second/best>2 vs local
    map — pnpmatch.cc:101,192).
    """
    valid = query_valid[:, None] & train_valid[None, :]
    d = jnp.where(valid, dist, big)
    best_idx = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, best_idx[:, None], axis=1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(big)
    second = jnp.min(d2, axis=1)
    return best_idx, best, second
