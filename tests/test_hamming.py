import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_semantic_vo_tpu.kernels import hamming


def random_desc(key, n):
    return jax.random.randint(key, (n, hamming.DESC_WORDS), 0, 2**31 - 1, dtype=jnp.int32).astype(jnp.uint32)


def numpy_hamming(q, t):
    q = np.asarray(q)
    t = np.asarray(t)
    out = np.zeros((q.shape[0], t.shape[0]), dtype=np.int32)
    for i in range(q.shape[0]):
        x = np.bitwise_xor(q[i][None, :], t)
        out[i] = np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)
    return out


class TestHammingDistance:
    def test_xla_matches_numpy(self):
        q = random_desc(jax.random.PRNGKey(0), 64)
        t = random_desc(jax.random.PRNGKey(1), 96)
        np.testing.assert_array_equal(hamming.hamming_distance_matrix(q, t), numpy_hamming(q, t))

    def test_mxu_path_exact(self):
        q = random_desc(jax.random.PRNGKey(2), 128)
        t = random_desc(jax.random.PRNGKey(3), 128)
        ref = hamming.hamming_distance_matrix(q, t)
        qpm = hamming.unpack_descriptors_pm1(q)
        tpm = hamming.unpack_descriptors_pm1(t)
        got = hamming.hamming_distance_matrix_mxu(qpm, tpm)
        np.testing.assert_array_equal(got, ref)

    def test_identical_descriptors_zero(self):
        q = random_desc(jax.random.PRNGKey(6), 16)
        d = hamming.hamming_distance_matrix(q, q)
        np.testing.assert_array_equal(np.diag(d), np.zeros(16, dtype=np.int32))

    def test_complement_is_256(self):
        q = random_desc(jax.random.PRNGKey(7), 8)
        t = jnp.bitwise_xor(q, jnp.uint32(0xFFFFFFFF))
        d = hamming.hamming_distance_matrix(q, t)
        np.testing.assert_array_equal(np.diag(d), np.full(8, 256, dtype=np.int32))


class TestMaskedBestMatch:
    def test_best_and_second(self):
        dist = jnp.array([[5, 1, 9], [3, 3, 0]], dtype=jnp.int32)
        qv = jnp.array([True, True])
        tv = jnp.array([True, True, True])
        idx, best, second = hamming.masked_best_match(dist, qv, tv)
        np.testing.assert_array_equal(idx, [1, 2])
        np.testing.assert_array_equal(best, [1, 0])
        np.testing.assert_array_equal(second, [5, 3])

    def test_invalid_train_excluded(self):
        dist = jnp.array([[1, 2]], dtype=jnp.int32)
        idx, best, _ = hamming.masked_best_match(
            dist, jnp.array([True]), jnp.array([False, True])
        )
        assert int(idx[0]) == 1 and int(best[0]) == 2

    def test_invalid_query_big(self):
        dist = jnp.array([[1, 2]], dtype=jnp.int32)
        _, best, _ = hamming.masked_best_match(
            dist, jnp.array([False]), jnp.array([True, True])
        )
        assert int(best[0]) == hamming.DESC_BITS + 1


def numpy_best_two(dist, qv, tv, big=hamming.DESC_BITS + 1):
    """Brute-force row-wise best and second-best over valid pairs."""
    dist = np.asarray(dist)
    best = np.full(dist.shape[0], big)
    second = np.full(dist.shape[0], big)
    for i in range(dist.shape[0]):
        if not qv[i]:
            continue
        row = np.sort(dist[i][np.asarray(tv)])
        if len(row) > 0:
            best[i] = row[0]
        if len(row) > 1:
            second[i] = row[1]
    return best, second


class TestMatcherForms:
    """Both matcher forms (MatcherConfig.backend) through masked_best_match
    against a numpy brute force: the XOR+popcount distance on packed words
    and the +-1 int8 matmul on unpacked descriptors."""

    @pytest.mark.parametrize("form", ["popcount", "mxu"])
    @pytest.mark.parametrize("nq,nt,seed", [(256, 512, 0), (512, 2048, 1), (37, 129, 2)])
    def test_best_two_match_brute_force(self, form, nq, nt, seed):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        q = random_desc(k1, nq)
        t = random_desc(k2, nt)
        # plant exact and near duplicates so the gates' range is exercised
        t = t.at[: min(8, nq)].set(q[: min(8, nq)])
        t = t.at[8:16].set(jnp.bitwise_xor(q[:8], jnp.uint32(0x3)))
        qv = np.arange(nq) % 5 != 0
        tv = np.arange(nt) % 7 != 0
        if form == "popcount":
            dist = hamming.hamming_distance_matrix(q, t)
        else:
            dist = hamming.hamming_distance_matrix_mxu(
                hamming.unpack_descriptors_pm1(q), hamming.unpack_descriptors_pm1(t)
            )
        ref = numpy_hamming(q, t)
        np.testing.assert_array_equal(np.asarray(dist), ref)
        idx, best, second = hamming.masked_best_match(
            dist, jnp.asarray(qv), jnp.asarray(tv)
        )
        ref_best, ref_second = numpy_best_two(ref, qv, tv)
        np.testing.assert_array_equal(np.asarray(best), ref_best)
        np.testing.assert_array_equal(np.asarray(second), ref_second)
        # argmin ties may resolve to any equal index: the chosen one must be
        # a valid train slot at the best distance
        rows = np.nonzero(qv)[0]
        chosen = np.asarray(idx)[rows]
        assert tv[chosen].all()
        np.testing.assert_array_equal(ref[rows, chosen], ref_best[rows])
