"""Composite decode paths == the scan composite decode path: the banded fast
scan, and the GPU trellis kernel (in the Pallas interpreter)."""
import jax.numpy as jnp
import numpy as np

from cs304_tpu.models.hmm import uniform_forward_log_a
from cs304_tpu.ops.pallas.trellis_scanfree import (
    viterbi_composite_batch_scanfree,
)
from cs304_tpu.ops.viterbi import (
    viterbi_composite_batch,
    viterbi_composite_batch_fast,
)


def _setup(rng):
    s_total, b, t = 8, 6, 25
    log_a = np.full((s_total, s_total), -np.inf, np.float32)
    log_a[:5, :5] = uniform_forward_log_a(5)
    log_a[5:, 5:] = uniform_forward_log_a(3)
    lower = np.array([0] * 5 + [5] * 3, np.int32)
    entry = np.zeros(s_total, bool)
    entry[[0, 5]] = True
    exit_ = np.zeros(s_total, bool)
    exit_[[4, 7]] = True
    log_b = (rng.normal(size=(b, t, s_total)) * 2).astype(np.float32)
    lengths = rng.integers(t // 2, t + 1, size=b).astype(np.int32)
    return s_total, b, t, log_a, lower, entry, exit_, log_b, lengths


def test_fast_composite_matches_scan(rng):
    s_total, b, t, log_a, lower, entry, exit_, log_b, lengths = _setup(rng)
    want_scores, want_paths = viterbi_composite_batch(
        jnp.asarray(log_b), jnp.asarray(log_a), jnp.asarray(lower),
        jnp.asarray(entry), jnp.asarray(exit_), -5.0, jnp.asarray(lengths),
    )
    got_scores, got_paths = viterbi_composite_batch_fast(
        jnp.asarray(log_b), jnp.asarray(log_a), jnp.asarray(lower),
        jnp.asarray(entry), jnp.asarray(exit_), -5.0, jnp.asarray(lengths),
    )
    np.testing.assert_allclose(
        np.asarray(got_scores), np.asarray(want_scores), rtol=1e-6
    )
    for i in range(b):
        live = np.arange(t) < lengths[i]
        np.testing.assert_array_equal(
            np.asarray(got_paths[i])[live], np.asarray(want_paths[i])[live]
        )


def test_pallas_composite_matches_scan(rng):
    s_total, b, t, log_a, lower, entry, exit_, log_b, lengths = _setup(rng)
    want_scores, want_paths = viterbi_composite_batch(
        jnp.asarray(log_b), jnp.asarray(log_a), jnp.asarray(lower),
        jnp.asarray(entry), jnp.asarray(exit_), -5.0, jnp.asarray(lengths),
    )
    got_scores, got_paths = viterbi_composite_batch_scanfree(
        jnp.asarray(log_b), jnp.asarray(log_a), jnp.asarray(lower),
        jnp.asarray(entry), jnp.asarray(exit_), -5.0, jnp.asarray(lengths),
        interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(got_scores), np.asarray(want_scores), rtol=1e-6
    )
    for i in range(b):
        live = np.arange(t) < lengths[i]
        np.testing.assert_array_equal(
            np.asarray(got_paths[i])[live], np.asarray(want_paths[i])[live]
        )
