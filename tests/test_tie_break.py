"""Exact-float tie-breaking in the composite decoder (VERDICT item #10).

The reference's entry-state update evaluates ALL word-exit candidates before
the self-loop and takes np.argmax's first max (hidden_markov_model.py:533-547),
so on an exact tie an exit wins over the self-loop, and the lowest-indexed
word's exit wins among exits. These tests construct exact f32 ties (integer
arithmetic, exact in both f32 and the oracle's f64) and assert the default
decode backends reproduce the reference's order.

Scope note: the dense 'scan' backend's argmax orders candidates by state
index, so a tie between an entry's self-loop and an exit at a HIGHER state
index resolves differently there (ops/viterbi.py documents this). The default
'fast' backend and the 'scanfree' GPU kernel (checked here in the Pallas
interpreter) implement the reference order exactly — that is what
ContinuousDecoder ships with.
"""
import numpy as np

import jax.numpy as jnp

from cs304_tpu.ops.pallas.trellis_scanfree import viterbi_composite_batch_scanfree
from cs304_tpu.ops.viterbi import viterbi_composite_batch_fast
from tests.oracles import ref_viterbi_composite


def _setup_exit_vs_self_tie():
    """Two 2-state words; at t=1 the entry of word B ties exactly between its
    self-loop and word B's exit (index ABOVE the entry) + penalty."""
    s = 4  # A: 0-1, B: 2-3
    lowers = [0, 2]
    uppers = [1, 3]
    penalty = -4.0
    log_a = np.full((s, s), -np.inf, np.float32)
    # A internal
    log_a[0, 0], log_a[0, 1], log_a[1, 1] = -1.0, -1.0, -1.0
    # B internal; self-loop of entry 2 is -1
    log_a[2, 2], log_a[2, 3], log_a[3, 3] = -1.0, -2.0, 0.0

    t = 3
    log_b = np.zeros((t, s), np.float32)
    # t=0 init: alpha[e] = log_b[0,e] + log_a[e,e]
    log_b[0, 0] = -10.0   # alpha0[0] = -11 (word A suppressed)
    log_b[0, 2] = 0.0     # alpha0[2] = -1
    # t=1: state 3 gets alpha[2] + a[2,3] + b = -1 - 2 + b.
    log_b[1, 3] = 0.0     # alpha1[3] = -3
    log_b[1, 2] = 0.0     # self: alpha0[2] + a[2,2] = -2
    # t=2 at entry 2: self-loop = alpha1[2] + a[2,2] = -2 + -1 = -3;
    # exit 3 candidate = alpha1[3] + penalty ... need equality:
    # set so alpha1[2] = alpha1[3] + penalty + 1 (i.e. -3 both):
    # alpha1[2] = max(alpha0[2] + a22) + b[1,2] = -2 + b[1,2].
    # choose b[1,2] = penalty + alpha1[3] + 1 + 2 = exact tie at t=2:
    # tie condition: alpha1[3] + penalty == alpha1[2] + a22
    #   (-3) + (-4) == alpha1[2] + (-1)  => alpha1[2] = -6 => b[1,2] = -4.
    log_b[1, 2] = -4.0
    return log_b, log_a, lowers, uppers, penalty


def _run_backends(log_b, log_a, lowers, uppers, penalty):
    s = log_a.shape[0]
    lower_of = np.zeros(s, np.int32)
    for lo in lowers:
        lower_of[lo:] = lo
    is_entry = np.zeros(s, bool)
    is_exit = np.zeros(s, bool)
    is_entry[list(lowers)] = True
    is_exit[list(uppers)] = True
    args = (jnp.asarray(log_a), jnp.asarray(lower_of),
            jnp.asarray(is_entry), jnp.asarray(is_exit),
            jnp.float32(penalty),
            jnp.asarray(np.array([log_b.shape[0]], np.int32)))
    lb = jnp.asarray(log_b[None])
    f_s, f_p = viterbi_composite_batch_fast(lb, *args)
    k_s, k_p = viterbi_composite_batch_scanfree(lb, *args, interpret=True)
    return (np.asarray(f_s)[0], np.asarray(f_p)[0],
            np.asarray(k_s)[0], np.asarray(k_p)[0])


def test_exit_beats_self_loop_on_exact_tie():
    log_b, log_a, lowers, uppers, penalty = _setup_exit_vs_self_tie()
    # Confirm the tie is exact in f32: alpha1[3] + pen == alpha1[2] + a22.
    a1_3 = np.float32(-1.0) + np.float32(-2.0) + np.float32(0.0)
    a1_2 = np.float32(-2.0) + np.float32(-4.0)
    assert np.float32(a1_3 + np.float32(penalty)) == np.float32(
        a1_2 + np.float32(-1.0)
    )
    o_score, o_path = ref_viterbi_composite(
        log_b.astype(np.float64), log_a.astype(np.float64),
        lowers, uppers, penalty,
    )
    f_s, f_p, k_s, k_p = _run_backends(log_b, log_a, lowers, uppers, penalty)
    np.testing.assert_array_equal(f_p, o_path)
    np.testing.assert_array_equal(k_p, o_path)
    assert f_s == np.float32(o_score)
    assert k_s == np.float32(o_score)
    # The tie really exercised the divergent cell: the decoded predecessor of
    # entry 2 at t=2 must be exit 3 (reference order), not the self-loop.
    assert o_path[1] == 3, o_path


def test_lowest_exit_wins_among_tied_exits():
    """Two exits exactly tied: the reference's first-max argmax picks the
    lower-indexed word's exit."""
    s = 4
    lowers = [0, 2]
    uppers = [1, 3]
    penalty = -2.0
    log_a = np.full((s, s), -np.inf, np.float32)
    log_a[0, 0], log_a[0, 1], log_a[1, 1] = -1.0, -1.0, -1.0
    log_a[2, 2], log_a[2, 3], log_a[3, 3] = -1.0, -1.0, -1.0
    t = 3
    log_b = np.zeros((t, s), np.float32)
    # Symmetric words: alpha1[1] == alpha1[3] exactly; at t=2 both entries
    # see two tied exit candidates.
    o_score, o_path = ref_viterbi_composite(
        log_b.astype(np.float64), log_a.astype(np.float64),
        lowers, uppers, penalty,
    )
    f_s, f_p, k_s, k_p = _run_backends(log_b, log_a, lowers, uppers, penalty)
    np.testing.assert_array_equal(f_p, o_path)
    np.testing.assert_array_equal(k_p, o_path)
