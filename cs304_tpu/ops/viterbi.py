"""Viterbi trellis recursions as lax.scan over max-plus vector-matrix products.

The reference iterates `for t in 1..T: for state in S: for pred in band` in pure
Python with per-cell scipy logpdf calls (reference: hidden_markov_model.py:160-208
single-word, :481-581 composite). Here one time step is a whole-vector tropical
update new_alpha = max_{s'}(alpha[s'] + M[s', s]) + log_b[t, s], so the T-loop is
a lax.scan and everything inside it is whole-vector work. Emissions (T, S) are
precomputed in one batched matmul (ops/gaussian.py).

Topology is encoded once into a dense effective transition matrix M:

- Single word (left-to-right, max skip 2): M[s', s] = log_a[s', s] iff
  max(s-2, 0) <= s' <= s (reference: hidden_markov_model.py:181).
- Composite multi-word: word-internal states keep the band clipped at the word's
  entry state; word-entry states additionally accept every word-exit state with a
  flat inter-word log penalty (reference: hidden_markov_model.py:508-559).

The dense (S, S) form is the parity reference: the reference tops out at 58
composite states (11 digit words x 5 + silence x 3). The batched decoders use
the O(S) banded step (viterbi_composite_batch_fast) or its GPU kernel
(ops/pallas/trellis_scanfree.py).

Backtrace parity note: the reference's backtrace (hidden_markov_model.py:200-208,
:573-581) drops the true final state — its decoded path satisfies
path[T-1] == path[T-2] == standard_state[T-2]. `quirk_backtrace=True` (default)
reproduces that exactly so decoded digit strings and training alignments match;
set it False for the textbook backtrace. Backpointers are int32, fixing the
reference's int8 tracer overflow beyond 127 states (hidden_markov_model.py:175).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def banded_transition_matrix(log_a: jax.Array, skip: int = 2) -> jax.Array:
    """Mask a dense (S, S) log-transition matrix to the left-to-right band.

    Allowed: s - skip <= s' <= s (predecessor band of the reference's single-word
    Viterbi, hidden_markov_model.py:181).
    """
    s = log_a.shape[0]
    frm = jax.lax.broadcasted_iota(jnp.int32, (s, s), 0)
    to = jax.lax.broadcasted_iota(jnp.int32, (s, s), 1)
    allowed = (frm <= to) & (frm >= to - skip)
    return jnp.where(allowed, log_a, -jnp.inf)


def composite_transition_matrix(
    log_a: jax.Array,
    lower_of_state: jax.Array,
    is_entry: jax.Array,
    is_exit: jax.Array,
    penalty: jax.Array | float,
    skip: int = 2,
) -> jax.Array:
    """Effective transition matrix of the flattened multi-word state space.

    lower_of_state: (S,) int32, entry-state index of the word containing s.
    is_entry/is_exit: (S,) bool masks of word entry/exit states.
    penalty: flat inter-word log-transition penalty (reference default
    log(0.005), hidden_markov_model.py:419; tuned to -100/-250 in the project5
    scripts).

    Word-internal column s: M[s', s] = log_a[s', s] iff
    max(s - skip, lower(s)) <= s' <= s  (hidden_markov_model.py:518).
    Word-entry column e: self-loop log_a[e, e] plus penalty from every word-exit
    state (hidden_markov_model.py:533-544). Tie-breaking caveat (DENSE scan
    only): on an exact float tie between an entry's self-loop and an exit at a
    HIGHER state index, the dense argmax picks the self-loop while the
    reference orders exits first. The default backends — the banded fast path
    below and the scan-free GPU kernel — implement the reference's order
    exactly; tests/test_tie_break.py constructs the exact-tie cases and
    asserts them against the reference oracle.
    """
    s = log_a.shape[0]
    frm = jax.lax.broadcasted_iota(jnp.int32, (s, s), 0)
    to = jax.lax.broadcasted_iota(jnp.int32, (s, s), 1)
    lower_to = lower_of_state[None, :]
    band = (frm <= to) & (frm >= jnp.maximum(to - skip, lower_to))
    m_internal = jnp.where(band, log_a, -jnp.inf)

    penalty = jnp.asarray(penalty, log_a.dtype)
    m_entry = jnp.where(is_exit[:, None], penalty, -jnp.inf)
    diag = frm == to
    self_loop = jnp.where(diag, log_a, -jnp.inf)
    # A single-state word is both entry and exit: take the better of its
    # self-loop and the inter-word penalty (the reference evaluates both
    # candidates separately; max reproduces its argmax winner).
    m_entry = jnp.maximum(m_entry, self_loop)

    return jnp.where(is_entry[None, :], m_entry, m_internal)


def _scan_trellis(log_b: jax.Array, trans: jax.Array, alpha0: jax.Array, length):
    """Run the forward max-plus recursion.

    Returns (alpha_final (S,), backpointers (T, S) int32). Steps with t >= length
    are no-ops (carry passes through) so padded batches score identically to
    their unpadded contents.
    """
    t_total, s = log_b.shape
    length = jnp.asarray(length, jnp.int32)

    def step(alpha, inputs):
        t, log_b_t = inputs
        scores = alpha[:, None] + trans  # (S_from, S_to)
        new_alpha = jnp.max(scores, axis=0) + log_b_t
        bp = jnp.argmax(scores, axis=0).astype(jnp.int32)
        live = t < length
        alpha = jnp.where(live, new_alpha, alpha)
        return alpha, bp

    ts = jnp.arange(1, t_total, dtype=jnp.int32)
    alpha_final, bps = jax.lax.scan(step, alpha0, (ts, log_b[1:]))
    backptrs = jnp.concatenate(
        [jnp.full((1, s), -1, jnp.int32), bps], axis=0
    )  # row 0 mirrors the reference's tracer[0] = -1 (hidden_markov_model.py:175)
    return alpha_final, backptrs


def _backtrace(backptrs: jax.Array, best_state: jax.Array, length, quirk: bool):
    """Reverse scan through the backpointers.

    Standard: path[L-1] = best, path[t] = bp[t+1, path[t+1]].
    Quirk (reference parity): the final state is dropped and the second-to-last
    repeated — path[L-1] = path[L-2] = bp[L-1, best] (hidden_markov_model.py:200-208).
    Entries at t >= length are padded with the last real state.
    """
    t_total, s = backptrs.shape
    length = jnp.asarray(length, jnp.int32)
    ts = jnp.arange(t_total - 1, 0, -1, dtype=jnp.int32)

    def rev_step(state, inputs):
        t, bp_t = inputs
        live = t <= length - 1
        emit = state
        new_state = jnp.where(live, bp_t[state], state)
        return new_state, emit

    final_state, emitted = jax.lax.scan(
        rev_step, best_state, (ts, backptrs[t_total - 1 : 0 : -1])
    )
    path = jnp.concatenate([jnp.array([final_state]), emitted[::-1]])
    if quirk:
        last = jnp.maximum(length - 1, 0)
        second = jnp.maximum(length - 2, 0)
        path = path.at[last].set(path[second])
    return path.astype(jnp.int32)


@partial(jax.jit, static_argnames=("quirk_backtrace", "skip"))
def viterbi_banded(
    log_b: jax.Array,
    log_a: jax.Array,
    length=None,
    quirk_backtrace: bool = True,
    skip: int = 2,
):
    """Single left-to-right word HMM Viterbi.

    log_b: (T, S) emission log-densities; log_a: (S, S) dense log transitions.
    Entry is pinned to state 0 and the start includes the self-loop probability,
    exactly as the reference does (hidden_markov_model.py:81-83). Score is the
    final likelihood of the last state (hidden_markov_model.py:198).

    Returns (score, path (T,) int32).
    """
    t_total, s = log_b.shape
    if length is None:
        length = t_total
    trans = banded_transition_matrix(log_a, skip=skip)
    # The reference seeds t=0 with the entry state's self-loop log-prob
    # (hidden_markov_model.py:81-83). If training drove that self-loop to
    # probability 0 (a 1-frame transient entry state), the reference's trellis
    # collapses to -inf everywhere; we treat the missing self-loop as log 1 at
    # t=0 instead (degenerate-safe init; identical whenever the self-loop is
    # finite).
    a00 = jnp.where(jnp.isfinite(log_a[0, 0]), log_a[0, 0], 0.0)
    alpha0 = jnp.full((s,), -jnp.inf, log_b.dtype).at[0].set(log_b[0, 0] + a00)
    alpha, backptrs = _scan_trellis(log_b, trans, alpha0, length)
    score = alpha[s - 1]
    path = _backtrace(backptrs, jnp.asarray(s - 1, jnp.int32), length, quirk_backtrace)
    return score, path


@partial(jax.jit, static_argnames=("quirk_backtrace", "skip"))
def viterbi_composite(
    log_b: jax.Array,
    log_a: jax.Array,
    lower_of_state: jax.Array,
    is_entry: jax.Array,
    is_exit: jax.Array,
    penalty,
    length=None,
    quirk_backtrace: bool = True,
    skip: int = 2,
):
    """Continuous-speech Viterbi over the flattened multi-word state space.

    Initialization seeds every word-entry state (hidden_markov_model.py:464-467);
    termination takes the best word-exit state (first max on ties,
    hidden_markov_model.py:566-571).

    Returns (score, path (T,) int32).
    """
    t_total, s = log_b.shape
    if length is None:
        length = t_total
    trans = composite_transition_matrix(
        log_a, lower_of_state, is_entry, is_exit, penalty, skip=skip
    )
    # Degenerate-safe init: see viterbi_banded — a zero-probability self-loop
    # on a word-entry state must not bar that word from starting the utterance.
    diag = jnp.diagonal(log_a)
    diag = jnp.where(jnp.isfinite(diag), diag, 0.0)
    alpha0 = jnp.where(is_entry, log_b[0] + diag, -jnp.inf)
    alpha, backptrs = _scan_trellis(log_b, trans, alpha0, length)

    exit_scores = jnp.where(is_exit, alpha, -jnp.inf)
    score = jnp.max(exit_scores)
    best_state = jnp.argmax(exit_scores).astype(jnp.int32)
    path = _backtrace(backptrs, best_state, length, quirk_backtrace)
    return score, path


def viterbi_banded_batch(log_b, log_a, lengths, quirk_backtrace: bool = True):
    """vmap of viterbi_banded over a padded batch: log_b (B, T, S), lengths (B,)."""
    fn = lambda b, l: viterbi_banded(b, log_a, l, quirk_backtrace=quirk_backtrace)
    return jax.vmap(fn)(log_b, lengths)


def viterbi_composite_batch(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths,
    quirk_backtrace: bool = True,
):
    """vmap of viterbi_composite over a padded batch."""
    fn = lambda b, l: viterbi_composite(
        b, log_a, lower_of_state, is_entry, is_exit, penalty, l,
        quirk_backtrace=quirk_backtrace,
    )
    return jax.vmap(fn)(log_b, lengths)


def entry_update(alpha, is_exit, penalty, pair_penalty=None,
                 word_of_state=None, uppers=None):
    """Word-entry predecessor candidates shared by the offline fast step
    and the streaming banded step (ops/streaming_batch._advance_banded —
    extracted so online/offline parity is BY CONSTRUCTION, not by keeping
    two copies character-identical).

    alpha (B, S) -> (c_pen (B, S), best_exit_idx (B, S) or (B, 1)):
    flat penalty = one shared best-exit + penalty; pair_penalty (W, W) =
    per-(from-word, to-word) tropical matvec over per-word best exits.
    Tie-breaks: lowest word index wins an exact exit tie (exit states
    ascend with word index — the dense scan's first-max).
    """
    neg = jnp.float32(-jnp.inf)
    if pair_penalty is not None:
        exit_alpha = alpha[:, uppers]                  # (B, W)
        cand = exit_alpha[:, :, None] + pair_penalty[None, :, :]
        best_pen_w = jnp.max(cand, axis=1)             # (B, W)
        best_src_w = jnp.argmax(cand, axis=1)          # (B, W) word idx
        c_pen = best_pen_w[:, word_of_state]           # (B, S)
        best_exit_idx = uppers[best_src_w[:, word_of_state]]
    else:
        exit_scores = jnp.where(is_exit[None, :], alpha, neg)  # (B, S)
        best_exit = jnp.max(exit_scores, axis=1, keepdims=True)
        best_exit_idx = jnp.argmax(exit_scores, axis=1, keepdims=True)
        c_pen = best_exit + penalty
    return c_pen, best_exit_idx


def viterbi_composite_batch_fast(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths,
    quirk_backtrace: bool = True, pair_penalty=None, word_of_state=None,
    uppers=None, beam=None,
):
    """Structure-exploiting composite batch decode.

    The dense (S, S) max-plus step does O(S^2) work and moves a (B, S, S)
    intermediate through memory every frame, but the composite topology gives
    every state at most 3 banded predecessors, and every word-entry state
    shares ONE quantity — the best word-exit score + penalty
    (hidden_markov_model.py:508-559). This step is O(S) per frame:

      non-entry j:  max(alpha[j-2]+A[j-2,j], alpha[j-1]+A[j-1,j], alpha[j]+A[j,j])
      entry e:      max(best_exit + penalty, alpha[e]+A[e,e])

    Results are identical to viterbi_composite_batch except for backpointer
    values at unreachable (-inf) cells, which no decoded path ever visits
    (the dense argmax places 0 there; this one places a band index).

    pair_penalty (W, W) replaces the flat penalty with per-(from-word,
    to-word) values (a bigram LM, ops/lm.word_pair_penalties): the entry
    update becomes a (W, W) tropical matvec over per-word best exits —
    O(S + W^2) per frame, still tiny against the banded part. Requires
    word_of_state (S,) and uppers (W,). Tie-breaks: among exits, the
    lowest word index wins an exact tie (exit states ascend with word
    index, matching the dense scan's first-max); exits beat entry
    self-loops on exact ties — the REFERENCE's order
    (hidden_markov_model.py:533-547), which diverges from the dense scan
    there exactly as the flat-penalty fast path does (see
    composite_transition_matrix's tie-break caveat).

    beam: classic per-frame beam pruning — after each update, states whose
    score falls more than `beam` below the frame's best are set to -inf
    (the reference prunes its DTW trellis the same relative way,
    dynamic_time_wrapping.py:89-95; its HMM decoder never needed it at 58
    states). beam=None (default) and beam=inf are exact. Cost note: on
    dense vectorized hardware the masking saves no FLOPs — the lever's
    value here is hypothesis control (it changes WHICH paths
    survive at large vocabularies, trading exactness for robustness to
    score-scale pathologies) and search-semantics parity with classic
    large-vocabulary decoders, not speed. Pruned states can only revive
    through a surviving predecessor, exactly like a token-passing decoder.
    """
    b, t_total, s = log_b.shape

    to = jnp.arange(s)
    diag = jnp.diagonal(log_a)
    # Banded coefficients with lower-boundary clipping (band floor at the
    # word's entry state) and -inf on entry columns (handled separately).
    sub1 = jnp.where(
        (to >= 1) & (to - 1 >= lower_of_state) & ~is_entry,
        log_a[jnp.maximum(to - 1, 0), to], -jnp.inf,
    )
    sub2 = jnp.where(
        (to >= 2) & (to - 2 >= lower_of_state) & ~is_entry,
        log_a[jnp.maximum(to - 2, 0), to], -jnp.inf,
    )
    diag_ne = jnp.where(~is_entry, diag, -jnp.inf)
    diag_e = jnp.where(is_entry, diag, -jnp.inf)
    exit_idx = jnp.where(is_exit, to, 0)
    penalty = jnp.asarray(penalty, log_b.dtype)
    if pair_penalty is not None:
        pair_penalty = jnp.asarray(pair_penalty, log_b.dtype)
        word_of_state = jnp.asarray(word_of_state, jnp.int32)
        uppers = jnp.asarray(uppers, jnp.int32)

    neg = jnp.float32(-jnp.inf)

    def step(alpha, inputs):
        t, log_b_t = inputs  # alpha (B, S)
        a1 = jnp.concatenate([jnp.full((b, 1), neg), alpha[:, :-1]], axis=1)
        a2 = jnp.concatenate([jnp.full((b, 2), neg), alpha[:, :-2]], axis=1)
        c0 = alpha + diag_ne[None, :]
        c1 = a1 + sub1[None, :]
        c2 = a2 + sub2[None, :]
        # First-max tie-break over predecessor order (j-2, j-1, j).
        v12 = jnp.maximum(c1, c0)
        val_ne = jnp.maximum(c2, v12)
        bp_ne = jnp.where(
            c2 >= v12,
            jnp.maximum(to[None, :] - 2, 0),  # clamp: only hit at -inf cells
            jnp.where(c1 >= c0, jnp.maximum(to[None, :] - 1, 0), to[None, :]),
        )

        c_pen, best_exit_idx = entry_update(
            alpha, is_exit, penalty, pair_penalty, word_of_state, uppers
        )
        c_self = alpha + diag_e[None, :]
        # Reference orders exits before the self-loop: exits win ties (:533-547).
        val_e = jnp.maximum(c_pen, c_self)
        bp_e = jnp.where(c_pen >= c_self, best_exit_idx, to[None, :])

        new_alpha = jnp.where(is_entry[None, :], val_e, val_ne) + log_b_t
        if beam is not None:
            thresh = jnp.max(new_alpha, axis=1, keepdims=True) - beam
            new_alpha = jnp.where(new_alpha >= thresh, new_alpha, neg)
        bp = jnp.where(is_entry[None, :], bp_e, bp_ne).astype(jnp.int32)
        live = (t < lengths)[:, None]
        return jnp.where(live, new_alpha, alpha), bp

    diag_init = jnp.where(jnp.isfinite(diag), diag, 0.0)
    alpha0 = jnp.where(is_entry[None, :], log_b[:, 0, :] + diag_init[None, :], neg)
    if beam is not None:
        thresh0 = jnp.max(alpha0, axis=1, keepdims=True) - beam
        alpha0 = jnp.where(alpha0 >= thresh0, alpha0, neg)
    ts = jnp.arange(1, t_total, dtype=jnp.int32)
    alpha, bps = jax.lax.scan(
        step, alpha0, (ts, jnp.swapaxes(log_b[:, 1:], 0, 1))
    )
    backptrs = jnp.concatenate(
        [jnp.full((1, b, s), -1, jnp.int32), bps], axis=0
    ).swapaxes(0, 1)  # (B, T, S)

    exit_scores = jnp.where(is_exit[None, :], alpha, neg)
    scores = jnp.max(exit_scores, axis=1)
    best = jnp.argmax(exit_scores, axis=1).astype(jnp.int32)
    paths = jax.vmap(
        lambda bp_i, st, l: _backtrace(bp_i, st, l, quirk_backtrace)
    )(backptrs, best, lengths)
    return scores, paths
