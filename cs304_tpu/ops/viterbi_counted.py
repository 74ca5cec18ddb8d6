"""Word-count-constrained composite Viterbi.

The reference approximates "this utterance has N digits" by sweeping the
flat inter-word penalty until the decoder averages N words
(scripts/project5_find_trans_ndigits_*.py) — a global knob that trades
insertions against deletions corpus-wide. When the count IS known (fixed
phone-number length, the n-digit eval splits, form filling), the exact
constraint is a tiny finite-state automaton: compose the composite trellis
with a word counter and decode the best path that emits EXACTLY N counted
words (silence is free).

Device shape: the trellis state becomes (N+1, S) — count plane x composite
state, ~500 cells at the flagship size — and one time step is the same
whole-array max-plus update as the unconstrained scan:

  stay (same plane):   banded within-word moves + entry self-loops
  cross (plane c-1->c for counted words, c->c for silence):
                       word-exit -> word-entry + penalty

Termination takes the best word-exit in plane N exactly. Backpointers pack
(plane, state) into one int32. Entry seeding, the exits-over-self-loop
tie order, and the reference backtrace quirk follow ops/viterbi.py.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _stay_matrix(log_a, lower_of_state, is_entry, skip=2):
    """(S, S) log transitions that do NOT end a word: the banded
    within-word moves (band floor at the word's entry state) plus each
    entry state's self-loop."""
    s = log_a.shape[0]
    frm = jax.lax.broadcasted_iota(jnp.int32, (s, s), 0)
    to = jax.lax.broadcasted_iota(jnp.int32, (s, s), 1)
    band = (frm <= to) & (frm >= jnp.maximum(to - skip, lower_of_state[None, :]))
    m = jnp.where(band & ~is_entry[None, :], log_a, -jnp.inf)
    diag = frm == to
    m = jnp.where(diag & is_entry[None, :], log_a, m)
    return m


@partial(jax.jit, static_argnames=("n_words", "n_words_min",
                                   "quirk_backtrace"))
def viterbi_composite_counted(
    log_b, log_a, lower_of_state, is_entry, is_exit, counted_word_of_state,
    penalty, n_words: int, length=None, quirk_backtrace: bool = True,
    n_words_min: int | None = None,
):
    """Decode the best path emitting exactly n_words counted words — or,
    with n_words_min set, between n_words_min and n_words inclusive (the
    count-RANGE constraint, e.g. the reference's 2-7-digit corpus shape).

    counted_word_of_state: (S,) bool — True for states of words that count
    toward n_words (False for silence). Returns (score, path (T,) int32);
    score is -inf when no path with an admissible count exists within T
    frames.
    """
    t_total, s = log_b.shape
    if length is None:
        length = t_total
    length = jnp.asarray(length, jnp.int32)
    c_planes = n_words + 1

    stay = _stay_matrix(log_a, lower_of_state, is_entry)
    penalty = jnp.asarray(penalty, log_b.dtype)
    counted_entry = is_entry & counted_word_of_state
    sil_entry = is_entry & ~counted_word_of_state

    diag = jnp.diagonal(log_a)
    diag_init = jnp.where(jnp.isfinite(diag), diag, 0.0)
    # Seeding: starting inside word w at t=0 counts w once (plane 1) for
    # counted words, plane 0 for silence.
    plane_idx = jnp.arange(c_planes, dtype=jnp.int32)[:, None]     # (C, 1)
    seed_plane = jnp.where(counted_entry, 1, 0)[None, :]           # (1, S)
    alpha0 = jnp.where(
        is_entry[None, :] & (plane_idx == seed_plane),
        (log_b[0] + diag_init)[None, :], -jnp.inf,
    )  # (C, S)

    sidx = jnp.arange(s, dtype=jnp.int32)

    def step(alpha, inputs):
        t, log_b_t = inputs  # alpha (C, S)
        # Stay moves within the plane.
        stay_scores = alpha[:, :, None] + stay[None, :, :]   # (C, S', S)
        stay_val = jnp.max(stay_scores, axis=1)
        stay_bp = jnp.argmax(stay_scores, axis=1).astype(jnp.int32)

        # Cross moves: best exit per plane.
        exit_scores = jnp.where(is_exit[None, :], alpha, -jnp.inf)
        be = jnp.max(exit_scores, axis=1)                    # (C,)
        be_idx = jnp.argmax(exit_scores, axis=1).astype(jnp.int32)
        # Counted entries read plane c-1; silence entries read plane c.
        be_prev = jnp.concatenate([jnp.array([-jnp.inf]), be[:-1]])
        be_prev_idx = jnp.concatenate([jnp.array([0], jnp.int32), be_idx[:-1]])
        src_val = jnp.where(counted_entry[None, :], be_prev[:, None],
                            be[:, None])                     # (C, S)
        src_idx = jnp.where(counted_entry[None, :], be_prev_idx[:, None],
                            be_idx[:, None])
        src_plane = jnp.where(
            counted_entry[None, :], jnp.maximum(plane_idx - 1, 0), plane_idx
        )
        cross_val = jnp.where(is_entry[None, :], src_val + penalty, -jnp.inf)

        # Exits win exact ties against the entry self-loop (the reference's
        # candidate order, hidden_markov_model.py:533-547).
        use_cross = cross_val >= stay_val
        new_alpha = jnp.maximum(stay_val, cross_val) + log_b_t[None, :]
        bp_state = jnp.where(use_cross, src_idx, stay_bp)
        bp_plane = jnp.where(use_cross, src_plane,
                             jnp.broadcast_to(plane_idx, (c_planes, s)))
        packed = (bp_plane * s + bp_state).astype(jnp.int32)

        live = t < length
        alpha = jnp.where(live, new_alpha, alpha)
        return alpha, packed

    ts = jnp.arange(1, t_total, dtype=jnp.int32)
    alpha_last, packs = jax.lax.scan(step, alpha0, (ts, log_b[1:]))
    backptrs = jnp.concatenate(
        [jnp.full((1, c_planes, s), -1, jnp.int32), packs], axis=0
    )  # (T, C, S)

    lo = n_words if n_words_min is None else n_words_min
    final_exit = jnp.where(
        is_exit[None, :], alpha_last[lo : n_words + 1], -jnp.inf
    )  # (hi-lo+1, S)
    score = jnp.max(final_exit)
    flat = jnp.argmax(final_exit).astype(jnp.int32)
    best_plane = flat // s + lo
    best_state = flat % s

    # Backtrace over the packed (plane, state) pointers.
    start = best_plane * s + best_state

    def rev_step(packed_state, inputs):
        t, bp_t = inputs  # bp_t (C, S) packed
        live = t <= length - 1
        emit = packed_state
        nxt = bp_t.reshape(-1)[packed_state]
        return jnp.where(live, nxt, packed_state), emit

    rts = jnp.arange(t_total - 1, 0, -1, dtype=jnp.int32)
    final_packed, emitted = jax.lax.scan(
        rev_step, start, (rts, backptrs[t_total - 1 : 0 : -1])
    )
    packed_path = jnp.concatenate([jnp.array([final_packed]), emitted[::-1]])
    path = (packed_path % s).astype(jnp.int32)
    if quirk_backtrace:
        last = jnp.maximum(length - 1, 0)
        second = jnp.maximum(length - 2, 0)
        path = path.at[last].set(path[second])
    return score, path


def viterbi_composite_counted_batch(
    log_b, log_a, lower_of_state, is_entry, is_exit, counted_word_of_state,
    penalty, n_words: int, lengths, quirk_backtrace: bool = True,
):
    """vmap of viterbi_composite_counted over a padded batch."""
    fn = lambda b, l: viterbi_composite_counted(
        b, log_a, lower_of_state, is_entry, is_exit, counted_word_of_state,
        penalty, n_words, l, quirk_backtrace=quirk_backtrace,
    )
    return jax.vmap(fn)(log_b, lengths)
