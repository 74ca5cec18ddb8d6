"""N-best composite Viterbi: per-state top-K hypothesis beams.

The reference decoder emits exactly one hypothesis (hidden_markov_model.py:
458-461). Serving systems want alternatives (rescoring, confidence). This is
the standard k-best Viterbi: every state carries its K best distinct path
prefixes; a step merges the banded predecessors' beams (and, for word-entry
states, the globally shared top-K word-exit pool + penalty) with jax.lax.top_k.
All merges are whole-state-vector ops inside one lax.scan, so the recursion
stays a whole-vector scan like the 1-best path (ops/viterbi.py).

Hypotheses are distinct STATE paths; distinct paths may decode to the same
word string — `nbest_decode` dedupes at the string level.
"""
from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = np.float32(-np.inf)


@partial(jax.jit, static_argnames=("k",))
def kbest_composite_forward(
    log_b: jax.Array,
    log_a: jax.Array,
    lower_of_state: jax.Array,
    is_entry: jax.Array,
    is_exit: jax.Array,
    penalty,
    length=None,
    k: int = 4,
):
    """Forward pass with K hypotheses per state.

    log_b (T, S) -> (alpha (S, K) final scores, bp (T, S, K) int32 encoding
    pred_state * K + pred_k, -1 on the seed frame).
    """
    t_total, s = log_b.shape
    if length is None:
        length = t_total
    length = jnp.asarray(length, jnp.int32)
    penalty = jnp.asarray(penalty, log_b.dtype)

    to = jnp.arange(s)
    diag = jnp.diagonal(log_a)
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

    def step(carry, inputs):
        alpha, = carry
        t, log_b_t = inputs  # alpha (S, K)

        # Banded candidates: predecessors s-2, s-1, s -> (S, 3K)
        a1 = jnp.concatenate([jnp.full((1, k), NEG), alpha[:-1]], axis=0)
        a2 = jnp.concatenate([jnp.full((2, k), NEG), alpha[:-2]], axis=0)
        c0 = alpha + diag_ne[:, None]
        c1 = a1 + sub1[:, None]
        c2 = a2 + sub2[:, None]
        cand_ne = jnp.concatenate([c2, c1, c0], axis=1)  # (S, 3K)
        # Encoded predecessor of candidate j in [0, 3K): block b = j // K
        # (0: s-2, 1: s-1, 2: s), slot = j % K.
        pred_state_ne = jnp.stack(
            [jnp.maximum(to - 2, 0), jnp.maximum(to - 1, 0), to], axis=1
        )  # (S, 3)
        top_ne, idx_ne = jax.lax.top_k(cand_ne, k)  # (S, K)
        blk = idx_ne // k
        slot = idx_ne % k
        bp_ne = jnp.take_along_axis(pred_state_ne, blk, axis=1) * k + slot

        # Entry candidates: shared top-K of the exit pool (+ penalty), plus
        # the entry's own K self-loop hypotheses.
        pool = jnp.where(is_exit[:, None], alpha, NEG).reshape(-1)  # (S*K,)
        pool_top, pool_idx = jax.lax.top_k(pool, k)  # (K,)
        c_pen = pool_top + penalty  # (K,)
        c_self = alpha + diag_e[:, None]  # (S, K)
        # Single-state words are both entry and exit: the pool candidate and
        # the self-loop candidate can carry the SAME predecessor (w, slot) —
        # identical path prefixes filling two beam slots. Keep only the
        # better-scored copy (pool wins exact ties, matching the reference's
        # exits-before-self-loop order, hidden_markov_model.py:533-547).
        both = is_entry & is_exit
        slot_ids = to[:, None] * k + jnp.arange(k)[None, :]  # (S, K)
        dup_self = both[:, None] & (
            slot_ids[:, :, None] == pool_idx[None, None, :]
        ).any(-1)
        pool_beats = (penalty >= diag)[:, None]  # same alpha on both sides
        c_self = jnp.where(dup_self & pool_beats, NEG, c_self)
        c_pen_row = jnp.broadcast_to(c_pen[None, :], (s, k))
        dup_pool = both[:, None] & (pool_idx[None, :] // k == to[:, None])
        c_pen_row = jnp.where(dup_pool & ~pool_beats, NEG, c_pen_row)
        cand_e = jnp.concatenate([c_pen_row, c_self], axis=1)  # (S, 2K)
        top_e, idx_e = jax.lax.top_k(cand_e, k)
        from_pool = idx_e < k
        bp_pool = jnp.broadcast_to(pool_idx[None, :], (s, k))
        bp_pool_sel = jnp.take_along_axis(bp_pool, jnp.minimum(idx_e, k - 1), axis=1)
        bp_self = to[:, None] * k + (idx_e - k)
        bp_e = jnp.where(from_pool, bp_pool_sel, bp_self)

        entry_col = is_entry[:, None]
        new_alpha = jnp.where(entry_col, top_e, top_ne) + log_b_t[:, None]
        bp = jnp.where(entry_col, bp_e, bp_ne).astype(jnp.int32)

        live = t < length
        alpha = jnp.where(live, new_alpha, alpha)
        return (alpha,), bp

    alpha0 = jnp.full((s, k), NEG)
    alpha0 = alpha0.at[:, 0].set(
        jnp.where(is_entry, log_b[0] + jnp.where(jnp.isfinite(diag), diag, 0.0), NEG)
    )
    ts = jnp.arange(1, t_total, dtype=jnp.int32)
    (alpha,), bps = jax.lax.scan(step, (alpha0,), (ts, log_b[1:]))
    backptrs = jnp.concatenate(
        [jnp.full((1, s, k), -1, jnp.int32), bps], axis=0
    )
    return alpha, backptrs


def nbest_paths(
    alpha: np.ndarray,
    backptrs: np.ndarray,
    is_exit: np.ndarray,
    length: int,
    n: int,
    quirk_backtrace: bool = True,
) -> List[Tuple[float, np.ndarray]]:
    """Backtrace the n best exit-terminated hypotheses (host-side).

    quirk_backtrace applies the same final-frame quirk as the 1-best decoder
    (path[L-1] = path[L-2], ops/viterbi.py:_backtrace) so the n-best top-1
    agrees with ContinuousDecoder.predict on every frame, not just up to the
    reference's dropped final state."""
    s, k = alpha.shape
    pool = np.where(is_exit[:, None], alpha, -np.inf).reshape(-1)
    order = np.argsort(pool)[::-1][:n]
    out = []
    for flat in order:
        if not np.isfinite(pool[flat]):
            break
        state, slot = divmod(int(flat), k)
        path = np.zeros(length, np.int64)
        path[-1] = state
        for t in range(length - 1, 0, -1):
            code = int(backptrs[t, state, slot])
            state, slot = divmod(code, k)
            path[t - 1] = state
        if quirk_backtrace and length >= 2:
            path[length - 1] = path[length - 2]
        out.append((float(pool[flat]), path))
    return out


def nbest_decode(composite, features, n: int = 4, beam_k: int | None = None,
                 quirk_backtrace: bool = True, log_b=None):
    """N-best word strings for one utterance's (T, D) features.

    Returns [(score, digit_string), ...] best-first, deduped at the string
    level (distinct state paths can share a transcription). log_b overrides
    the emission matrix (e.g. GMM densities from
    ContinuousDecoder.predict_nbest — the composite's own log_likelihoods
    are single-Gaussian).
    """
    if beam_k is None:
        # Distinct state paths often share a transcription; a wider beam
        # raises the chance of n DISTINCT strings surviving the dedupe.
        beam_k = max(2 * n, 4)
    if log_b is None:
        log_b = composite.log_likelihoods(features)
    alpha, backptrs = kbest_composite_forward(
        log_b, jnp.asarray(composite.log_a),
        jnp.asarray(composite.lower_of_state), jnp.asarray(composite.is_entry),
        jnp.asarray(composite.is_exit), composite.penalty, k=beam_k,
    )
    hyps = nbest_paths(
        np.asarray(alpha), np.asarray(backptrs), composite.is_exit,
        int(np.asarray(features).shape[0]), n * 2,
        quirk_backtrace=quirk_backtrace,
    )
    seen = {}
    for score, path in hyps:
        text = "".join(composite.path_to_labels(path))
        if text not in seen:
            seen[text] = score
        if len(seen) >= n:
            break
    return [(score, text) for text, score in sorted(
        seen.items(), key=lambda kv: -kv[1]
    )][:n]
