"""Single-program embedded-training iteration (the round-trip-free trainer).

The legacy ContinuousTrainer._iteration dispatches 2+ jitted calls PER
TRANSCRIPT per iteration (alignment/stats pass + centered covariance pass) and
accumulates statistics on the host. That is correct but round-trip-bound: a
7-transcript corpus pays ~14 host syncs per iteration.

This module runs the ENTIRE iteration — sentence-HMM Viterbi alignment of
every utterance of every transcript, sufficient statistics, the M-step, and
the convergence test — as ONE jitted XLA program with one host sync. The
reference semantics are unchanged (same quantities as _stats_pass /
_centered_m2_pass / ContinuousTrainer._iteration, which themselves replicate
reference hidden_markov_model.py:584-797):

  - topologies become runtime DATA: per-transcript sentence state tables
    (label, local state, word position) padded to the longest sentence, with
    per-utterance topology ids — so ONE compiled program serves every
    transcript shape, instead of one XLA program per (sentence length,
    utterance count, frame count) combination;
  - emissions are scored once against ALL (label, state) slots (one whitening
    matmul per frame chunk) and gathered per sentence state, instead of
    re-whitening per transcript;
  - the sentence trellis is purely banded (left-to-right skip-2; cross-word
    exit->entry edges are adjacent states, so they live inside the band) and
    runs as a 3-diagonal lax.scan over the WHOLE utterance batch at once
    (first-max tie-breaks identical to the dense scan's argmax);
  - the centered covariance pass exploits the hard Viterbi assignment: each
    frame belongs to exactly one (label, state) slot, so centering is ONE
    gather of that slot's new mean per frame, and the second moment is one
    (slots, frames) x (frames, D^2) matmul per chunk — no per-slot vmap that
    would materialize a (slots, B, T, D) tensor;
  - the M-step (mean/cov/transition re-estimation with empty-slot keep,
    np.cov ddof=1 denominator, cov_reg*I) and the per-label allclose
    convergence test run on-device; the host reads back only the new
    parameters, counts, and convergence flags.

Frame chunking (lax.scan over utterance chunks) bounds the two big
intermediates — the (frames, slots, D) whitened tensor and the (frames, D^2)
centered outer products — so corpus size scales without HBM blowup.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import Dict, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.gaussian import gaussian_log_pdf, make_gaussian_params
from ..ops.viterbi import _backtrace

logger = logging.getLogger(__name__)

NEG = -jnp.inf


@dataclass
class FusedCorpus:
    """Device-resident corpus + topology tables for fused_viterbi_iteration."""

    batch: jax.Array      # (n_chunks, C, T, D) f32
    lengths: jax.Array    # (n_chunks, C) i32
    topo_id: jax.Array    # (n_chunks, C) i32
    lab_tab: jax.Array    # (n_topo, S_sent) i32
    loc_tab: jax.Array    # (n_topo, S_sent) i32
    pos_tab: jax.Array    # (n_topo, S_sent) i32 (pads hold distinct negatives)
    samew_tab: jax.Array  # (n_topo, S_sent, S_sent) bool
    cross_tab: jax.Array  # (n_topo, S_sent, S_sent) bool (exit -> next entry)
    n_states_t: jax.Array  # (n_topo,) i32
    num_utts: int         # real (non-padding) utterance count
    num_frames: int       # real frame count
    sentences: list       # topo index -> sentence string (debug/bootstrap)


def prepare_fused_corpus(
    labeled_features: Dict[str, Sequence[np.ndarray]],
    state_counts: Dict[str, int],
    label_index: Dict[str, int],
    insert_silence_fn,
    length_multiple: int = 128,
    chunk_utts: int = 64,
    num_shards: int = 1,
) -> FusedCorpus:
    """Pack every transcript's utterances into one padded corpus.

    All utterances share one global T (padded to length_multiple) and one
    global sentence-state budget S_sent (the longest sentence); shorter
    sentences are padded with unreachable states (-inf columns).

    num_shards > 1 pads the chunk count to a multiple of the mesh size so the
    leading (n_chunks) axis can be sharded over the data axis; padding
    utterances have length 0 and contribute nothing to the statistics."""
    from .train_continuous import _topology

    sentences, topo_of_sentence = [], {}
    feats_all, lengths_all, topo_ids = [], [], []
    for transcript, feats in labeled_features.items():
        sentence = insert_silence_fn(transcript)
        if sentence not in topo_of_sentence:
            topo_of_sentence[sentence] = len(sentences)
            sentences.append(sentence)
        tid = topo_of_sentence[sentence]
        for x in feats:
            x = np.asarray(x, np.float32)
            feats_all.append(x)
            lengths_all.append(x.shape[0])
            topo_ids.append(tid)
    if not feats_all:
        raise ValueError("empty corpus")

    d = feats_all[0].shape[1]
    t_max = -(-max(lengths_all) // length_multiple) * length_multiple
    b = len(feats_all)
    c = min(chunk_utts, -(-b // 8) * 8)
    b_pad = -(-b // (c * num_shards)) * (c * num_shards)
    batch = np.zeros((b_pad, t_max, d), np.float32)
    for i, x in enumerate(feats_all):
        batch[i, : x.shape[0]] = x
    lengths = np.zeros(b_pad, np.int32)
    lengths[:b] = lengths_all
    topo_id = np.zeros(b_pad, np.int32)
    topo_id[:b] = topo_ids

    topos = [_topology(s, state_counts, label_index) for s in sentences]
    s_sent = max(len(t.lab_of_state) for t in topos)
    n_topo = len(topos)
    lab_tab = np.zeros((n_topo, s_sent), np.int32)
    loc_tab = np.zeros((n_topo, s_sent), np.int32)
    # Pad positions with distinct negatives so padded states never compare
    # equal to anything (not to real positions, not to each other).
    pos_tab = -1 - np.tile(np.arange(s_sent, dtype=np.int32), (n_topo, 1))
    n_states_t = np.zeros(n_topo, np.int32)
    samew_tab = np.zeros((n_topo, s_sent, s_sent), bool)
    cross_tab = np.zeros((n_topo, s_sent, s_sent), bool)
    for k, topo in enumerate(topos):
        n = len(topo.lab_of_state)
        n_states_t[k] = n
        lab_tab[k, :n] = topo.lab_of_state
        loc_tab[k, :n] = topo.loc_of_state
        pos_tab[k, :n] = topo.pos_of_state
        pos = topo.pos_of_state
        samew_tab[k, :n, :n] = pos[:, None] == pos[None, :]
        is_entry = np.zeros(n, bool)
        is_exit = np.zeros(n, bool)
        for p in range(pos.max() + 1):
            idx = np.where(pos == p)[0]
            is_entry[idx[0]] = True
            is_exit[idx[-1]] = True
        cross_tab[k, :n, :n] = (
            is_exit[:, None] & is_entry[None, :] & (pos[None, :] == pos[:, None] + 1)
        )

    n_chunks = b_pad // c
    return FusedCorpus(
        batch=jnp.asarray(batch.reshape(n_chunks, c, t_max, d)),
        lengths=jnp.asarray(lengths.reshape(n_chunks, c)),
        topo_id=jnp.asarray(topo_id.reshape(n_chunks, c)),
        lab_tab=jnp.asarray(lab_tab),
        loc_tab=jnp.asarray(loc_tab),
        pos_tab=jnp.asarray(pos_tab),
        samew_tab=jnp.asarray(samew_tab),
        cross_tab=jnp.asarray(cross_tab),
        n_states_t=jnp.asarray(n_states_t),
        num_utts=b,
        num_frames=int(sum(lengths_all)),
        sentences=sentences,
    )


def _sentence_trans_diagonals(log_a_g, lab_u, loc_u, samew_u, cross_u,
                              cross_word: str):
    """Per-utterance banded transition coefficients (c0=self, c1=prev, c2=skip).

    Build the full per-utterance sentence transition rule — word-internal
    entries gathered from the global (L, S, S) bank, cross-word entries free
    per the cross_word mode (train_continuous._sentence_log_a) — restricted to
    the 3 diagonals the skip-2 band can ever read."""
    b, ss = lab_u.shape
    gathered = log_a_g[lab_u[:, :, None], loc_u[:, :, None], loc_u[:, None, :]]
    if cross_word == "band":
        la = jnp.where(samew_u, gathered, 0.0)
    else:
        la = jnp.where(samew_u, gathered, jnp.where(cross_u, 0.0, NEG))
    j = jnp.arange(ss)
    c0 = la[:, j, j]
    c1 = jnp.where(j >= 1, la[:, jnp.maximum(j - 1, 0), j], NEG)
    c2 = jnp.where(j >= 2, la[:, jnp.maximum(j - 2, 0), j], NEG)
    return c0, c1, c2


def _banded_trellis_batch(log_b, c0, c1, c2, lengths, n_states):
    """Whole-batch banded sentence Viterbi.

    log_b (B, T, S_sent), coefficients (B, S_sent), lengths (B,),
    n_states (B,) -> (scores (B,), paths (B, T) i32). Tie-breaks match the
    dense scan's first-max argmax (smallest predecessor index wins), and the
    backtrace applies the reference's final-frame quirk — so paths are
    identical to viterbi_banded_batch over the same sentence, which is what
    the legacy _stats_pass uses (itself replicating hidden_markov_model.py
    :160-208 run over the concatenated sentence states)."""
    b, t_total, ss = log_b.shape
    # Degenerate-safe init (see ops.viterbi.viterbi_banded): a zero-probability
    # entry self-loop must not bar the sentence from starting.
    a00 = jnp.where(jnp.isfinite(c0[:, 0]), c0[:, 0], 0.0)
    alpha0 = jnp.full((b, ss), NEG, log_b.dtype).at[:, 0].set(log_b[:, 0, 0] + a00)

    neg_col = jnp.full((b, 1), NEG, log_b.dtype)

    def step(alpha, inputs):
        t, lb_t = inputs
        a1 = jnp.concatenate([neg_col, alpha[:, :-1]], axis=1)
        a2 = jnp.concatenate([neg_col, neg_col, alpha[:, :-2]], axis=1)
        idx = jnp.arange(ss)[None, :]
        # Candidates in ascending predecessor order; strict > keeps the
        # earliest on ties (the dense argmax's first-max semantics).
        best = a2 + c2
        bp = jnp.broadcast_to(jnp.maximum(idx - 2, 0), (b, ss))
        cand = a1 + c1
        take = cand > best
        best = jnp.where(take, cand, best)
        bp = jnp.where(take, jnp.maximum(idx - 1, 0), bp)
        cand = alpha + c0
        take = cand > best
        best = jnp.where(take, cand, best)
        bp = jnp.where(take, idx, bp)
        new_alpha = best + lb_t
        live = t < lengths[:, None]
        return jnp.where(live, new_alpha, alpha), bp.astype(jnp.int32)

    ts = jnp.arange(1, t_total, dtype=jnp.int32)
    alpha, bps = jax.lax.scan(step, alpha0, (ts, jnp.moveaxis(log_b[:, 1:], 1, 0)))
    bps = jnp.concatenate(
        [jnp.full((1, b, ss), -1, jnp.int32), bps], axis=0
    )  # tracer[0] = -1, reference hidden_markov_model.py:175
    final = jnp.maximum(n_states - 1, 0).astype(jnp.int32)
    scores = jnp.take_along_axis(alpha, final[:, None], axis=1)[:, 0]
    bt = partial(_backtrace, quirk=True)
    paths = jax.vmap(lambda bp, f, ln: bt(bp, f, ln))(
        jnp.moveaxis(bps, 0, 1), final, lengths
    )
    return scores, paths


def _pool_slots(stat, tie_flat):
    """State-level parameter tying: sum a per-slot statistic over tie groups
    and broadcast each group total back to its member slots.

    tie_flat (F,) int32 maps every flat (label, state) slot to a tie-group id
    in [0, F); untied slots carry unique ids (singleton segments), for which
    segment_sum returns the element itself — bitwise-identical to no pooling.
    Tied slots then re-estimate from their POOLED statistics, so they end the
    M-step with identical parameters: this is senone-style shared-state
    training (Young et al. 1994) expressed as one scatter-add + gather, with
    alignment/trellis passes untouched. No reference equivalent (the
    reference ties nothing below the word level)."""
    pooled = jax.ops.segment_sum(
        stat, tie_flat, num_segments=stat.shape[0]
    )
    return pooled[tie_flat]


def _tie_operands(tie_flat, trans_tie, conv_tie, num_labels: int, s_max: int):
    """Materialize identity tie maps for the shard_map entry points (which
    pass ties as explicit replicated operands). Identity pooling —
    segment_sum over singleton segments — is bitwise-identical to no
    pooling, and identity convergence groups preserve the per-label freeze
    semantics, so absent ties cost nothing semantically."""
    if tie_flat is None:
        tie_flat = jnp.arange(num_labels * s_max, dtype=jnp.int32)
    if trans_tie is None:
        trans_tie = jnp.arange(num_labels, dtype=jnp.int32)
    if conv_tie is None:
        conv_tie = jnp.arange(num_labels, dtype=jnp.int32)
    return (jnp.asarray(tie_flat, jnp.int32),
            jnp.asarray(trans_tie, jnp.int32),
            jnp.asarray(conv_tie, jnp.int32))


def _couple_convergence(converged_l, conv_tie):
    """Freeze tie-connected labels together: a label counts as converged
    only when every label in its convergence group is."""
    bad = jax.ops.segment_sum(
        (~converged_l).astype(jnp.int32), conv_tie,
        num_segments=converged_l.shape[0],
    )
    return bad[conv_tie] == 0


def _pool_labels(stat, trans_tie):
    """Label-level pooling of per-label statistics (transition tying: e.g.
    all triphones of one center phone share a transition matrix)."""
    pooled = jax.ops.segment_sum(
        stat, trans_tie, num_segments=stat.shape[0]
    )
    return pooled[trans_tie]


def _identity(x):
    return x


def _gather_sentence_emissions(means_g, covs_g, lab_tab, loc_tab,
                               batch, topo_id, s_max: int,
                               form: str = "whiten"):
    """All-slot Gaussian scoring, gathered per sentence state.

    Chunked (lax.scan over the leading chunk axis) because the whitened
    (frames, slots, D) intermediate is the biggest tensor of the program; the
    gathered (n_chunks, C, T, S_sent) result is small enough to keep whole.

    form="whiten": HIGHEST-precision whitening matmul (f32-exact, legacy
    parity) — a K=D=39 contraction whose (frames, slots, D) intermediate is
    the program's biggest tensor. form="quad": the serving path's
    quadratic-form layout (ops.gaussian.GaussianQuadParams) — ONE
    (frames, D^2) x (D^2, slots) matmul at K=1521; ~1e-2
    absolute emission error (one-pass form), which only perturbs exact
    near-ties in the alignment argmax."""
    l, s, d = means_g.shape
    f = l * s
    n_chunks, c, t, _ = batch.shape
    if form == "quad":
        from ..ops.gaussian import (
            gaussian_log_pdf_quad,
            make_gaussian_quad_params,
        )

        qparams = make_gaussian_quad_params(
            means_g.reshape(f, d), covs_g.reshape(f, d, d)
        )

        def emit_chunk(_, inp):
            bc, tidc = inp
            lb_all = gaussian_log_pdf_quad(
                qparams, bc.reshape(c * t, d)
            ).reshape(c, t, f)
            flat_slot = lab_tab[tidc] * s_max + loc_tab[tidc]
            return None, jax.vmap(lambda lb, fs: lb[:, fs])(lb_all, flat_slot)

        _, lb_sent = jax.lax.scan(emit_chunk, None, (batch, topo_id))
        return lb_sent
    params = make_gaussian_params(means_g.reshape(f, d), covs_g.reshape(f, d, d))

    def emit_chunk(_, inp):
        bc, tidc = inp
        lb_all = gaussian_log_pdf(params, bc.reshape(c * t, d)).reshape(c, t, f)
        flat_slot = lab_tab[tidc] * s_max + loc_tab[tidc]  # (C, S_sent)
        return None, jax.vmap(lambda lb, fs: lb[:, fs])(lb_all, flat_slot)

    _, lb_sent = jax.lax.scan(emit_chunk, None, (batch, topo_id))
    return lb_sent


def _lse3(a, b, c):
    """Elementwise logsumexp of three stacked operands, -inf-safe."""
    m = jnp.maximum(jnp.maximum(a, b), c)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out = m_safe + jnp.log(
        jnp.exp(a - m_safe) + jnp.exp(b - m_safe) + jnp.exp(c - m_safe)
    )
    return jnp.where(jnp.isfinite(m), out, NEG)


def _banded_fb_batch(log_b, c0, c1, c2, lengths, n_states):
    """Whole-batch banded forward-backward over the sentence band.

    log_b (B, T, S_sent), banded coefficients (B, S_sent) indexed by
    DESTINATION state (c0 self, c1 from prev, c2 skip), lengths (B,),
    n_states (B,). Matches ops.forward_backward.{forward,backward} run over
    the banded sentence transition matrix with log_init pinned to state 0 and
    log_final pinned to the sentence's last real state.

    Returns (log_alpha (B, T, S), log_beta (B, T, S), ll (B,))."""
    b, t_total, ss = log_b.shape
    neg_col = jnp.full((b, 1), NEG, log_b.dtype)
    alpha0 = jnp.full((b, ss), NEG, log_b.dtype).at[:, 0].set(log_b[:, 0, 0])

    def fstep(alpha, inputs):
        t, lb_t = inputs
        a1 = jnp.concatenate([neg_col, alpha[:, :-1]], axis=1)
        a2 = jnp.concatenate([neg_col, neg_col, alpha[:, :-2]], axis=1)
        new_alpha = _lse3(alpha + c0, a1 + c1, a2 + c2) + lb_t
        alpha = jnp.where(t < lengths[:, None], new_alpha, alpha)
        return alpha, alpha

    ts = jnp.arange(1, t_total, dtype=jnp.int32)
    alpha_last, alphas = jax.lax.scan(
        fstep, alpha0, (ts, jnp.moveaxis(log_b[:, 1:], 1, 0))
    )
    log_alpha = jnp.concatenate([alpha0[None], alphas], axis=0)  # (T, B, S)
    final = jnp.maximum(n_states - 1, 0).astype(jnp.int32)
    ll = jnp.take_along_axis(alpha_last, final[:, None], axis=1)[:, 0]

    beta_end = jnp.where(
        jnp.arange(ss)[None, :] == final[:, None], 0.0, NEG
    ).astype(log_b.dtype)

    def bstep(beta, inputs):
        t, lb_next = inputs
        z = lb_next + beta
        k0 = z + c0
        k1 = jnp.concatenate([(z + c1)[:, 1:], neg_col], axis=1)
        k2 = jnp.concatenate([(z + c2)[:, 2:], neg_col, neg_col], axis=1)
        new_beta = _lse3(k0, k1, k2)
        # Frames at/after length-1 restart from the final-state pin (matches
        # ops.forward_backward.backward's padded-frame handling).
        beta = jnp.where(t + 1 < lengths[:, None], new_beta, beta_end)
        return beta, beta

    ts_b = jnp.arange(t_total - 2, -1, -1, dtype=jnp.int32)
    _, betas = jax.lax.scan(
        bstep, beta_end, (ts_b, jnp.moveaxis(log_b[:, :0:-1], 1, 0))
    )
    log_beta = jnp.concatenate([betas[::-1], beta_end[None]], axis=0)
    return (
        jnp.moveaxis(log_alpha, 0, 1),
        jnp.moveaxis(log_beta, 0, 1),
        ll,
    )


def _iteration_body(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    *, cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str,
    emissions: str = "whiten",
    reduce_fn=_identity,
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """Shared body of the fused iteration (single-device and mesh-sharded).

    reduce_fn is applied to every sufficient statistic before the M-step:
    identity on a single device, psum over the data axis under shard_map —
    the only difference between the two deployments, so the M-step (and
    therefore the trained parameters) are bitwise-identical by construction
    modulo the reduction order.

    tie_flat (F,) / trans_tie (L,) int32, optional: state-level emission
    tying and label-level transition tying — statistics pool over tie groups
    before the M-step (see _pool_slots), so tied slots train as ONE shared
    distribution. None (default) leaves the program untouched. conv_tie (L,)
    int32, optional: convergence-coupling groups — labels sharing a tie group
    freeze TOGETHER (a label freezing early while a tie partner keeps
    updating would silently un-share the tied parameters); untied labels
    keep the reference's per-label freeze semantics.
    """
    l, s, d = means_g.shape
    f = num_labels * s_max
    n_chunks, c, t, _ = batch.shape
    b = n_chunks * c

    lb_sent = _gather_sentence_emissions(
        means_g, covs_g, lab_tab, loc_tab, batch, topo_id, s_max,
        form=emissions,
    )
    s_sent = lb_sent.shape[-1]

    # ---- trellis: ONE whole-batch scan (a chunked trellis would multiply
    # the sequential per-step while-loop overhead by the chunk count).
    topo_flat = topo_id.reshape(b)
    c0, c1, c2 = _sentence_trans_diagonals(
        log_a_g, lab_tab[topo_flat], loc_tab[topo_flat],
        samew_tab[topo_flat], cross_tab[topo_flat], cross_word,
    )
    _scores, paths_flat = _banded_trellis_batch(
        lb_sent.reshape(b, t, s_sent), c0, c1, c2,
        lengths.reshape(b), n_states_t[topo_flat],
    )
    paths = paths_flat.reshape(n_chunks, c, t)

    # ---- pass A: zeroth/first-order stats + transition counts (chunked:
    # the (C, T, slots) one-hots are the memory hog here).
    def pass_a(carry, inp):
        counts, sums, trans = carry
        bc, lc, tidc, path = inp
        lab_u = lab_tab[tidc]
        loc_u = loc_tab[tidc]
        pos_u = pos_tab[tidc]
        mask = jnp.arange(t)[None, :] < lc[:, None]
        lab_p = jnp.take_along_axis(lab_u, path, axis=1)
        loc_p = jnp.take_along_axis(loc_u, path, axis=1)
        pos_p = jnp.take_along_axis(pos_u, path, axis=1)
        flat = lab_p * s_max + loc_p
        oh = jax.nn.one_hot(flat, f, dtype=jnp.float32) * mask[..., None]
        counts = counts + jnp.sum(oh, axis=(0, 1))
        sums = sums + jnp.einsum(
            "btf,btd->fd", oh, bc, precision=jax.lax.Precision.HIGHEST
        )
        pair_live = (jnp.arange(t - 1)[None, :] < (lc[:, None] - 1)) & (
            pos_p[:, :-1] == pos_p[:, 1:]
        )
        from_flat = (
            lab_p[:, :-1] * (s_max * s_max)
            + loc_p[:, :-1] * s_max
            + loc_p[:, 1:]
        )
        ohp = jax.nn.one_hot(
            from_flat, f * s_max, dtype=jnp.float32
        ) * pair_live[..., None]
        trans = trans + jnp.sum(ohp, axis=(0, 1))
        return (counts, sums, trans), None

    init = (
        jnp.zeros((f,), jnp.float32),
        jnp.zeros((f, d), jnp.float32),
        jnp.zeros((f * s_max,), jnp.float32),
    )
    (counts_f, sums, trans_f), _ = jax.lax.scan(
        pass_a, init, (batch, lengths, topo_id, paths)
    )
    counts_f = reduce_fn(counts_f)
    sums = reduce_fn(sums)
    trans_f = reduce_fn(trans_f)
    if tie_flat is not None:
        counts_f = _pool_slots(counts_f, tie_flat)
        sums = _pool_slots(sums, tie_flat)
    counts = counts_f.reshape(l, s)
    trans = trans_f.reshape(l, s, s)
    if trans_tie is not None:
        trans = _pool_labels(trans, trans_tie)

    # ---- M-step: means + convergence ----
    empty = slot_used & (counts < 1.0)
    new_means = (sums / jnp.maximum(counts_f, 1.0)[:, None]).reshape(l, s, d)
    new_means = jnp.where(empty[..., None], means_g, new_means)
    # np.allclose(new, old): |new - old| <= atol + rtol * |old|.
    close = jnp.abs(new_means - means_g) <= atol + rtol * jnp.abs(means_g)
    converged_l = jnp.all(close.all(-1) | ~slot_used, axis=-1)  # (L,)
    if conv_tie is not None:
        converged_l = _couple_convergence(converged_l, conv_tie)

    # ---- pass B: covariance centered on the NEW means (np.cov parity) ----
    new_means_flat = new_means.reshape(f, d)

    def pass_b(m2, inp):
        bc, lc, path, tidc = inp
        c, t, _d = bc.shape
        lab_u = lab_tab[tidc]
        loc_u = loc_tab[tidc]
        lab_p = jnp.take_along_axis(lab_u, path, axis=1)
        loc_p = jnp.take_along_axis(loc_u, path, axis=1)
        flat = lab_p * s_max + loc_p
        mask = jnp.arange(t)[None, :] < lc[:, None]
        oh = jax.nn.one_hot(flat, f, dtype=jnp.float32) * mask[..., None]
        # Hard assignment: each frame has exactly one slot, so centering is a
        # single per-frame gather of that slot's new mean.
        xc = bc - new_means_flat[flat]
        x2 = (xc[..., :, None] * xc[..., None, :]).reshape(c * t, d * d)
        m2 = m2 + jax.lax.dot_general(
            oh.reshape(c * t, f), x2, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return m2, None

    m2_flat, _ = jax.lax.scan(
        pass_b, jnp.zeros((f, d * d), jnp.float32),
        (batch, lengths, paths, topo_id),
    )
    m2_flat = reduce_fn(m2_flat)
    if tie_flat is not None:
        # Tied slots share new_means, so each pooled m2 is centered at its
        # group mean — the group covariance with np.cov ddof=1 on the GROUP
        # count follows exactly.
        m2_flat = _pool_slots(m2_flat, tie_flat)
    m2 = m2_flat.reshape(l, s, d, d)
    denom = jnp.maximum(counts - 1.0, 1.0)[..., None, None]  # np.cov ddof=1
    eye = jnp.eye(d, dtype=jnp.float32)
    new_covs = m2 / denom + cov_reg * eye
    new_covs = jnp.where(empty[..., None, None], covs_g, new_covs)
    # Padded slots keep identity covariance so the next Cholesky stays valid.
    new_covs = jnp.where(slot_used[..., None, None], new_covs, eye)

    # ---- transitions ----
    row_sums = trans.sum(axis=2, keepdims=True)
    probs = trans / jnp.maximum(row_sums, 1.0)
    new_log_a = jnp.where(probs > 0, jnp.log(probs), NEG)
    no_out = (row_sums[..., 0] < 1.0) & slot_used
    new_log_a = jnp.where(no_out[..., None], log_a_g, new_log_a)

    # Converged labels keep their parameters this iteration (reference raises
    # HMMTrainConverge before assignment, hidden_markov_model.py:333-335).
    keep = converged_l[:, None, None]
    new_means = jnp.where(keep, means_g, new_means)
    new_covs = jnp.where(keep[..., None], covs_g, new_covs)
    new_log_a = jnp.where(keep, log_a_g, new_log_a)

    return new_means, new_covs, new_log_a, counts, converged_l, paths


_BW_FLOOR = 1e-4  # soft-count floor (train_continuous._iteration's BW branch)


def _bw_body(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    *, cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str,
    emissions: str = "whiten",
    reduce_fn=_identity,
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """Baum-Welch analogue of _iteration_body: one XLA program per iteration.

    Soft forward-backward posteriors over the banded sentence topology replace
    the hard Viterbi one-hots (same quantities as train_continuous's
    _stats_pass_bw + _centered_m2_pass_weighted + the BW branch of
    _iteration). Cross-word xi mass is excluded from the transition counts
    (within-word pairs only), termination is pinned to the sentence's last
    state — both matching the legacy path.

    The covariance uses the König decomposition around the global weighted
    mean c: sum_t w_tf (x - mu_f)(x - mu_f)^T = sum_t w_tf (x - c)(x - c)^T
    - counts_f d_f d_f^T with d_f = mu_f - c. Both accumulated terms are
    centered (residuals of the corpus spread, not raw magnitudes), so one
    HIGHEST-precision f32 einsum per chunk suffices — same conditioning
    rationale as parallel.data_parallel._local_kmeans_stats.

    Returns (new_means, new_covs, new_log_a, counts, converged_l, ll_sum).
    """
    l, s, d = means_g.shape
    f = num_labels * s_max
    n_chunks, c, t, _ = batch.shape
    b = n_chunks * c
    hi = jax.lax.Precision.HIGHEST

    lb_sent = _gather_sentence_emissions(
        means_g, covs_g, lab_tab, loc_tab, batch, topo_id, s_max,
        form=emissions,
    )
    s_sent = lb_sent.shape[-1]

    topo_flat = topo_id.reshape(b)
    c0, c1, c2 = _sentence_trans_diagonals(
        log_a_g, lab_tab[topo_flat], loc_tab[topo_flat],
        samew_tab[topo_flat], cross_tab[topo_flat], cross_word,
    )
    log_alpha, log_beta, ll = _banded_fb_batch(
        lb_sent.reshape(b, t, s_sent), c0, c1, c2,
        lengths.reshape(b), n_states_t[topo_flat],
    )
    # Padding utterances (length 0) have ll = -inf; exclude them everywhere.
    ll_valid = jnp.isfinite(ll)
    ll_sum = reduce_fn(jnp.sum(jnp.where(ll_valid, ll, 0.0)))

    shape_c = (n_chunks, c, t, s_sent)
    la_c = log_alpha.reshape(shape_c)
    be_c = log_beta.reshape(shape_c)
    ll_c = jnp.where(ll_valid, ll, 0.0).reshape(n_chunks, c)
    valid_c = ll_valid.reshape(n_chunks, c)
    c0_c = c0.reshape(n_chunks, c, s_sent)
    c1_c = c1.reshape(n_chunks, c, s_sent)
    c2_c = c2.reshape(n_chunks, c, s_sent)

    def gamma_of(la, be, llc, lc, vc):
        """Posterior state occupancies for one chunk, padding-safe."""
        mask = (jnp.arange(t)[None, :] < lc[:, None]) & vc[:, None]
        g = jnp.exp(la + be - llc[:, None, None])
        return jnp.where(mask[..., None], g, 0.0)

    # ---- pass A: soft counts / frame sums / within-word transition mass ----
    def pass_a(carry, inp):
        counts, sums, trans = carry
        (bc, lc, tidc, la, be, llc, vc, lb, c0k, c1k, c2k) = inp
        gam = gamma_of(la, be, llc, lc, vc)  # (C, T, S_sent)
        flat_slot = lab_tab[tidc] * s_max + loc_tab[tidc]
        oh = jax.nn.one_hot(flat_slot, f, dtype=jnp.float32)  # (C, S_sent, F)
        gam_f = jnp.einsum("cts,csf->ctf", gam, oh, precision=hi)
        counts = counts + jnp.sum(gam_f, axis=(0, 1))
        sums = sums + jnp.einsum("ctf,ctd->fd", gam_f, bc, precision=hi)

        # xi over the three band diagonals, within-word pairs only.
        lab_u = lab_tab[tidc]
        loc_u = loc_tab[tidc]
        samew_u = samew_tab[tidc]
        pair_mask = (
            (jnp.arange(t - 1)[None, :, None] + 1 < lc[:, None, None])
            & vc[:, None, None]
        )
        zb = lb[:, 1:] + be[:, 1:]  # (C, T-1, S_sent)
        for k, ck in ((0, c0k), (1, c1k), (2, c2k)):
            if k == 0:
                a_shift = la[:, :-1]
                samew_k = jnp.ones((c, s_sent), bool)  # self-loop: same state
                loc_from = loc_u
            else:
                # destination-indexed shifts: value at state v comes from v-k
                a_shift = jnp.concatenate(
                    [jnp.full((c, t - 1, k), NEG), la[:, :-1, :-k]], axis=2
                )
                samew_k = jnp.concatenate(
                    [jnp.zeros((c, k), bool),
                     jnp.diagonal(samew_u, offset=k, axis1=1, axis2=2)],
                    axis=1,
                )
                loc_from = jnp.concatenate(
                    [jnp.zeros((c, k), jnp.int32), loc_u[:, : s_sent - k]],
                    axis=1,
                )
            log_xi = a_shift + ck[:, None, :] + zb - llc[:, None, None]
            xi = jnp.where(
                pair_mask & samew_k[:, None, :], jnp.exp(log_xi), 0.0
            )
            xi_sum = jnp.sum(xi, axis=1)  # (C, S_sent)
            from_flat = lab_u * (s_max * s_max) + loc_from * s_max + loc_u
            ohp = jax.nn.one_hot(from_flat, f * s_max, dtype=jnp.float32)
            trans = trans + jnp.einsum("cv,cvq->q", xi_sum, ohp, precision=hi)
        return (counts, sums, trans), None

    init = (
        jnp.zeros((f,), jnp.float32),
        jnp.zeros((f, d), jnp.float32),
        jnp.zeros((f * s_max,), jnp.float32),
    )
    (counts_f, sums, trans_f), _ = jax.lax.scan(
        pass_a, init,
        (batch, lengths, topo_id, la_c, be_c, ll_c, valid_c, lb_sent,
         c0_c, c1_c, c2_c),
    )
    counts_f = reduce_fn(counts_f)
    sums = reduce_fn(sums)
    trans_f = reduce_fn(trans_f)
    if tie_flat is not None:
        counts_f = _pool_slots(counts_f, tie_flat)
        sums = _pool_slots(sums, tie_flat)
    counts = counts_f.reshape(l, s)
    trans = trans_f.reshape(l, s, s)
    if trans_tie is not None:
        trans = _pool_labels(trans, trans_tie)

    # ---- M-step: means + convergence (BW floors) ----
    empty = slot_used & (counts < _BW_FLOOR)
    new_means = (
        sums / jnp.maximum(counts_f, _BW_FLOOR)[:, None]
    ).reshape(l, s, d)
    new_means = jnp.where(empty[..., None], means_g, new_means)
    close = jnp.abs(new_means - means_g) <= atol + rtol * jnp.abs(means_g)
    converged_l = jnp.all(close.all(-1) | ~slot_used, axis=-1)
    if conv_tie is not None:
        converged_l = _couple_convergence(converged_l, conv_tie)

    # ---- pass B: covariance via König around the global weighted mean ----
    new_means_flat = new_means.reshape(f, d)
    total = jnp.maximum(jnp.sum(counts_f), _BW_FLOOR)
    c_glob = jnp.sum(sums, axis=0) / total  # (D,)
    d_f = new_means_flat - c_glob

    def pass_b(sxx, inp):
        bc, lc, tidc, la, be, llc, vc = inp
        gam = gamma_of(la, be, llc, lc, vc)
        flat_slot = lab_tab[tidc] * s_max + loc_tab[tidc]
        oh = jax.nn.one_hot(flat_slot, f, dtype=jnp.float32)
        gam_f = jnp.einsum("cts,csf->ctf", gam, oh, precision=hi)
        xc = (bc - c_glob).reshape(c * t, d)
        x2 = (xc[:, :, None] * xc[:, None, :]).reshape(c * t, d * d)
        sxx = sxx + jax.lax.dot_general(
            gam_f.reshape(c * t, f), x2, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=hi,
        )
        return sxx, None

    sxx_flat, _ = jax.lax.scan(
        pass_b, jnp.zeros((f, d * d), jnp.float32),
        (batch, lengths, topo_id, la_c, be_c, ll_c, valid_c),
    )
    sxx_flat = reduce_fn(sxx_flat)
    if tie_flat is not None:
        # König around c_glob holds for any fixed centering point; pooling
        # sxx and using the pooled counts with the shared group mean gives
        # the exact group covariance. (c_glob itself is computed from the
        # broadcast pooled sums — a different but still fixed point.)
        sxx_flat = _pool_slots(sxx_flat, tie_flat)
    sxx = sxx_flat.reshape(f, d, d)
    m2 = (
        sxx - counts_f[:, None, None] * (d_f[:, :, None] * d_f[:, None, :])
    ).reshape(l, s, d, d)
    denom = jnp.maximum(counts, _BW_FLOOR)[..., None, None]
    eye = jnp.eye(d, dtype=jnp.float32)
    new_covs = m2 / denom + cov_reg * eye
    new_covs = jnp.where(empty[..., None, None], covs_g, new_covs)
    new_covs = jnp.where(slot_used[..., None, None], new_covs, eye)

    # ---- transitions ----
    row_sums = trans.sum(axis=2, keepdims=True)
    probs = trans / jnp.maximum(row_sums, _BW_FLOOR)
    new_log_a = jnp.where(probs > 0, jnp.log(probs), NEG)
    no_out = (row_sums[..., 0] < _BW_FLOOR) & slot_used
    new_log_a = jnp.where(no_out[..., None], log_a_g, new_log_a)

    keep = converged_l[:, None, None]
    new_means = jnp.where(keep, means_g, new_means)
    new_covs = jnp.where(keep[..., None], covs_g, new_covs)
    new_log_a = jnp.where(keep, log_a_g, new_log_a)

    return new_means, new_covs, new_log_a, counts, converged_l, ll_sum


@partial(jax.jit, static_argnames=(
    "num_labels", "s_max", "cross_word", "cov_reg", "rtol", "atol",
    "emissions"))
def fused_bw_iteration(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str = "exit_only",
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """One embedded Baum-Welch iteration as one XLA program (see _bw_body)."""
    return _bw_body(
        means_g, covs_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id,
        cov_reg=cov_reg, rtol=rtol, atol=atol,
        num_labels=num_labels, s_max=s_max, cross_word=cross_word,
        emissions=emissions, tie_flat=tie_flat, trans_tie=trans_tie,
        conv_tie=conv_tie,
    )


@partial(jax.jit, static_argnames=(
    "mesh", "num_labels", "s_max", "cross_word", "cov_reg", "rtol",
    "atol", "emissions"))
def fused_bw_iteration_sharded(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id, mesh,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str = "exit_only",
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """Mesh-sharded fused Baum-Welch (psum'd soft statistics; see
    fused_viterbi_iteration_sharded for the sharding layout)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.data_parallel import DATA_AXIS

    tie_flat, trans_tie, conv_tie = _tie_operands(
        tie_flat, trans_tie, conv_tie, num_labels, s_max)

    def body(*args):
        *main, tf, tt, cv = args
        return _bw_body(
            *main,
            cov_reg=cov_reg, rtol=rtol, atol=atol,
            num_labels=num_labels, s_max=s_max, cross_word=cross_word,
            emissions=emissions,
            reduce_fn=lambda x: jax.lax.psum(x, DATA_AXIS),
            tie_flat=tf, trans_tie=tt, conv_tie=cv,
        )

    rep, sh = P(), P(DATA_AXIS)
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(rep,) * 10 + (sh, sh, sh) + (rep, rep, rep),
        out_specs=(rep,) * 6,
        check_vma=False,
    )(
        means_g, covs_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id, tie_flat, trans_tie, conv_tie,
    )


@partial(jax.jit, static_argnames=(
    "num_labels", "s_max", "cross_word", "cov_reg", "rtol", "atol",
    "emissions"))
def fused_viterbi_iteration(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str = "exit_only",
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """One embedded-training iteration as one XLA program.

    Returns (new_means, new_covs, new_log_a, counts, converged_l, paths):
    the COMMITTED M-step result — empty-slot/no-outgoing keep-old applied AND
    the per-label converged mask applied (converged models keep their
    parameters, matching ContinuousTrainer._iteration / reference
    hidden_markov_model.py:333-335) — per-slot frame counts, per-label
    convergence flags (reference allclose on means), and the Viterbi paths
    (n_chunks, C, T). The returned parameter arrays can therefore be fed
    straight back in as the next iteration's state without any host logic;
    the host only reads counts (empty-slot policy) and converged_l (stop).
    """
    return _iteration_body(
        means_g, covs_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id,
        cov_reg=cov_reg, rtol=rtol, atol=atol,
        num_labels=num_labels, s_max=s_max, cross_word=cross_word,
        emissions=emissions, tie_flat=tie_flat, trans_tie=trans_tie,
        conv_tie=conv_tie,
    )


def _train_loop_body(iteration_body, max_iterations: int):
    """Wrap a single-iteration body into a whole-run lax.while_loop.

    The loop carry is (means, covs, log_a, counts, it, converged): the
    ENTIRE multi-iteration training run — every alignment, every M-step,
    every convergence test — executes as one device dispatch with zero host
    round trips. Iteration counting matches the host-driven loop exactly:
    the body runs until the iteration that detects convergence (whose
    parameter updates are already suppressed in-jit by the converged-label
    keep mask), or until max_iterations.
    """

    def cond(carry):
        _means, _covs, _log_a, _counts, it, converged = carry
        return jnp.logical_and(it < max_iterations, ~converged)

    def body(carry):
        means, covs, log_a, _counts, it, _conv = carry
        new_means, new_covs, new_log_a, counts, converged_l, _ = (
            iteration_body(means, covs, log_a)
        )
        return (
            new_means, new_covs, new_log_a, counts, it + 1,
            jnp.all(converged_l),
        )

    def run(means, covs, log_a, counts0):
        init = (means, covs, log_a, counts0, jnp.int32(0), jnp.bool_(False))
        means, covs, log_a, counts, it, converged = jax.lax.while_loop(
            cond, body, init
        )
        return means, covs, log_a, counts, it, converged

    return run


@partial(jax.jit, static_argnames=(
    "num_labels", "s_max", "cross_word", "cov_reg", "rtol", "atol",
    "max_iterations", "update", "emissions"))
def fused_train_run(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str,
    max_iterations: int, update: str = "viterbi",
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """The ENTIRE embedded training run as ONE XLA program.

    lax.while_loop over fused iterations (Viterbi or Baum-Welch bodies) with
    the convergence test on-device: the host dispatches once and reads back
    only the final parameters, final counts, and the iteration count. Use
    when no per-iteration host work is needed (no checkpointing, empty-slot
    policy "keep"); the per-iteration entry points remain for resumable runs.

    Returns (means, covs, log_a, counts, iterations, converged).
    """
    body_fn = _iteration_body if update == "viterbi" else _bw_body

    def one_iter(means, covs, log_a):
        return body_fn(
            means, covs, log_a, slot_used,
            lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
            batch, lengths, topo_id,
            cov_reg=cov_reg, rtol=rtol, atol=atol,
            num_labels=num_labels, s_max=s_max, cross_word=cross_word,
            emissions=emissions, tie_flat=tie_flat, trans_tie=trans_tie,
            conv_tie=conv_tie,
        )

    run = _train_loop_body(one_iter, max_iterations)
    counts0 = jnp.zeros((num_labels, s_max), jnp.float32)
    return run(means_g, covs_g, log_a_g, counts0)


@partial(jax.jit, static_argnames=(
    "mesh", "num_labels", "s_max", "cross_word", "cov_reg", "rtol",
    "atol", "max_iterations", "update", "emissions"))
def fused_train_run_sharded(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id, mesh,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str,
    max_iterations: int, update: str = "viterbi",
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """Whole-run device loop over a data-parallel mesh: the psums cross
    the device interconnect inside the while_loop, so N chips complete the full multi-iteration
    training with a single host dispatch."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.data_parallel import DATA_AXIS

    body_fn = _iteration_body if update == "viterbi" else _bw_body
    tie_flat, trans_tie, conv_tie = _tie_operands(
        tie_flat, trans_tie, conv_tie, num_labels, s_max)

    def run_shard(
        means_g, covs_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id, tie_flat, trans_tie, conv_tie,
    ):
        def one_iter(means, covs, log_a):
            return body_fn(
                means, covs, log_a, slot_used,
                lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
                batch, lengths, topo_id,
                cov_reg=cov_reg, rtol=rtol, atol=atol,
                num_labels=num_labels, s_max=s_max, cross_word=cross_word,
                emissions=emissions,
                reduce_fn=lambda x: jax.lax.psum(x, DATA_AXIS),
                tie_flat=tie_flat, trans_tie=trans_tie, conv_tie=conv_tie,
            )

        run = _train_loop_body(one_iter, max_iterations)
        counts0 = jnp.zeros((num_labels, s_max), jnp.float32)
        return run(means_g, covs_g, log_a_g, counts0)

    rep, sh = P(), P(DATA_AXIS)
    return shard_map(
        run_shard,
        mesh=mesh,
        in_specs=(rep,) * 10 + (sh, sh, sh) + (rep, rep, rep),
        out_specs=(rep,) * 6,
        check_vma=False,
    )(
        means_g, covs_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id, tie_flat, trans_tie, conv_tie,
    )


@partial(jax.jit, static_argnames=(
    "mesh", "num_labels", "s_max", "cross_word", "cov_reg", "rtol",
    "atol", "emissions"))
def fused_viterbi_iteration_sharded(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id, mesh,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str = "exit_only",
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """The fused iteration over a data-parallel mesh — still ONE program.

    The corpus (batch/lengths/topo_id, leading n_chunks axis) is sharded over
    the mesh's data axis; parameters and topology tables are replicated (the
    flagship model is ~350 KB — replication IS the right sharding, SURVEY.md
    §2.4). Each device aligns its shard and the four sufficient statistics
    cross the interconnect once via psum; the tiny M-step runs replicated, so every
    device finishes the iteration holding identical new parameters. This is
    the multi-chip form of the reference's per-utterance ProcessPoolExecutor
    E-step (hidden_markov_model.py:746-750) with the whole pickle-over-fork
    machinery replaced by one collective.

    Requires batch.shape[0] (chunk count) divisible by the mesh size — use
    prepare_fused_corpus(num_shards=mesh.devices.size). Returned parameters/
    counts/flags are replicated; paths keep the corpus sharding.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.data_parallel import DATA_AXIS

    tie_flat, trans_tie, conv_tie = _tie_operands(
        tie_flat, trans_tie, conv_tie, num_labels, s_max)

    def body(*args):
        *main, tf, tt, cv = args
        return _iteration_body(
            *main,
            cov_reg=cov_reg, rtol=rtol, atol=atol,
            num_labels=num_labels, s_max=s_max, cross_word=cross_word,
            emissions=emissions,
            reduce_fn=lambda x: jax.lax.psum(x, DATA_AXIS),
            tie_flat=tf, trans_tie=tt, conv_tie=cv,
        )

    rep, sh = P(), P(DATA_AXIS)
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(rep,) * 10 + (sh, sh, sh) + (rep, rep, rep),
        out_specs=(rep, rep, rep, rep, rep, sh),
        check_vma=False,
    )(
        means_g, covs_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id, tie_flat, trans_tie, conv_tie,
    )
