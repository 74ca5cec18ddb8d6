"""Batched live-stream serving: B concurrent online decodes per dispatch.

ops/streaming.py decodes ONE live stream; a serving deployment has hundreds
of concurrent microphones at different points in their utterances. Advancing
them one dispatch each would pay the per-dispatch overhead B times per chunk
interval; this module advances ALL slots chunk-synchronously in ONE device
dispatch per step:

- device-resident state: the (B, S) alpha carry plus a (B, T_max, S)
  backpointer ring (int8 when S <= 127 — the flagship's 58 states fit — so
  the flagship ring is byte-sized; int32 otherwise). Both buffers are
  donated back to the step program, so XLA updates them in place.
- staggered starts: each slot carries its own absolute frame clock; a slot
  whose clock is 0 is (re)seeded from its first frame inside the step, so
  recycling a slot never needs a host-side state write.
- per-step fill levels: the host mirrors each slot's frame count exactly
  (it supplies the valid counts), so `fill()` is free.
- slot recycling: `release()` returns a slot to the free list; the stale
  device rows are overwritten by the next stream's seed.
- finalize: device-side backtrace (the offline decoder's reverse scan,
  ops/viterbi.py:_backtrace) + word compaction (ops/words.py) for every slot
  in one dispatch; the host reads back only scores + word ids. Per-stream
  results are offline-exact (tests/test_streaming_batch.py).

The recursion is the single-stream one (composite_transition_matrix max-plus
steps), so chunk boundaries and co-resident streams are invisible to each
stream's math.
"""
from __future__ import annotations

import logging
from functools import partial
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .viterbi import _backtrace, composite_transition_matrix, entry_update
from .words import words_from_paths

logger = logging.getLogger(__name__)

__all__ = ["BatchedStreamingComposite", "ring_dtype"]


def ring_dtype(num_states: int):
    """Backpointer storage dtype: state indices (+ the -1 seed sentinel)."""
    return jnp.int8 if num_states <= 127 else jnp.int32


def _advance(alpha, ring, t, valid, log_b, trans, seed_alpha_bias, is_entry):
    """Core chunk advance shared by the Gaussian/GMM step programs.

    alpha (B, S) f32, ring (B, T_max, S), t/valid (B,) int32,
    log_b (B, C, S). Returns (alpha, ring, t + valid).
    """
    _b, t_max, s = ring.shape
    c = log_b.shape[1]
    neg_inf = jnp.float32(-jnp.inf)

    def step(carry, inputs):
        alpha, ring = carry
        i, log_b_i = inputs  # log_b_i (B, S)
        live = i < valid  # (B,)
        abs_t = t + i
        scores = alpha[:, :, None] + trans[None]  # (B, S', S)
        new_alpha = jnp.max(scores, axis=1) + log_b_i
        bp = jnp.argmax(scores, axis=1).astype(ring.dtype)
        # Absolute frame 0 seeds the recursion (entry states only) — this is
        # what lets a recycled slot restart without host-side state writes.
        seed = jnp.where(is_entry[None, :], log_b_i + seed_alpha_bias[None, :],
                         neg_inf)
        is_seed = (abs_t == 0)[:, None]
        new_alpha = jnp.where(is_seed, seed, new_alpha)
        bp = jnp.where(is_seed, jnp.asarray(-1, ring.dtype), bp)
        alpha = jnp.where(live[:, None], new_alpha, alpha)

        def write(ring_b, bp_b, idx, lv):
            cur = jax.lax.dynamic_slice(ring_b, (idx, 0), (1, s))
            row = jnp.where(lv, bp_b[None], cur)
            return jax.lax.dynamic_update_slice(ring_b, row, (idx, 0))

        ring = jax.vmap(write)(
            ring, bp, jnp.clip(abs_t, 0, t_max - 1), live
        )
        return (alpha, ring), None

    (alpha, ring), _ = jax.lax.scan(
        step, (alpha, ring),
        (jnp.arange(c, dtype=jnp.int32), jnp.moveaxis(log_b, 1, 0)),
    )
    return alpha, ring, t + valid


def _banded_coeffs(log_a, lower_of_state, is_entry, is_exit, penalty,
                   pair_penalty=None, word_of_state=None, uppers=None):
    """Per-state banded coefficients of the composite step — the O(S)
    structure-exploiting layout of ops/viterbi.viterbi_composite_batch_fast
    (every state has <= 3 banded predecessors; every entry state shares the
    one best-exit + penalty quantity). At large S the dense step's (B, S, S)
    max-plus intermediate dominates HBM traffic; this one is O(B * S).

    pair_penalty (W, W) swaps the flat penalty for per-(from-word, to-word)
    values (a bigram LM, ops/lm.word_pair_penalties): the entry update
    becomes a (W, W) tropical matvec over per-word best exits — LM-aware
    ONLINE decoding with the same per-step cost class."""
    s = log_a.shape[0]
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
    lm = None
    if pair_penalty is not None:
        lm = (jnp.asarray(pair_penalty, jnp.float32),
              jnp.asarray(word_of_state, jnp.int32),
              jnp.asarray(uppers, jnp.int32))
    return (sub1, sub2, diag_ne, diag_e, is_exit,
            jnp.asarray(penalty, jnp.float32), lm)


def _advance_banded(alpha, ring, t, valid, log_b, coeffs, seed_alpha_bias,
                    is_entry):
    """Banded-step twin of _advance: same carry/ring contract, O(S) math.

    Backpointer values differ from the dense step only at unreachable
    (-inf) cells no backtrace visits, plus the documented exact-tie order
    (exits beat entry self-loops — the reference's order); parity with the
    offline fast backend is asserted in tests/test_streaming_batch.py.
    """
    sub1, sub2, diag_ne, diag_e, is_exit, penalty, lm = coeffs
    b, t_max, s = ring.shape
    c = log_b.shape[1]
    neg_inf = jnp.float32(-jnp.inf)
    to = jnp.arange(s)

    def step(carry, inputs):
        alpha, ring = carry
        i, log_b_i = inputs  # (B, S)
        live = i < valid
        abs_t = t + i
        a1 = jnp.concatenate([jnp.full((b, 1), neg_inf), alpha[:, :-1]],
                             axis=1)
        a2 = jnp.concatenate([jnp.full((b, 2), neg_inf), alpha[:, :-2]],
                             axis=1)
        c0 = alpha + diag_ne[None, :]
        c1 = a1 + sub1[None, :]
        c2 = a2 + sub2[None, :]
        v12 = jnp.maximum(c1, c0)
        val_ne = jnp.maximum(c2, v12)
        bp_ne = jnp.where(
            c2 >= v12,
            jnp.maximum(to[None, :] - 2, 0),
            jnp.where(c1 >= c0, jnp.maximum(to[None, :] - 1, 0),
                      to[None, :]),
        )
        pair, word_of_state, uppers = lm if lm is not None else (
            None, None, None
        )
        c_pen, best_exit_idx = entry_update(
            alpha, is_exit, penalty, pair, word_of_state, uppers
        )
        c_self = alpha + diag_e[None, :]
        val_e = jnp.maximum(c_pen, c_self)
        bp_e = jnp.where(c_pen >= c_self, best_exit_idx, to[None, :])

        new_alpha = jnp.where(is_entry[None, :], val_e, val_ne) + log_b_i
        bp = jnp.where(is_entry[None, :], bp_e, bp_ne).astype(ring.dtype)
        seed = jnp.where(is_entry[None, :],
                         log_b_i + seed_alpha_bias[None, :], neg_inf)
        is_seed = (abs_t == 0)[:, None]
        new_alpha = jnp.where(is_seed, seed, new_alpha)
        bp = jnp.where(is_seed, jnp.asarray(-1, ring.dtype), bp)
        alpha = jnp.where(live[:, None], new_alpha, alpha)

        def write(ring_b, bp_b, idx, lv):
            cur = jax.lax.dynamic_slice(ring_b, (idx, 0), (1, s))
            row = jnp.where(lv, bp_b[None], cur)
            return jax.lax.dynamic_update_slice(ring_b, row, (idx, 0))

        ring = jax.vmap(write)(
            ring, bp, jnp.clip(abs_t, 0, t_max - 1), live
        )
        return (alpha, ring), None

    (alpha, ring), _ = jax.lax.scan(
        step, (alpha, ring),
        (jnp.arange(c, dtype=jnp.int32), jnp.moveaxis(log_b, 1, 0)),
    )
    return alpha, ring, t + valid


def _advance_compact(alpha, ring, slot_ids, t, valid, log_b, seed_bias,
                     is_entry, trans=None, coeffs=None):
    """Compact+scatter advance: the same recursion as _advance /
    _advance_banded, but over K fed rows instead of all B slots.

    alpha (B, S) and ring (B, T_max, S) stay device-resident and donated;
    slot_ids (K,) int32 names each compact row's slot (padding rows carry
    B, an out-of-range id every scatter drops), t/valid (K,) are the fed
    rows' clocks and frame counts, log_b (K, C, S). Only the K fed rows'
    alpha is gathered, advanced, and scattered back; ring backpointer rows
    are scattered at (slot, abs_t). Idle slots are untouched BY
    CONSTRUCTION (their ids never appear), which is what makes the
    sparse-upload serving path exact, not approximate."""
    b, t_max, s = ring.shape
    k, c, _ = log_b.shape
    neg_inf = jnp.float32(-jnp.inf)
    to = jnp.arange(s)
    rows = alpha.at[slot_ids].get(mode="fill", fill_value=-jnp.inf)  # (K, S)

    def step(carry, inputs):
        rows, ring = carry
        i, log_b_i = inputs  # (K, S)
        live = i < valid
        abs_t = t + i
        if trans is not None:
            scores = rows[:, :, None] + trans[None]  # (K, S', S)
            new_rows = jnp.max(scores, axis=1) + log_b_i
            bp = jnp.argmax(scores, axis=1).astype(ring.dtype)
        else:
            sub1, sub2, diag_ne, diag_e, is_exit, penalty, lm = coeffs
            a1 = jnp.concatenate(
                [jnp.full((k, 1), neg_inf), rows[:, :-1]], axis=1
            )
            a2 = jnp.concatenate(
                [jnp.full((k, 2), neg_inf), rows[:, :-2]], axis=1
            )
            c0 = rows + diag_ne[None, :]
            c1 = a1 + sub1[None, :]
            c2 = a2 + sub2[None, :]
            v12 = jnp.maximum(c1, c0)
            val_ne = jnp.maximum(c2, v12)
            bp_ne = jnp.where(
                c2 >= v12,
                jnp.maximum(to[None, :] - 2, 0),
                jnp.where(c1 >= c0, jnp.maximum(to[None, :] - 1, 0),
                          to[None, :]),
            )
            pair, word_of_state, uppers = lm if lm is not None else (
                None, None, None
            )
            c_pen, best_exit_idx = entry_update(
                rows, is_exit, penalty, pair, word_of_state, uppers
            )
            c_self = rows + diag_e[None, :]
            val_e = jnp.maximum(c_pen, c_self)
            bp_e = jnp.where(c_pen >= c_self, best_exit_idx, to[None, :])
            new_rows = jnp.where(is_entry[None, :], val_e, val_ne) + log_b_i
            bp = jnp.where(is_entry[None, :], bp_e, bp_ne).astype(ring.dtype)
        seed = jnp.where(is_entry[None, :], log_b_i + seed_bias[None, :],
                         neg_inf)
        is_seed = (abs_t == 0)[:, None]
        new_rows = jnp.where(is_seed, seed, new_rows)
        bp = jnp.where(is_seed, jnp.asarray(-1, ring.dtype), bp)
        rows = jnp.where(live[:, None], new_rows, rows)
        # Dead rows (padding, or frames past this row's valid count) point
        # out of range and are dropped by the scatter.
        idx_slot = jnp.where(live, slot_ids, b)
        ring = ring.at[idx_slot, jnp.clip(abs_t, 0, t_max - 1)].set(
            bp, mode="drop"
        )
        return (rows, ring), None

    (rows, ring), _ = jax.lax.scan(
        step, (rows, ring),
        (jnp.arange(c, dtype=jnp.int32), jnp.moveaxis(log_b, 1, 0)),
    )
    alpha = alpha.at[jnp.where(valid > 0, slot_ids, b)].set(
        rows, mode="drop"
    )
    return alpha, ring


@partial(jax.jit, donate_argnums=(0, 1), static_argnames=("kind", "banded"))
def _step_compact(alpha, ring, slot_ids, t, valid, feats, topo, seed_bias,
                  is_entry, eparams, kind: str, banded: bool):
    """One compact-upload pool step: emissions for the K fed rows only,
    then the compact+scatter advance. kind selects the emission layout
    ('whiten' | 'quad' | 'gmm'); banded selects the step math."""
    from .gaussian import (
        GaussianParams,
        gaussian_log_pdf,
        gaussian_log_pdf_quad,
        gmm_log_pdf,
    )

    kk, c, d = feats.shape
    flat = feats.reshape(kk * c, d)
    if kind == "whiten":
        log_b = gaussian_log_pdf(GaussianParams(*eparams), flat)
    elif kind == "quad":
        log_b = gaussian_log_pdf_quad(eparams, flat)
    else:
        log_b = gmm_log_pdf(eparams, flat)
    log_b = log_b.reshape(kk, c, -1)
    trans, coeffs = (topo, None) if not banded else (None, topo)
    return _advance_compact(alpha, ring, slot_ids, t, valid, log_b,
                            seed_bias, is_entry, trans=trans, coeffs=coeffs)


@partial(jax.jit, donate_argnums=(0, 1))
def _step_gaussian_banded(alpha, ring, t, valid, feats, coeffs, seed_bias,
                          is_entry, means, whiten, log_norm):
    from .gaussian import GaussianParams, gaussian_log_pdf

    params = GaussianParams(means=means, whiten=whiten, log_norm=log_norm)
    b, c, d = feats.shape
    log_b = gaussian_log_pdf(params, feats.reshape(b * c, d)).reshape(
        b, c, -1
    )
    return _advance_banded(alpha, ring, t, valid, log_b, coeffs, seed_bias,
                           is_entry)


@partial(jax.jit, donate_argnums=(0, 1))
def _step_gaussian_banded_quad(alpha, ring, t, valid, feats, coeffs,
                               seed_bias, is_entry, qparams):
    from .gaussian import gaussian_log_pdf_quad

    b, c, d = feats.shape
    log_b = gaussian_log_pdf_quad(qparams, feats.reshape(b * c, d)).reshape(
        b, c, -1
    )
    return _advance_banded(alpha, ring, t, valid, log_b, coeffs, seed_bias,
                           is_entry)


@partial(jax.jit, donate_argnums=(0, 1))
def _step_gmm_banded(alpha, ring, t, valid, feats, coeffs, seed_bias,
                     is_entry, gmm_params):
    from .gaussian import gmm_log_pdf

    b, c, d = feats.shape
    log_b = gmm_log_pdf(gmm_params, feats.reshape(b * c, d)).reshape(b, c, -1)
    return _advance_banded(alpha, ring, t, valid, log_b, coeffs, seed_bias,
                           is_entry)


@partial(jax.jit, donate_argnums=(0, 1))
def _step_gaussian(alpha, ring, t, valid, feats, trans, seed_bias, is_entry,
                   means, whiten, log_norm):
    from .gaussian import GaussianParams, gaussian_log_pdf

    params = GaussianParams(means=means, whiten=whiten, log_norm=log_norm)
    b, c, d = feats.shape
    log_b = gaussian_log_pdf(params, feats.reshape(b * c, d)).reshape(
        b, c, -1
    )
    return _advance(alpha, ring, t, valid, log_b, trans, seed_bias, is_entry)


@partial(jax.jit, donate_argnums=(0, 1))
def _step_gmm(alpha, ring, t, valid, feats, trans, seed_bias, is_entry,
              gmm_params):
    from .gaussian import gmm_log_pdf

    b, c, d = feats.shape
    log_b = gmm_log_pdf(gmm_params, feats.reshape(b * c, d)).reshape(b, c, -1)
    return _advance(alpha, ring, t, valid, log_b, trans, seed_bias, is_entry)


@partial(jax.jit, static_argnames=("any_state", "max_words"))
def _finalize_batch(alpha, ring, t, is_exit, word_of_state, lowers, uppers,
                    silence_word, any_state: bool, max_words: int):
    masked = alpha if any_state else jnp.where(is_exit[None, :], alpha,
                                               -jnp.inf)
    scores = jnp.max(masked, axis=1)
    best = jnp.argmax(masked, axis=1).astype(jnp.int32)
    paths = jax.vmap(
        lambda bp, bs, l: _backtrace(bp.astype(jnp.int32), bs, l, False)
    )(ring, best, t)
    ids, counts = words_from_paths(
        paths, t, word_of_state, lowers, uppers, silence_word,
        max_words=max_words,
    )
    return scores, ids, counts


class BatchedStreamingComposite:
    """B-slot chunk-synchronous online decoding over a CompositeHMM.

    >>> pool = BatchedStreamingComposite(composite, num_slots=64)
    >>> a, b = pool.start(), pool.start()
    >>> pool.step({a: chunk_a0, b: chunk_b0})   # ONE device dispatch
    >>> pool.step({a: chunk_a1})                # b idles this step
    >>> score, text = pool.finalize([a])[a]
    >>> pool.release(a)                         # slot recycled for a new mic
    """

    def __init__(self, composite, num_slots: int = 64, chunk_size: int = 16,
                 max_frames: int = 2048, gmm_params=None,
                 max_words: int = 64, mesh=None,
                 step_impl: str = "auto", bigram=None,
                 lm_weight: float = 1.0, emissions: str = "whiten",
                 sparse_upload: bool | str = "auto") -> None:
        """mesh: optional jax.sharding.Mesh with a 'data' axis — slots are
        sharded over it (each stream's recursion is independent, so the step
        and finalize programs partition with zero collectives: multi-chip
        serving capacity is num_devices x the single-chip pool). num_slots
        must divide evenly by the mesh size.

        step_impl: "dense" (the (B, S', S) max-plus matvec — optimal at the
        flagship's 58 states), "banded" (O(S) per-state coefficients, the
        offline fast backend's layout — the dense step's (B, S, S)
        intermediate is ~260 MB/frame at S=503, B=512), or "auto" (banded
        past 127 states, where the ring flips to int32 anyway).

        bigram (+ lm_weight): decode ONLINE under per-(word, word)
        inter-word penalties (ops/lm.WordBigram) — the same log-linear
        measure the offline bigram decoder uses, so streamed finals equal
        ContinuousDecoder(bigram=...) results. Forces the banded step
        (only it implements the (W, W) entry matvec).

        emissions: "whiten" (default, f32-exact) or "quad" (the decoder's
        large-vocabulary lever — the whitening step materializes a
        (slots*chunk, S, D) intermediate per step, ~640 MB at S=1003 /
        256 slots; quad is one (T, D^2) x (D^2, S) matmul, ~1e-2 logpdf drift).
        Gaussian banded step only (GMM has no quad form).

        sparse_upload: compact+scatter feature upload — step() uploads a
        (K_fed, c_pad, D) array of ONLY the fed slots (both axes bucketed
        to powers of two) and the device program gathers/advances/scatters
        just those rows, instead of shipping the dense
        (num_slots, chunk_size, D) buffer every step. The serving hot path
        feeds ~5 new frames to the talking subset per 100 ms round, so the
        dense upload was mostly zeros — this is VERDICT r3 item #3. "auto"
        (default) enables it off-mesh; decodes are bit-identical to the
        dense path (tests/test_streaming_batch.py pins parity)."""
        self.composite = composite
        self.num_slots = int(num_slots)
        self.chunk_size = int(chunk_size)
        self.max_frames = int(max_frames)
        self.max_words = int(max_words)
        c = composite
        s = c.num_states
        if step_impl not in ("auto", "dense", "banded"):
            raise ValueError(f"unknown step_impl {step_impl!r}")
        if bigram is not None:
            if step_impl == "dense":
                logger.info("bigram LM streaming uses the banded step")
            step_impl = "banded"
        elif step_impl == "auto":
            step_impl = "banded" if s > 127 else "dense"
        self.step_impl = step_impl
        if step_impl == "banded":
            lm_args = {}
            if bigram is not None:
                from .lm import word_pair_penalties

                lm_args = dict(
                    pair_penalty=word_pair_penalties(
                        composite, bigram, lm_weight
                    ),
                    word_of_state=np.asarray(
                        c.word_of_state, np.int32
                    ),
                    uppers=np.asarray(c.uppers, np.int32),
                )
            self._coeffs = _banded_coeffs(
                jnp.asarray(c.log_a), jnp.asarray(c.lower_of_state),
                jnp.asarray(c.is_entry), jnp.asarray(c.is_exit),
                jnp.float32(c.penalty), **lm_args,
            )
            self._trans = None
        else:
            self._trans = composite_transition_matrix(
                jnp.asarray(c.log_a), jnp.asarray(c.lower_of_state),
                jnp.asarray(c.is_entry), jnp.asarray(c.is_exit),
                jnp.float32(c.penalty),
            )
        diag = np.diagonal(c.log_a)
        self._seed_bias = jnp.asarray(
            np.where(np.isfinite(diag), diag, 0.0).astype(np.float32)
        )
        self._is_entry = jnp.asarray(c.is_entry)
        self._is_exit = jnp.asarray(c.is_exit)
        if emissions not in ("whiten", "quad"):
            raise ValueError(f"unknown emissions layout {emissions!r}")
        if emissions == "quad" and (gmm_params is not None
                                    or step_impl == "dense"):
            raise ValueError(
                "emissions='quad' needs the Gaussian banded step"
            )
        self.emissions = emissions
        self._gmm_params = gmm_params
        if gmm_params is None:
            if emissions == "quad":
                from .gaussian import make_gaussian_quad_params

                self._quad = make_gaussian_quad_params(
                    jnp.asarray(c.means), jnp.asarray(c.covariances)
                )
            p = c.emission_params()
            self._emission = (p.means, p.whiten, p.log_norm)
        self._sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            n_dev = mesh.devices.size
            if self.num_slots % n_dev:
                raise ValueError(
                    f"num_slots={self.num_slots} must divide evenly over the "
                    f"{n_dev}-device mesh"
                )
            self._sharding = NamedSharding(mesh, P("data"))
        self._alpha = jnp.full((self.num_slots, s), -jnp.inf, jnp.float32)
        self._ring = jnp.full(
            (self.num_slots, self.max_frames, s), -1, ring_dtype(s)
        )
        if self._sharding is not None:
            import jax as _jax

            self._alpha = _jax.device_put(self._alpha, self._sharding)
            self._ring = _jax.device_put(self._ring, self._sharding)
        self._t = np.zeros(self.num_slots, np.int32)  # exact host mirror
        self._free: List[int] = list(range(self.num_slots))[::-1]
        self._active: set[int] = set()
        # Step-fused partials (VERDICT r4 item #3): step(partials=True)
        # dispatches the any-state finalize in the same round and starts an
        # ASYNC device->host copy; a later partial_texts() poll materializes
        # it without paying a blocking full-pool sync. stream ids guard
        # against a released+reused slot reading the predecessor's text.
        self._stream_id = np.zeros(self.num_slots, np.int64)
        self._pending: Optional[dict] = None
        self._pending_prev: Optional[dict] = None
        dim = c.means.shape[-1]
        self._dim = dim
        if sparse_upload not in (True, False, "auto"):
            raise ValueError(f"unknown sparse_upload {sparse_upload!r}")
        if sparse_upload is True and self._sharding is not None:
            raise ValueError(
                "sparse_upload uses global gather/scatter slot indices — "
                "not implemented over a mesh (slots are already "
                "partitioned); use sparse_upload='auto'"
            )
        # The compact path's gather/scatter indices are per-slot global;
        # under a mesh the dense per-shard layout stays (slots are already
        # partitioned, and the full-chunk upload splits across hosts).
        self._sparse = (
            sparse_upload is True
            or (sparse_upload == "auto" and self._sharding is None)
        )
        # "auto" picks PER STEP: the compact path pays a gather/scatter on
        # top of the recursion, so it only wins when the fed set is
        # genuinely sparse (the serving partials regime). A fully-fed pool
        # (the capacity benchmarks) keeps the dense upload — measured
        # 1,560 vs ~2,4xx real-time streams at 256 fully-fed slots when
        # sparse ran unconditionally. sparse_upload=True forces it.
        self._sparse_forced = sparse_upload is True

    @classmethod
    def from_models(cls, models, penalty: float = -100.0, **kwargs
                    ) -> "BatchedStreamingComposite":
        """GMM-aware constructor from a model dict/list (the same lift as
        ContinuousDecoder / StreamingComposite.from_models)."""
        from ..models.decoder import _lift_to_gmm
        from ..models.gmm_hmm import GMMWordHMM
        from ..models.hmm import stack_word_models
        from .gaussian import make_gmm_params

        if isinstance(models, dict):
            models = list(models.values())
        models = sorted(models, key=lambda m: m.label)
        if any(isinstance(m, GMMWordHMM) for m in models):
            views, (means, covs, weights) = _lift_to_gmm(models)
            composite = stack_word_models(views, penalty)
            gmm_params = make_gmm_params(
                jnp.asarray(means), jnp.asarray(covs), jnp.asarray(weights)
            )
            return cls(composite, gmm_params=gmm_params, **kwargs)
        return cls(stack_word_models(models, penalty), **kwargs)

    # -- slot lifecycle -------------------------------------------------------
    def start(self) -> int:
        """Claim a free slot for a new stream; its first fed frame seeds it."""
        if not self._free:
            raise RuntimeError(
                f"all {self.num_slots} slots busy — release() one or build a "
                "bigger pool"
            )
        slot = self._free.pop()
        self._t[slot] = 0
        self._stream_id[slot] += 1
        self._active.add(slot)
        return slot

    def release(self, slot: int) -> None:
        """Return a slot to the free list (device rows overwritten on reuse)."""
        self._check_slot(slot)
        self._active.discard(slot)
        self._t[slot] = 0
        self._free.append(slot)

    def fill(self) -> Dict[int, int]:
        """Frames accumulated per active slot (host mirror — no device sync)."""
        return {slot: int(self._t[slot]) for slot in sorted(self._active)}

    def fill_of(self, slot: int) -> int:
        """One slot's accumulated frames — the serving ring-capacity guard
        reads this per talking session per feed(); building the full fill()
        dict there was O(active slots) per read."""
        self._check_slot(slot)
        return int(self._t[slot])

    def _check_slot(self, slot: int) -> None:
        if slot not in self._active:
            raise KeyError(f"slot {slot} is not active")

    # -- streaming ------------------------------------------------------------
    def step(self, feeds: Dict[int, np.ndarray],
             partials: bool = False) -> None:
        """Advance fed slots by their chunks in ONE device dispatch.

        feeds: slot -> (c, D) float32 features, c <= chunk_size. Slots not in
        feeds idle (their state is untouched). An empty feeds dict is a no-op.

        partials=True additionally dispatches the any-state finalize for the
        whole pool in the same round and starts an async device->host copy of
        the word ids — the next partial_texts() poll then costs no blocking
        device sync (the transfer overlaps the caller's host work between
        rounds). This was VERDICT r4 item #3: per-poll syncs pinned partials
        serving capacity flat in N.
        """
        if not feeds:
            return
        checked = {}
        for slot, feats in feeds.items():
            self._check_slot(slot)
            feats = np.asarray(feats, np.float32)
            if feats.ndim != 2 or feats.shape[1] != self._dim:
                raise ValueError(
                    f"slot {slot}: expected (c, {self._dim}) features, got "
                    f"{feats.shape}"
                )
            c = feats.shape[0]
            if c > self.chunk_size:
                raise ValueError(
                    f"slot {slot}: chunk of {c} frames exceeds chunk_size="
                    f"{self.chunk_size} — split it across steps"
                )
            if self._t[slot] + c > self.max_frames:
                raise ValueError(
                    f"slot {slot}: {self._t[slot]} + {c} frames exceeds "
                    f"max_frames={self.max_frames} — finalize or enlarge the "
                    "ring"
                )
            checked[slot] = feats
        if self._sparse and checked:
            k_pad = max(8, 1 << (len(checked) - 1).bit_length())
            if self._sparse_forced or k_pad <= self.num_slots // 2:
                self._step_sparse(checked)
                if partials:
                    self._dispatch_partials()
                return
        # Bucket the dense upload's time axis to the deepest fed chunk
        # (power-of-two buckets, a handful of compiled shapes): the serving
        # loop feeds ~10 frames per 100 ms round, so shipping the full
        # (B, chunk_size=32, D) buffer would move >3x the bytes.
        c_used = max(f.shape[0] for f in checked.values())
        c_pad = min(self.chunk_size,
                    max(4, 1 << (int(c_used) - 1).bit_length()))
        chunk = np.zeros(
            (self.num_slots, c_pad, self._dim), np.float32
        )
        valid = np.zeros(self.num_slots, np.int32)
        for slot, feats in checked.items():
            chunk[slot, : feats.shape[0]] = feats
            valid[slot] = feats.shape[0]
        t_dev, valid_dev, chunk_dev = self._put_sharded(
            self._t, valid, chunk
        )
        if self.step_impl == "banded":
            if self._gmm_params is not None:
                self._alpha, self._ring, _ = _step_gmm_banded(
                    self._alpha, self._ring, t_dev, valid_dev,
                    chunk_dev, self._coeffs, self._seed_bias,
                    self._is_entry, self._gmm_params,
                )
            elif self.emissions == "quad":
                self._alpha, self._ring, _ = _step_gaussian_banded_quad(
                    self._alpha, self._ring, t_dev, valid_dev,
                    chunk_dev, self._coeffs, self._seed_bias,
                    self._is_entry, self._quad,
                )
            else:
                means, whiten, log_norm = self._emission
                self._alpha, self._ring, _ = _step_gaussian_banded(
                    self._alpha, self._ring, t_dev, valid_dev,
                    chunk_dev, self._coeffs, self._seed_bias,
                    self._is_entry, means, whiten, log_norm,
                )
        elif self._gmm_params is not None:
            self._alpha, self._ring, _ = _step_gmm(
                self._alpha, self._ring, t_dev, valid_dev,
                chunk_dev, self._trans, self._seed_bias,
                self._is_entry, self._gmm_params,
            )
        else:
            means, whiten, log_norm = self._emission
            self._alpha, self._ring, _ = _step_gaussian(
                self._alpha, self._ring, t_dev, valid_dev,
                chunk_dev, self._trans, self._seed_bias,
                self._is_entry, means, whiten, log_norm,
            )
        # Non-inplace: the device transfer of the OLD t may be zero-copy
        # (CPU backend aliases host numpy buffers), so never mutate it.
        self._t = self._t + valid
        if partials:
            self._dispatch_partials()

    def _dispatch_partials(self, skip_silence: bool = True) -> None:
        """Dispatch the any-state finalize NOW (no sync) and start the async
        readback; partial_texts() materializes it later. The snapshot records
        each slot's stream id + fill so a poll can prove per-slot freshness
        (a slot fed again, or released and reused, since the dispatch makes
        the snapshot stale for that slot only)."""
        _scores, ids, counts = self._run_finalize(True, skip_silence)
        for arr in (ids, counts):
            try:
                arr.copy_to_host_async()
            except (AttributeError, NotImplementedError):
                pass  # CPU backend: device_get is free anyway
        # Keep ONE completed generation behind: a poll issued right after
        # the dispatch would otherwise wait for the entire device queue it
        # just grew — the pipelined serving mode reads the previous round's
        # snapshot instead (its compute finished during this round's host
        # work), trading one chunk of staleness for a free poll.
        self._pending_prev = self._pending
        self._pending = {
            "ids": ids, "counts": counts, "texts": None,
            "t": self._t.copy(), "sid": self._stream_id.copy(),
            "skip_silence": skip_silence,
        }

    def _step_sparse(self, checked: Dict[int, np.ndarray]) -> None:
        """Compact+scatter step: upload ONLY the fed slots' features.

        Both compact axes bucket to powers of two (a handful of compiled
        shapes), so a 5-frame feed to 60 talking slots of a 1024-slot pool
        ships a (64, 8, D) array instead of (1024, 32, D) — the serving
        partials path's dominant host->device cost (VERDICT r3 #3). The
        device program gathers the K rows' alpha, runs the identical
        recursion, and scatters rows + ring backpointers back in place."""
        ids = sorted(checked)
        k = len(ids)
        c_max = max(f.shape[0] for f in checked.values())
        k_pad = max(8, 1 << (k - 1).bit_length())
        c_pad = min(self.chunk_size, max(4, 1 << (c_max - 1).bit_length()))
        feats = np.zeros((k_pad, c_pad, self._dim), np.float32)
        slot_ids = np.full(k_pad, self.num_slots, np.int32)  # drop sentinel
        t_rows = np.zeros(k_pad, np.int32)
        valid_rows = np.zeros(k_pad, np.int32)
        for j, slot in enumerate(ids):
            f = checked[slot]
            feats[j, : f.shape[0]] = f
            slot_ids[j] = slot
            t_rows[j] = self._t[slot]
            valid_rows[j] = f.shape[0]
        if self._gmm_params is not None:
            kind, eparams = "gmm", self._gmm_params
        elif self.emissions == "quad":
            kind, eparams = "quad", self._quad
        else:
            kind, eparams = "whiten", self._emission
        banded = self.step_impl == "banded"
        topo = self._coeffs if banded else self._trans
        self._alpha, self._ring = _step_compact(
            self._alpha, self._ring,
            jnp.asarray(slot_ids), jnp.asarray(t_rows),
            jnp.asarray(valid_rows), jnp.asarray(feats),
            topo, self._seed_bias, self._is_entry, eparams,
            kind=kind, banded=banded,
        )
        for slot in ids:
            self._t[slot] += checked[slot].shape[0]

    def _put_sharded(self, *arrays):
        """Slot-dim arrays onto the mesh (or plain device arrays without one).

        Always copies host numpy inputs: jnp.asarray/device_put can alias the
        host buffer (zero-copy on the CPU backend), and the caller's arrays
        must stay mutation-safe while the async dispatch reads them."""
        import jax as _jax

        if self._sharding is None:
            return tuple(jnp.asarray(np.array(a)) for a in arrays)
        return tuple(_jax.device_put(np.array(a), self._sharding)
                     for a in arrays)

    # -- results --------------------------------------------------------------
    def _run_finalize(self, any_state: bool, skip_silence: bool):
        c = self.composite
        sil = (
            c.labels.index("S")
            if (skip_silence and "S" in c.labels) else -1
        )
        (t_dev,) = self._put_sharded(self._t)
        # Slice the ring to a 512-frame bucket over the deepest fill: the
        # backtrace is a sequential reverse scan over the ring's time axis,
        # so scanning all max_frames rows for short fills multiplies partial
        # polling cost (one compile per bucket, then cached).
        t_bucket = min(
            self.max_frames,
            max(512, -(-int(self._t.max(initial=0)) // 512) * 512),
        )
        ring = (
            self._ring if t_bucket == self.max_frames
            else self._ring[:, :t_bucket]
        )
        return _finalize_batch(
            self._alpha, ring, t_dev, self._is_exit,
            jnp.asarray(c.word_of_state.astype(np.int32)),
            jnp.asarray(c.lowers.astype(np.int32)),
            jnp.asarray(c.uppers.astype(np.int32)),
            sil, any_state, self.max_words,
        )

    def finalize(self, slots: Sequence[int],
                 skip_silence: bool = True) -> Dict[int, tuple]:
        """slot -> (score, text) with the offline termination (best exit).

        One dispatch for all requested slots; readback is scores + word ids
        only (the paths stay on device). Does not release the slots."""
        from .words import ids_to_strings

        for slot in slots:
            self._check_slot(slot)
            if self._t[slot] == 0:
                raise ValueError(f"slot {slot} has no frames to finalize")
        scores, ids, counts = jax.device_get(
            self._run_finalize(False, skip_silence)
        )
        texts = ids_to_strings(ids, counts, self.composite.labels)
        return {
            slot: (float(scores[slot]), texts[slot]) for slot in slots
        }

    def _materialize(self, p: dict) -> List[str]:
        from .words import ids_to_strings

        if p["texts"] is None:
            p["texts"] = ids_to_strings(
                np.asarray(p["ids"]), np.asarray(p["counts"]),
                self.composite.labels,
            )
        return p["texts"]

    def partial_texts(
        self, slots: Sequence[int] | None = None, skip_silence: bool = True,
        stale_ok: bool = False,
    ) -> Dict[int, str]:
        """Best hypotheses so far for many slots — ONE finalize dispatch
        and one readback regardless of how many slots are polled (any state
        may end a partial). Slots with no frames yet map to "".

        When the last step() ran with partials=True and no requested slot
        advanced since, the answer comes from that step's own dispatch (the
        readback was already in flight). stale_ok=True additionally accepts
        the PREVIOUS fused dispatch's snapshot — at most one step stale per
        slot, never crossing a stream boundary (stream ids guard reuse) —
        so a poll issued right after a step never waits on the device queue
        it just grew. That is the pipelined serving mode; exact-now polls
        keep stale_ok=False."""
        from .words import ids_to_strings

        if slots is None:
            slots = sorted(self._active)
        for slot in slots:
            self._check_slot(slot)
        if not any(self._t[slot] > 0 for slot in slots):
            return {slot: "" for slot in slots}
        p = self._pending
        if (
            p is not None and p["skip_silence"] == skip_silence
            and all(
                self._t[s] == 0
                or (p["sid"][s] == self._stream_id[s]
                    and p["t"][s] == self._t[s])
                for s in slots
            )
        ):
            texts = self._materialize(p)
        elif stale_ok and p is not None:
            # Pipelined: prefer the generation whose compute already
            # finished (the one BEFORE the latest dispatch); rows are valid
            # for any slot still on the same stream. Slots the snapshot
            # predates (seeded after it) map to "" until the next round.
            use = self._pending_prev
            if use is None or use["skip_silence"] != skip_silence:
                use = p
            texts = self._materialize(use)
            return {
                slot: (
                    texts[slot]
                    if (self._t[slot] > 0
                        and use["sid"][slot] == self._stream_id[slot]
                        and use["t"][slot] > 0)
                    else ""
                )
                for slot in slots
            }
        else:
            _scores, ids, counts = jax.device_get(
                self._run_finalize(True, skip_silence)
            )
            texts = ids_to_strings(ids, counts, self.composite.labels)
        return {
            slot: (texts[slot] if self._t[slot] > 0 else "")
            for slot in slots
        }

    def partial_text(self, slot: int, skip_silence: bool = True) -> str:
        """Best hypothesis so far for one slot. Polling many slots? Use
        partial_texts — this costs a full-pool finalize per call."""
        return self.partial_texts([slot], skip_silence)[slot]
