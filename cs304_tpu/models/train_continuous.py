"""Embedded continuous training over digit-string transcripts (project6).

Reference algorithm (hidden_markov_model.py:667-797):
  - every transcript "4Z2Z1" becomes the silence-interleaved sentence
    "S4SZS2SZS1S" (insert_silence, :794-797)
  - a sentence HMM is concatenated from the current word models (:638-664)
  - every utterance of that transcript is Viterbi-aligned against it, the path
    is cut at word boundaries, and the per-word frame segments are pooled
    ("remuxed", :602-636)
  - each word model is re-estimated from its pooled segments with the same
    segmental k-means M-step as isolated training (:754-770)
  - training stops when every model's means are converged (allclose)

Vectorized restructuring: transcripts with equal digit count share a sentence
topology, so alignment runs as one vmapped batch per transcript; the "remux"
is not frame-list surgery but a per-frame (label, local_state) classification
of the path, turning the whole M-step into segment-sum matmuls reduced across
batches. The covariance uses a second (centered) pass per batch so the result
matches np.cov exactly instead of a one-pass moment difference.

Convergence semantics divergence (documented): the reference counts
convergence events CUMULATIVELY across iterations and stops when the running
total equals the number of models (hidden_markov_model.py:760-765) — so one
model re-converging every iteration can end training alone. We implement the
evident intent: stop when all models converge in the same iteration.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..data.batching import pad_batch
from ..ops.gaussian import gaussian_log_pdf, make_gaussian_params
from ..ops.viterbi import viterbi_banded_batch
from .hmm import WordHMM

logger = logging.getLogger(__name__)

SILENCE_LABEL = "S"


def insert_silence(labels):
    """'4Z2' -> 'S4SZS2S' (reference hidden_markov_model.py:794-797).

    Transcripts are either strings of single-char labels (the reference's
    digit strings) or sequences of multi-char word labels (100+-word
    vocabularies, data/wordvocab.py); the interleaved sentence keeps the
    input's type so topology caches key consistently.
    """
    if isinstance(labels, str):
        return "S" + "S".join(labels) + "S" if labels else "S"
    out = ["S"]
    for label in labels:
        out.append(label)
        out.append("S")
    return tuple(out)


class HMMTrainMeanFail(RuntimeError):
    """A used (label, state) slot received zero frames."""


def _pool_np(stat: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Host-side tie pooling (the legacy spine's analogue of
    train_fused._pool_slots): scatter-add a leading-axis statistic over tie
    groups and broadcast group totals back to member rows."""
    flat = stat.reshape(ids.shape[0], -1)
    pooled = np.zeros_like(flat)
    np.add.at(pooled, ids, flat)
    return pooled[ids].reshape(stat.shape)


@dataclass(frozen=True)
class ContinuousTrainConfig:
    max_iterations: int = 100
    # The reference regularizes covariances with 0.001*I
    # (hidden_markov_model.py:341-345) and that is the default here. NOTE:
    # the in-repo synthetic benchmarks/tests pass cov_reg=0.1 instead — the
    # synthetic corpus has far fewer takes per transcript than real TI-Digits,
    # so per-state covariances need heavier regularization to stay
    # well-conditioned. This is a deliberate, surfaced divergence; keep 0.001
    # for real-sized corpora.
    cov_reg: float = 0.001
    length_multiple: int = 128
    rtol: float = 1e-5
    atol: float = 1e-8
    insert_silence: bool = True
    # What to do when a (label, state) slot receives zero aligned frames.
    # "fail" replicates the reference's abort (HMMTrainMeanFail,
    # hidden_markov_model.py:214-217); "keep" freezes that slot's previous
    # parameters for the iteration — free cross-word transitions let paths
    # skip word-entry states, so sparse corpora hit this routinely.
    on_empty_state: str = "keep"
    # Re-train the silence model on long in-context silence runs before joint
    # re-estimation. The boot silence model comes from standalone noise clips
    # whose power_to_db ref=max is the NOISE's own peak (mfcc.py:35), so it is
    # systematically mismatched against in-utterance silence (~-40 dB below the
    # speech peak); aligning with it poisons the first joint iteration. The
    # bootstrap pools only S-aligned runs of >= silence_bootstrap_min_run
    # frames (long runs are true silence; 1-2 frame runs are attack/decay
    # contamination) and re-estimates S alone with digits frozen.
    silence_bootstrap: bool = True
    silence_bootstrap_min_run: int = 9
    silence_label: str = SILENCE_LABEL
    # Statistics used for re-estimation. "viterbi" (default) replicates the
    # reference's segmental update: hard path counts from the banded sentence
    # Viterbi (hidden_markov_model.py:588-600). "baum_welch" replaces the
    # one-hot path statistics with forward-backward posteriors over the same
    # banded sentence topology (soft counts: gamma-weighted moments, xi
    # transition posteriors, termination pinned to the sentence's last state)
    # — the embedded soft-EM variant the reference's deprecated tier only had
    # for isolated words (deprecated/hidden_markov_model.py:181-206). In the
    # near-deterministic limit (tight covariances) the two coincide
    # (tests/test_embedded_baum_welch.py).
    update: str = "viterbi"
    # Run each iteration as ONE jitted XLA program (models/train_fused.py):
    # alignment of every transcript, statistics, M-step, and convergence test
    # fused into a single device dispatch with one host sync — vs 2+ dispatches
    # per transcript per iteration on the legacy path. Semantics are identical
    # (parity-tested); statistics accumulate in f32 HIGHEST-precision einsums
    # on-device instead of float64 on the host. Covers update="viterbi" AND
    # "baum_welch", single-device and mesh-sharded (the statistics psum over
    # the data axis). fused=False runs the legacy per-transcript oracle — an
    # independent implementation kept for parity tests and benchmarks;
    # single-host only (mesh + fused=False is rejected at construction).
    fused: bool = True
    # Emission layout inside the fused programs. "whiten" (default):
    # HIGHEST-precision whitening matmul, f32-exact, legacy-parity. "quad":
    # the serving path's quadratic-form layout — one K=1521 matmul, no
    # (frames, slots, D) intermediate; ~1e-2 absolute emission error that
    # only perturbs exact near-ties in the alignment argmax. "whiten" stays
    # the default (exact); quad is the lever for 100+-word vocabularies.
    # Neither has been timed on the GPU yet.
    emissions: str = "whiten"
    # Cross-word transition topology of the training sentence HMM.
    # "exit_only" (default): words connect ONLY exit -> next entry, matching
    # the decoder's composite topology, so every word instance traverses its
    # entry and exit states and every state receives frames.
    # "band": the reference's accidental free skip-2 band across word
    # boundaries (its sparse matrix returns 0.0 for unstored cross-word keys,
    # transition_probability.py:17-23) — under it, entry/exit states can be
    # skipped during alignment and keep stale parameters that the decoder
    # then has to pay for (observed as word deletions).
    cross_word: str = "exit_only"


@dataclass
class _SentenceTopology:
    """Static per-transcript-shape arrays mapping sentence states to
    (global label index, local state)."""

    lab_of_state: np.ndarray  # (S_sent,) int32 into the global label list
    loc_of_state: np.ndarray  # (S_sent,) int32 local state within the word
    pos_of_state: np.ndarray  # (S_sent,) int32 word position in the sentence


def _topology(sentence: str, state_counts: Dict[str, int], label_index: Dict[str, int]):
    lab, loc, pos = [], [], []
    for p, word in enumerate(sentence):
        n = state_counts[word]
        lab.extend([label_index[word]] * n)
        loc.extend(range(n))
        pos.extend([p] * n)
    return _SentenceTopology(
        np.asarray(lab, np.int32), np.asarray(loc, np.int32), np.asarray(pos, np.int32)
    )


def _sentence_log_a(
    topo: _SentenceTopology, log_a_g: np.ndarray, cross_word: str = "exit_only"
) -> np.ndarray:
    """Gather per-word transitions onto the sentence state space.

    cross_word="band": every cross-word pair inside the Viterbi band is free
    (log 1 = 0), reproducing the reference's sparse-matrix default
    (transition_probability.py:17-23; see models.hmm.sentence_hmm).
    cross_word="exit_only": only word-exit -> next-word-entry is free, the
    decoder's actual topology (see ContinuousTrainConfig.cross_word).
    The skip-2 band itself is applied inside the banded Viterbi."""
    pos = topo.pos_of_state
    same_word = pos[:, None] == pos[None, :]
    lab = topo.lab_of_state
    loc = topo.loc_of_state
    gathered = log_a_g[lab[:, None], loc[:, None], loc[None, :]]
    if cross_word == "band":
        return np.where(same_word, gathered, 0.0).astype(np.float32)
    s = len(pos)
    is_exit = np.zeros(s, bool)
    is_entry = np.zeros(s, bool)
    for p in range(pos.max() + 1):
        idx = np.where(pos == p)[0]
        is_entry[idx[0]] = True
        is_exit[idx[-1]] = True
    next_word = pos[None, :] == pos[:, None] + 1
    allowed_cross = is_exit[:, None] & is_entry[None, :] & next_word
    out = np.where(same_word, gathered, -np.inf)
    return np.where(allowed_cross, 0.0, out).astype(np.float32)


@partial(jax.jit, static_argnames=("num_labels", "s_max"))
def _stats_pass(
    means_sent, covs_sent, log_a_sent, lab_of_state, loc_of_state, pos_of_state,
    batch, lengths, num_labels: int, s_max: int,
):
    """Alignment + zeroth/first-order stats + within-segment transition counts.

    Returns (counts (L, S), sums (L, S, D), trans (L, S, S), paths (B, T)).
    """
    params = make_gaussian_params(means_sent, covs_sent)
    log_b = jax.vmap(lambda x: gaussian_log_pdf(params, x))(batch)
    _scores, paths = viterbi_banded_batch(log_b, log_a_sent, lengths)

    b, t, _d = batch.shape
    mask = jnp.arange(t)[None, :] < lengths[:, None]
    lab = lab_of_state[paths]
    loc = loc_of_state[paths]
    pos = pos_of_state[paths]
    flat = lab * s_max + loc
    oh = jax.nn.one_hot(flat, num_labels * s_max, dtype=jnp.float32) * mask[..., None]

    counts = jnp.sum(oh, axis=(0, 1)).reshape(num_labels, s_max)
    sums = jnp.einsum(
        "btf,btd->fd", oh, batch, precision=jax.lax.Precision.HIGHEST
    ).reshape(num_labels, s_max, -1)

    # Transition counts within word instances: pair (t-1, t) counts iff both
    # frames are real and belong to the same sentence position.
    pair_live = (jnp.arange(t - 1)[None, :] < (lengths[:, None] - 1)) & (
        pos[:, :-1] == pos[:, 1:]
    )
    lab_pair = lab[:, :-1]
    from_flat = lab_pair * (s_max * s_max) + loc[:, :-1] * s_max + loc[:, 1:]
    oh_pair = jax.nn.one_hot(
        from_flat, num_labels * s_max * s_max, dtype=jnp.float32
    ) * pair_live[..., None]
    trans = jnp.sum(oh_pair, axis=(0, 1)).reshape(num_labels, s_max, s_max)
    return counts, sums, trans, paths


@partial(jax.jit, static_argnames=("num_labels", "s_max"))
def _centered_m2_pass(
    means_g, lab_of_state, loc_of_state, batch, lengths, paths,
    num_labels: int, s_max: int,
):
    """Pass B: centered second moments around the NEW means (np.cov parity)."""
    b, t, d = batch.shape
    mask = jnp.arange(t)[None, :] < lengths[:, None]
    lab = lab_of_state[paths]
    loc = loc_of_state[paths]
    flat = lab * s_max + loc
    oh = jax.nn.one_hot(flat, num_labels * s_max, dtype=jnp.float32) * mask[..., None]
    means_flat = means_g.reshape(num_labels * s_max, d)

    def m2_for_slot(slot):
        centered = batch - means_flat[slot]
        w = oh[..., slot]
        return jnp.einsum(
            "bt,btd,bte->de", w, centered, centered,
            precision=jax.lax.Precision.HIGHEST,
        )

    return jax.vmap(m2_for_slot)(jnp.arange(num_labels * s_max)).reshape(
        num_labels, s_max, d, d
    )


@partial(jax.jit, static_argnames=("num_labels", "s_max"))
def _stats_pass_bw(
    means_sent, covs_sent, log_a_sent, lab_of_state, loc_of_state, pos_of_state,
    batch, lengths, num_labels: int, s_max: int,
):
    """Baum-Welch analogue of _stats_pass: forward-backward posteriors over
    the banded sentence topology replace the hard Viterbi one-hots.

    Returns (counts (L, S), sums (L, S, D), trans (L, S, S),
    gamma_f (B, T, L*S) slot posteriors for the covariance pass, total loglik).
    """
    from ..ops.forward_backward import forward_backward
    from ..ops.viterbi import banded_transition_matrix

    s_sent = lab_of_state.shape[0]
    params = make_gaussian_params(means_sent, covs_sent)
    trans_eff = banded_transition_matrix(log_a_sent, skip=2)
    neg = -jnp.inf
    log_init = jnp.full((s_sent,), neg).at[0].set(0.0)
    log_final = jnp.full((s_sent,), neg).at[s_sent - 1].set(0.0)
    flat = lab_of_state * s_max + loc_of_state  # (S_sent,)
    slot_map = jax.nn.one_hot(flat, num_labels * s_max, dtype=jnp.float32)
    same_pos = (pos_of_state[:, None] == pos_of_state[None, :]).astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST

    def per_clip(x, length):
        log_b = gaussian_log_pdf(params, x)
        gamma, xi, ll = forward_backward(
            log_b, trans_eff, log_init, length, log_final=log_final
        )
        gamma_f = jnp.dot(gamma, slot_map, precision=hi)  # (T, L*S)
        counts = jnp.sum(gamma_f, axis=0)
        sums = jnp.einsum("tf,td->fd", gamma_f, x, precision=hi)
        xi_in_word = xi * same_pos
        trans_f = jnp.einsum(
            "uv,uf,vg->fg", xi_in_word, slot_map, slot_map, precision=hi
        )
        return counts, sums, trans_f, gamma_f, ll

    counts, sums, trans_f, gamma_f, ll = jax.vmap(per_clip)(batch, lengths)
    counts = jnp.sum(counts, 0).reshape(num_labels, s_max)
    sums = jnp.sum(sums, 0).reshape(num_labels, s_max, -1)
    trans4 = jnp.sum(trans_f, 0).reshape(num_labels, s_max, num_labels, s_max)
    lidx = jnp.arange(num_labels)
    trans = trans4[lidx, :, lidx, :]  # within-word blocks only
    return counts, sums, trans, gamma_f, jnp.sum(ll)


@partial(jax.jit, static_argnames=("num_labels", "s_max"))
def _centered_m2_pass_weighted(
    means_g, gamma_f, batch, lengths, num_labels: int, s_max: int,
):
    """Pass B for Baum-Welch: gamma-weighted centered second moments around
    the NEW means (mirrors _centered_m2_pass with soft weights)."""
    b, t, d = batch.shape
    mask = (jnp.arange(t)[None, :] < lengths[:, None]).astype(jnp.float32)
    w_all = gamma_f * mask[..., None]  # (B, T, L*S)
    means_flat = means_g.reshape(num_labels * s_max, d)

    def m2_for_slot(slot):
        centered = batch - means_flat[slot]
        w = w_all[..., slot]
        return jnp.einsum(
            "bt,btd,bte->de", w, centered, centered,
            precision=jax.lax.Precision.HIGHEST,
        )

    return jax.vmap(m2_for_slot)(jnp.arange(num_labels * s_max)).reshape(
        num_labels, s_max, d, d
    )


class ContinuousTrainer:
    """Embedded re-estimation of word (+ silence) models from transcripts."""

    def __init__(
        self,
        models: Dict[str, WordHMM],
        cfg: ContinuousTrainConfig = ContinuousTrainConfig(),
        mesh=None,
        state_ties: Dict[tuple, object] | None = None,
        transition_ties: Dict[str, object] | None = None,
    ) -> None:
        """mesh: optional jax.sharding.Mesh — when given, the fused training
        program shards each length-bucket's batch over the mesh's data axis
        and psums the sufficient statistics inside the compiled step,
        replacing the reference's per-transcript ProcessPool
        (hidden_markov_model.py:746-750). Requires cfg.fused (the default);
        the legacy fused=False oracle is single-host.

        state_ties: optional (label, state) -> group key. Slots sharing a
        group key pool their emission statistics before every M-step and so
        train as ONE shared Gaussian (senone-style state tying, models/
        senone.py builds these maps from phonetic decision trees). Slots not
        mentioned stay untied. transition_ties: optional label -> group key;
        tied labels (which must have equal state counts) pool transition
        counts and share one transition matrix. Both apply to the fused AND
        legacy spines identically; a resumed trainer must be constructed
        with the same ties. No reference equivalent (nothing below the word
        level is tied there)."""
        from .stacking import stack_models  # deferred: stacking imports us

        if cfg.update not in ("viterbi", "baum_welch"):
            raise ValueError(
                f"update={cfg.update!r} is not one of 'viterbi'/'baum_welch'"
            )
        if mesh is not None and not cfg.fused:
            raise ValueError(
                "fused=False is the single-host parity oracle (kept as an "
                "independent implementation for tests/benchmarks); mesh "
                "training requires fused=True (the default)"
            )
        self.cfg = cfg
        self.mesh = mesh
        self._iterations_done = 0
        # Final-iteration starvation report (VERDICT r4 item #4): filled by
        # the device-loop spine after train(); [] means every used slot saw
        # frames. frozen labels = labels whose EVERY state went empty (those
        # word models never left their boot init).
        self.last_empty_slots: List[list] = []
        self.last_frozen_labels: List[str] = []
        self._dev_state = None  # device-resident (means, covs, log_a) cache
        stacked = stack_models(models)
        self.labels: List[str] = stacked.labels
        self.label_index = stacked.label_index
        self.state_counts = stacked.state_counts
        self.s_max = stacked.s_max
        self.dim = stacked.dim
        # Stacked global parameters, padded to s_max states per label —
        # mutated in place across training iterations.
        self.means_g = stacked.means
        self.covs_g = stacked.covariances
        self.log_a_g = stacked.log_a
        self._tie_flat = self._build_state_ties(state_ties)
        self._trans_tie = self._build_transition_ties(transition_ties)
        self._conv_tie = self._build_convergence_groups(
            state_ties, transition_ties
        )

    def _build_state_ties(self, state_ties) -> np.ndarray | None:
        """(label, state) -> key dict into a (L*s_max,) int32 tie map whose
        group ids are each group's smallest member flat index (guaranteeing
        valid, collision-free segment ids); unmapped slots keep their own
        flat index (singleton segments = untied)."""
        if not state_ties:
            return None
        l, s = len(self.labels), self.s_max
        tie = np.arange(l * s, dtype=np.int32)
        groups: Dict[object, List[int]] = {}
        for (label, st), key in state_ties.items():
            if label not in self.label_index:
                raise ValueError(f"state_ties: unknown label {label!r}")
            if not 0 <= st < self.state_counts[label]:
                raise ValueError(
                    f"state_ties: state {st} out of range for {label!r} "
                    f"({self.state_counts[label]} states)"
                )
            groups.setdefault(key, []).append(
                self.label_index[label] * s + st
            )
        for members in groups.values():
            tie[members] = min(members)
        return tie

    def _build_convergence_groups(
        self, state_ties, transition_ties
    ) -> np.ndarray | None:
        """Labels connected through any tie group must freeze together
        (per-label convergence would un-share tied parameters mid-run);
        returns (L,) int32 connected-component ids, or None when untied."""
        if not state_ties and not transition_ties:
            return None
        l = len(self.labels)
        parent = list(range(l))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        def union(i, j):
            parent[find(i)] = find(j)

        groups: Dict[object, List[int]] = {}
        for (label, _st), key in (state_ties or {}).items():
            groups.setdefault(("s", key), []).append(self.label_index[label])
        for label, key in (transition_ties or {}).items():
            groups.setdefault(("t", key), []).append(self.label_index[label])
        for members in groups.values():
            for m in members[1:]:
                union(members[0], m)
        return np.asarray([find(i) for i in range(l)], np.int32)

    def _build_transition_ties(self, transition_ties) -> np.ndarray | None:
        if not transition_ties:
            return None
        l = len(self.labels)
        tie = np.arange(l, dtype=np.int32)
        groups: Dict[object, List[str]] = {}
        for label, key in transition_ties.items():
            if label not in self.label_index:
                raise ValueError(f"transition_ties: unknown label {label!r}")
            groups.setdefault(key, []).append(label)
        for members in groups.values():
            counts = {self.state_counts[m] for m in members}
            if len(counts) > 1:
                raise ValueError(
                    "transition_ties: tied labels must have equal state "
                    f"counts, got {sorted(counts)} for {sorted(members)}"
                )
            idx = [self.label_index[m] for m in members]
            tie[idx] = min(idx)
        return tie

    # -- public ---------------------------------------------------------
    def models(self) -> Dict[str, WordHMM]:
        self._sync_from_device()
        out = {}
        for label in self.labels:
            i = self.label_index[label]
            n = self.state_counts[label]
            out[label] = WordHMM(
                label=label,
                means=self.means_g[i, :n].copy(),
                covariances=self.covs_g[i, :n].copy(),
                log_a=self.log_a_g[i, :n, :n].copy(),
            )
        return out

    def train(
        self,
        labeled_features: Dict[str, Sequence[np.ndarray]],
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
    ) -> int:
        """labeled_features: transcript -> list of (T_i, D) feature arrays.
        Returns the number of iterations run.

        checkpoint_dir: when given, saves resumable trainer state (.npz)
        every `checkpoint_every` iterations; a later trainer can continue via
        `resume(checkpoint_dir)` — surviving interrupts mid-run instead of
        only at the reference's KeyboardInterrupt save point
        (scripts/project6_train.py:38-41 there)."""
        use_fused = self.cfg.fused
        if use_fused:
            from .train_fused import prepare_fused_corpus

            # Frame padding at 32 granularity: the fused program is topology-
            # independent (one compile per (T, chunk) shape, not per
            # transcript), so the coarse 128-multiple the legacy path uses to
            # limit recompiles would only waste trellis steps here.
            batches = prepare_fused_corpus(
                labeled_features, self.state_counts, self.label_index,
                insert_silence if self.cfg.insert_silence else (lambda s: s),
                min(self.cfg.length_multiple, 32),
                num_shards=(
                    self.mesh.devices.size if self.mesh is not None else 1
                ),
            )
        else:
            batches = self._prepare_batches(labeled_features)
        # The bootstrap applies whenever silence is IN the training topology:
        # interleaved automatically (insert_silence=True), or written
        # explicitly into the transcripts (the phone tier expands word
        # transcripts to phone sequences with "S" between words and trains
        # with insert_silence=False, models/lexicon.py — its noise-booted S
        # is exactly as mismatched as the word tier's).
        silence_in_topology = self.cfg.insert_silence or any(
            self.cfg.silence_label in tuple(tr) for tr in labeled_features
        )
        if self._iterations_done == 0 and (
            self.cfg.silence_bootstrap
            and silence_in_topology
            and self.cfg.silence_label in self.label_index
        ):
            if use_fused:
                self._bootstrap_silence_fused(batches)
            else:
                self._bootstrap_silence(batches)
        # Whole-run device loop: when no per-iteration host work is needed
        # (no checkpointing, empty-slot policy "keep"), the ENTIRE remaining
        # run executes as one dispatch (lax.while_loop with the convergence
        # test on-device) — zero host syncs between iterations.
        if use_fused and checkpoint_dir is None and (
            self.cfg.on_empty_state == "keep"
        ):
            return self._train_device_loop(batches)
        it = self._iterations_done
        for it in range(self._iterations_done + 1, self.cfg.max_iterations + 1):
            all_converged = (
                self._iteration_fused(batches) if use_fused
                else self._iteration(batches)
            )
            self._iterations_done = it
            if checkpoint_dir and (it % checkpoint_every == 0 or all_converged):
                self.save_state(checkpoint_dir)
            if all_converged:
                logger.info("continuous training converged after %d iterations", it)
                break
        self._sync_from_device()
        return it

    def _train_device_loop(self, fused) -> int:
        from .train_fused import fused_train_run, fused_train_run_sharded

        remaining = self.cfg.max_iterations - self._iterations_done
        if remaining <= 0:
            return self._iterations_done
        l, s = len(self.labels), self.s_max
        means, covs, log_a = self._device_state()
        args = (
            means, covs, log_a, jnp.asarray(self._slot_used()),
            fused.lab_tab, fused.loc_tab, fused.pos_tab,
            fused.samew_tab, fused.cross_tab, fused.n_states_t,
            fused.batch, fused.lengths, fused.topo_id,
        )
        kwargs = dict(
            cov_reg=float(self.cfg.cov_reg), rtol=float(self.cfg.rtol),
            atol=float(self.cfg.atol),
            num_labels=l, s_max=s, cross_word=self.cfg.cross_word,
            max_iterations=int(remaining), update=self.cfg.update,
            emissions=self.cfg.emissions, **self._tie_kwargs(),
        )
        if self.mesh is not None:
            out = fused_train_run_sharded(*args, self.mesh, **kwargs)
        else:
            out = fused_train_run(*args, **kwargs)
        means, covs, log_a, counts, n_it, converged = out
        self._dev_state = (means, covs, log_a)
        counts, n_it, converged = jax.device_get((counts, n_it, converged))
        floor = 1e-4 if self.cfg.update == "baum_welch" else 1.0
        empty = self._slot_used() & (counts < floor)
        # Machine-readable: which (label, state) slots never saw a frame in
        # the final iteration (kept previous params), and which whole labels
        # that freezes — gate runs assert on this instead of grepping logs.
        self.last_empty_slots = np.argwhere(empty).tolist()
        self.last_frozen_labels = [
            lab for li, lab in enumerate(self.labels)
            if empty[li, : self.state_counts[lab]].all()
        ]
        if np.any(empty):
            logger.warning(
                "final iteration left empty (label, state) slots (kept "
                "previous params): %s", self.last_empty_slots,
            )
        self._iterations_done += int(n_it)
        if converged:
            logger.info(
                "continuous training converged after %d iterations",
                self._iterations_done,
            )
        self._sync_from_device()
        return self._iterations_done

    # -- resumable state ---------------------------------------------------
    def save_state(self, folder: str) -> None:
        from ..utils.checkpoint import save_trainer_state

        self._sync_from_device()

        save_trainer_state(
            {
                "means_g": self.means_g,
                "covs_g": self.covs_g,
                "log_a_g": self.log_a_g,
                "iterations_done": np.int32(self._iterations_done),
            },
            folder,
        )

    def resume(self, folder: str) -> int:
        """Load state saved by save_state; returns the iteration to continue
        from. Label set/state counts must match the constructor's models."""
        from ..utils.checkpoint import load_trainer_state

        state = load_trainer_state(folder)
        if state["means_g"].shape != self.means_g.shape:
            raise ValueError(
                f"checkpoint shape {state['means_g'].shape} does not match "
                f"trainer {self.means_g.shape}"
            )
        self.means_g = np.asarray(state["means_g"], np.float32)
        self.covs_g = np.asarray(state["covs_g"], np.float32)
        self.log_a_g = np.asarray(state["log_a_g"], np.float32)
        self._invalidate_device_state()
        self._iterations_done = int(state["iterations_done"])
        logger.info("resumed continuous training at iteration %d",
                    self._iterations_done)
        return self._iterations_done

    def _bootstrap_silence(self, batches) -> None:
        """Re-estimate the silence model from long in-context S-aligned runs
        (digits frozen). See ContinuousTrainConfig.silence_bootstrap."""
        from .train_kmeans import SegmentalKMeansConfig, train_word_hmm

        sil = self.cfg.silence_label
        i_s = self.label_index[sil]
        n_s = self.state_counts[sil]
        min_run = self.cfg.silence_bootstrap_min_run
        runs: List[np.ndarray] = []
        for item in batches:
            topo = item["topo"]
            means_sent = self.means_g[topo.lab_of_state, topo.loc_of_state]
            covs_sent = self.covs_g[topo.lab_of_state, topo.loc_of_state]
            log_a_sent = _sentence_log_a(topo, self.log_a_g, self.cfg.cross_word)
            _c, _s, _t, paths = _stats_pass(
                jnp.asarray(means_sent), jnp.asarray(covs_sent),
                jnp.asarray(log_a_sent),
                jnp.asarray(topo.lab_of_state), jnp.asarray(topo.loc_of_state),
                jnp.asarray(topo.pos_of_state),
                item["batch"], item["lengths"],
                len(self.labels), self.s_max,
            )
            paths = np.asarray(paths)
            batch_np = np.asarray(item["batch"])
            lengths_np = np.asarray(item["lengths"])
            lab_path = topo.lab_of_state[paths]
            for b in range(paths.shape[0]):
                is_sil = lab_path[b, : lengths_np[b]] == i_s
                bounds = np.where(np.diff(is_sil.astype(int)) != 0)[0] + 1
                for seg in np.split(np.arange(lengths_np[b]), bounds):
                    if len(seg) >= min_run and is_sil[seg[0]]:
                        runs.append(batch_np[b, seg])
        if len(runs) < 3:
            logger.warning("silence bootstrap skipped: only %d runs", len(runs))
            return
        result = train_word_hmm(
            sil, runs,
            SegmentalKMeansConfig(
                num_states=n_s,
                max_iterations=min(self.cfg.max_iterations, 15),
                length_multiple=32,
            ),
        )
        self.means_g[i_s, :n_s] = result.model.means
        self.covs_g[i_s, :n_s] = result.model.covariances
        self.log_a_g[i_s, :n_s, :n_s] = result.model.log_a
        self._invalidate_device_state()
        logger.info("silence bootstrap: retrained %s on %d runs", sil, len(runs))

    # -- fused single-program path (models/train_fused.py) -----------------
    #
    # Parameters live ON DEVICE across fused iterations (self._dev_state);
    # each iteration feeds the previous iteration's device outputs straight
    # back in and the host reads only the per-slot counts and per-label
    # convergence flags (one small sync). The numpy mirrors (means_g/covs_g/
    # log_a_g) are refreshed lazily via _sync_from_device — any code that
    # writes the numpy arrays directly must call _invalidate_device_state.
    def _slot_used(self) -> np.ndarray:
        l, s = len(self.labels), self.s_max
        slot_used = np.zeros((l, s), bool)
        for label, i in self.label_index.items():
            slot_used[i, : self.state_counts[label]] = True
        return slot_used

    def _tie_kwargs(self):
        return dict(
            tie_flat=(
                jnp.asarray(self._tie_flat)
                if self._tie_flat is not None else None
            ),
            trans_tie=(
                jnp.asarray(self._trans_tie)
                if self._trans_tie is not None else None
            ),
            conv_tie=(
                jnp.asarray(self._conv_tie)
                if self._conv_tie is not None else None
            ),
        )

    def _device_state(self):
        if self._dev_state is None:
            self._dev_state = (
                jnp.asarray(self.means_g),
                jnp.asarray(self.covs_g),
                jnp.asarray(self.log_a_g),
            )
        return self._dev_state

    def _invalidate_device_state(self) -> None:
        self._dev_state = None

    def _sync_from_device(self) -> None:
        if self._dev_state is not None:
            means, covs, log_a = self._dev_state
            self.means_g = np.asarray(means, np.float32)
            self.covs_g = np.asarray(covs, np.float32)
            self.log_a_g = np.asarray(log_a, np.float32)

    def _run_fused(self, fused):
        from .train_fused import (
            fused_viterbi_iteration,
            fused_viterbi_iteration_sharded,
        )

        l, s = len(self.labels), self.s_max
        means, covs, log_a = self._device_state()
        args = (
            means, covs, log_a, jnp.asarray(self._slot_used()),
            fused.lab_tab, fused.loc_tab, fused.pos_tab,
            fused.samew_tab, fused.cross_tab, fused.n_states_t,
            fused.batch, fused.lengths, fused.topo_id,
        )
        kwargs = dict(
            cov_reg=float(self.cfg.cov_reg), rtol=float(self.cfg.rtol),
            atol=float(self.cfg.atol),
            num_labels=l, s_max=s, cross_word=self.cfg.cross_word,
            emissions=self.cfg.emissions, **self._tie_kwargs(),
        )
        if self.mesh is not None:
            return fused_viterbi_iteration_sharded(*args, self.mesh, **kwargs)
        return fused_viterbi_iteration(*args, **kwargs)

    def _run_fused_bw(self, fused):
        from .train_fused import fused_bw_iteration, fused_bw_iteration_sharded

        l, s = len(self.labels), self.s_max
        means, covs, log_a = self._device_state()
        args = (
            means, covs, log_a, jnp.asarray(self._slot_used()),
            fused.lab_tab, fused.loc_tab, fused.pos_tab,
            fused.samew_tab, fused.cross_tab, fused.n_states_t,
            fused.batch, fused.lengths, fused.topo_id,
        )
        kwargs = dict(
            cov_reg=float(self.cfg.cov_reg), rtol=float(self.cfg.rtol),
            atol=float(self.cfg.atol),
            num_labels=l, s_max=s, cross_word=self.cfg.cross_word,
            emissions=self.cfg.emissions, **self._tie_kwargs(),
        )
        if self.mesh is not None:
            return fused_bw_iteration_sharded(*args, self.mesh, **kwargs)
        return fused_bw_iteration(*args, **kwargs)

    def _iteration_fused(self, fused) -> bool:
        if self.cfg.update == "baum_welch":
            new_means, new_covs, new_log_a, counts, converged_l, ll = (
                self._run_fused_bw(fused)
            )
            count_floor = 1e-4
        else:
            new_means, new_covs, new_log_a, counts, converged_l, _paths = (
                self._run_fused(fused)
            )
            count_floor = 1.0
        counts, converged_l = jax.device_get((counts, converged_l))
        empty = self._slot_used() & (counts < count_floor)
        if np.any(empty):
            bad = np.argwhere(empty).tolist()
            if self.cfg.on_empty_state == "fail":
                raise HMMTrainMeanFail(f"(label, state) slots with no frames: {bad}")
            logger.warning("keeping previous params for empty slots: %s", bad)
        if converged_l.all():
            return True
        # Keep-old masks (empty slots, converged labels) are already applied
        # in-jit; the outputs ARE the next iteration's state.
        self._dev_state = (new_means, new_covs, new_log_a)
        return False

    def _bootstrap_silence_fused(self, fused) -> None:
        """Fused-path silence bootstrap: one alignment program, then the same
        long-run harvesting as _bootstrap_silence."""
        from .train_kmeans import SegmentalKMeansConfig, train_word_hmm

        sil = self.cfg.silence_label
        i_s = self.label_index[sil]
        n_s = self.state_counts[sil]
        min_run = self.cfg.silence_bootstrap_min_run
        *_rest, paths = self._run_fused(fused)
        paths = np.asarray(paths)
        n_chunks, c, t = paths.shape
        paths = paths.reshape(n_chunks * c, t)
        batch_np = np.asarray(fused.batch).reshape(n_chunks * c, t, -1)
        lengths_np = np.asarray(fused.lengths).reshape(-1)
        topo_id = np.asarray(fused.topo_id).reshape(-1)
        lab_tab = np.asarray(fused.lab_tab)
        runs: List[np.ndarray] = []
        for b in range(fused.num_utts):
            lab_path = lab_tab[topo_id[b]][paths[b, : lengths_np[b]]]
            is_sil = lab_path == i_s
            bounds = np.where(np.diff(is_sil.astype(int)) != 0)[0] + 1
            for seg in np.split(np.arange(lengths_np[b]), bounds):
                if len(seg) >= min_run and is_sil[seg[0]]:
                    runs.append(batch_np[b, seg])
        if len(runs) < 3:
            logger.warning("silence bootstrap skipped: only %d runs", len(runs))
            return
        result = train_word_hmm(
            sil, runs,
            SegmentalKMeansConfig(
                num_states=n_s,
                max_iterations=min(self.cfg.max_iterations, 15),
                length_multiple=32,
            ),
        )
        self.means_g[i_s, :n_s] = result.model.means
        self.covs_g[i_s, :n_s] = result.model.covariances
        self.log_a_g[i_s, :n_s, :n_s] = result.model.log_a
        self._invalidate_device_state()
        logger.info("silence bootstrap: retrained %s on %d runs", sil, len(runs))

    # -- internals --------------------------------------------------------
    def _prepare_batches(self, labeled_features):
        batches = []
        n_dev = self.mesh.devices.size if self.mesh is not None else 1
        for transcript, feats in labeled_features.items():
            sentence = (
                insert_silence(transcript) if self.cfg.insert_silence else transcript
            )
            topo = _topology(sentence, self.state_counts, self.label_index)
            padded = pad_batch(list(feats), self.cfg.length_multiple)
            data, lengths = padded.data, padded.lengths
            if n_dev > 1 and len(lengths) % n_dev:
                # Pad the utterance count to the mesh size with zero-length
                # dummies (length 0 => every stat mask excludes them).
                pad_n = n_dev - len(lengths) % n_dev
                data = np.concatenate(
                    [data, np.zeros((pad_n,) + data.shape[1:], np.float32)]
                )
                lengths = np.concatenate([lengths, np.zeros(pad_n, np.int32)])
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec
                from ..parallel.data_parallel import DATA_AXIS

                sharding = NamedSharding(self.mesh, PartitionSpec(DATA_AXIS))
                batch_j = jax.device_put(data, sharding)
                lengths_j = jax.device_put(lengths, sharding)
            else:
                batch_j = jnp.asarray(data)
                lengths_j = jnp.asarray(lengths)
            batches.append(
                {
                    "sentence": sentence,
                    "topo": topo,
                    "batch": batch_j,
                    "lengths": lengths_j,
                }
            )
        return batches

    def _iteration(self, batches) -> bool:
        """Legacy per-transcript iteration — retained ONLY as the
        independently-implemented parity oracle for the fused programs
        (float64 host-side statistics, one dispatch pair per transcript).
        Single-host by construction; __init__ rejects mesh + fused=False."""
        l, s, d = self.means_g.shape[0], self.s_max, self.dim
        baum_welch = self.cfg.update == "baum_welch"
        counts = np.zeros((l, s), np.float64)
        sums = np.zeros((l, s, d), np.float64)
        trans = np.zeros((l, s, s), np.float64)
        weights_per_batch = []  # Viterbi: paths; BW: gamma_f slot posteriors
        for item in batches:
            topo = item["topo"]
            means_sent = self.means_g[topo.lab_of_state, topo.loc_of_state]
            covs_sent = self.covs_g[topo.lab_of_state, topo.loc_of_state]
            log_a_sent = _sentence_log_a(topo, self.log_a_g, self.cfg.cross_word)
            if baum_welch:
                c, sm, tr, gamma_f, _ll = _stats_pass_bw(
                    jnp.asarray(means_sent), jnp.asarray(covs_sent),
                    jnp.asarray(log_a_sent),
                    jnp.asarray(topo.lab_of_state),
                    jnp.asarray(topo.loc_of_state),
                    jnp.asarray(topo.pos_of_state),
                    item["batch"], item["lengths"], l, s,
                )
                weights_per_batch.append(gamma_f)
            else:
                c, sm, tr, paths = _stats_pass(
                    jnp.asarray(means_sent), jnp.asarray(covs_sent),
                    jnp.asarray(log_a_sent),
                    jnp.asarray(topo.lab_of_state),
                    jnp.asarray(topo.loc_of_state),
                    jnp.asarray(topo.pos_of_state),
                    item["batch"], item["lengths"], l, s,
                )
                weights_per_batch.append(paths)
            counts += np.asarray(c, np.float64)
            sums += np.asarray(sm, np.float64)
            trans += np.asarray(tr, np.float64)

        if self._tie_flat is not None:
            counts = _pool_np(counts.reshape(l * s), self._tie_flat).reshape(l, s)
            sums = _pool_np(sums.reshape(l * s, d), self._tie_flat).reshape(l, s, d)
        if self._trans_tie is not None:
            trans = _pool_np(trans, self._trans_tie)

        # Real (label, state) slots: states < that label's state count.
        slot_used = np.zeros((l, s), bool)
        for label, i in self.label_index.items():
            slot_used[i, : self.state_counts[label]] = True
        empty = slot_used & (counts < (1e-4 if baum_welch else 1))
        if np.any(empty):
            bad = np.argwhere(empty).tolist()
            if self.cfg.on_empty_state == "fail":
                raise HMMTrainMeanFail(f"(label, state) slots with no frames: {bad}")
            logger.warning("keeping previous params for empty slots: %s", bad)

        count_floor = 1e-4 if baum_welch else 1.0
        new_means = (
            sums / np.maximum(counts, count_floor)[..., None]
        ).astype(np.float32)
        new_means = np.where(empty[..., None], self.means_g, new_means)

        # Per-label convergence on means (reference allclose, :333).
        converged = np.array(
            [
                np.allclose(
                    new_means[i][slot_used[i]],
                    self.means_g[i][slot_used[i]],
                    rtol=self.cfg.rtol,
                    atol=self.cfg.atol,
                )
                for i in range(l)
            ]
        )
        if self._conv_tie is not None:
            # Tie-connected labels freeze together: a label freezing early
            # while a tie partner keeps updating would un-share the tied
            # parameters (same rule as the fused bodies).
            bad = np.zeros(l, np.int64)
            np.add.at(bad, self._conv_tie, (~converged).astype(np.int64))
            converged = bad[self._conv_tie] == 0
        if converged.all():
            return True

        # Pass B: centered covariance around the new means.
        m2 = np.zeros((l, s, d, d), np.float64)
        for item, weights in zip(batches, weights_per_batch):
            topo = item["topo"]
            if baum_welch:
                m2 += np.asarray(
                    _centered_m2_pass_weighted(
                        jnp.asarray(new_means), weights,
                        item["batch"], item["lengths"], l, s,
                    ),
                    np.float64,
                )
            else:
                m2 += np.asarray(
                    _centered_m2_pass(
                        jnp.asarray(new_means),
                        jnp.asarray(topo.lab_of_state),
                        jnp.asarray(topo.loc_of_state),
                        item["batch"], item["lengths"], weights, l, s,
                    ),
                    np.float64,
                )
        if self._tie_flat is not None:
            # Tied slots share new_means, so pooled centered moments give the
            # exact group covariance under either denominator.
            m2 = _pool_np(
                m2.reshape(l * s, d, d), self._tie_flat
            ).reshape(l, s, d, d)
        # Viterbi keeps the reference's np.cov ddof=1 denominator; soft counts
        # use the standard ML normalization.
        denom = (np.maximum(counts, 1e-4) if baum_welch
                 else np.maximum(counts - 1.0, 1.0))[..., None, None]
        new_covs = (m2 / denom + self.cfg.cov_reg * np.eye(d)).astype(np.float32)
        new_covs = np.where(empty[..., None, None], self.covs_g, new_covs)

        row_sums = trans.sum(axis=2, keepdims=True)
        probs = trans / np.maximum(row_sums, count_floor)
        with np.errstate(divide="ignore"):
            new_log_a = np.where(probs > 0, np.log(probs), -np.inf).astype(np.float32)
        # Rows with no observed outgoing transitions keep their previous row
        # (an -inf row would make the state a trap).
        no_out = (row_sums[..., 0] < (1e-4 if baum_welch else 1)) & slot_used
        new_log_a = np.where(no_out[..., None], self.log_a_g, new_log_a)

        # Converged models keep their parameters this iteration (the reference
        # raises before assignment, hidden_markov_model.py:333-335).
        upd = ~converged
        self.means_g[upd] = new_means[upd]
        self.covs_g[upd] = new_covs[upd]
        self.log_a_g[upd] = new_log_a[upd]
        # Padded slots keep identity covariance so Cholesky stays valid.
        pad = ~slot_used
        self.covs_g[pad] = np.eye(d, dtype=np.float32)
        return False
