"""Segmental k-means (Viterbi) training of word HMMs, batched on the device.

Reference algorithm (hidden_markov_model.py:211-410):
  init:   means = uniform time-split of the FIRST utterance (:359-385),
          covariances = 0.01 * I (:387-389),
          transitions = row-uniform forward (transition_probability.py:42-52)
  iterate (<=100):
          Viterbi-align every utterance  -> pool frames by state
          means  = per-state frame averages
          covs   = np.cov(state frames, ddof=1) + 0.001 * I  (:341-345)
          trans  = row-normalized transition counts (signal.py:81-91)
          stop when np.allclose(new_means, old_means)  (:333-335)
          a state with zero frames aborts training (HMMTrainMeanFail, :327-329)

The reference ships each utterance to a worker process per iteration
(hidden_markov_model.py:300-305). Here the E-step is one vmapped scan over a
padded (B, T, S) batch and the M-step is one-hot matmuls (segment sums) — no
frame lists, no process pool. Convergence/failure are host-side checks on tiny
arrays, preserving the reference's exception-driven control flow without
exceptions inside jit.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..data.batching import pad_batch
from ..ops.gaussian import gaussian_log_pdf, make_gaussian_params
from ..ops.viterbi import viterbi_banded_batch
from .hmm import WordHMM, uniform_forward_log_a

logger = logging.getLogger(__name__)


class HMMTrainMeanFail(RuntimeError):
    """A state received zero frames during alignment (reference
    hidden_markov_model.py:214-217)."""


@dataclass(frozen=True)
class SegmentalKMeansConfig:
    num_states: int = 5
    max_iterations: int = 100
    init_cov: float = 0.01
    cov_reg: float = 0.001
    length_multiple: int = 128
    # np.allclose defaults, used for the means convergence test (:333).
    rtol: float = 1e-5
    atol: float = 1e-8


def init_parameters(first_utterance: np.ndarray, cfg: SegmentalKMeansConfig):
    """Uniform time-split init (reference hidden_markov_model.py:359-389)."""
    s = cfg.num_states
    t0, d = first_utterance.shape
    if t0 < s:
        raise ValueError(f"First utterance has {t0} frames < {s} states")
    state_len = t0 // s
    means = np.stack(
        [
            first_utterance[i * state_len : (i + 1) * state_len].mean(axis=0)
            for i in range(s)
        ]
    ).astype(np.float32)
    covs = np.tile(np.eye(d, dtype=np.float32) * cfg.init_cov, (s, 1, 1))
    log_a = uniform_forward_log_a(s)
    return means, covs, log_a


@partial(jax.jit, static_argnames=("num_states", "cov_reg"))
def kmeans_step(means, covs, log_a, batch, lengths, num_states: int, cov_reg: float):
    """One E+M iteration on a padded (B, T, D) batch.

    Returns (new_means, new_covs, new_trans_log, counts, total_score). The
    caller decides convergence/failure from `counts` and the means delta.
    """
    s = num_states
    b, t, d = batch.shape
    params = make_gaussian_params(means, covs)
    log_b = jax.vmap(lambda x: gaussian_log_pdf(params, x))(batch)  # (B, T, S)
    scores, paths = viterbi_banded_batch(log_b, log_a, lengths)

    mask = jnp.arange(t)[None, :] < lengths[:, None]  # (B, T)
    oh = jax.nn.one_hot(paths, s, dtype=jnp.float32) * mask[..., None]  # (B, T, S)

    counts = jnp.sum(oh, axis=(0, 1))  # (S,)
    sums = jnp.einsum(
        "bts,btd->sd", oh, batch, precision=jax.lax.Precision.HIGHEST
    )
    safe_counts = jnp.maximum(counts, 1.0)
    new_means = sums / safe_counts[:, None]

    # Two-pass covariance (centered like np.cov), ddof=1 (:343).
    def cov_for_state(mean_s, w_s):
        centered = batch - mean_s  # (B, T, D)
        m2 = jnp.einsum(
            "bt,btd,bte->de", w_s, centered, centered,
            precision=jax.lax.Precision.HIGHEST,
        )
        return m2

    m2 = jax.vmap(cov_for_state, in_axes=(0, 2))(new_means, oh)  # (S, D, D)
    denom = jnp.maximum(counts - 1.0, 1.0)
    new_covs = m2 / denom[:, None, None] + cov_reg * jnp.eye(d, dtype=jnp.float32)

    # Transition counts over consecutive path pairs, t in [1, len)
    # (reference signal.py:81-91 iterates the full Viterbi path).
    pair_mask = jnp.arange(t - 1)[None, :] < (lengths[:, None] - 1)
    from_oh = jax.nn.one_hot(paths[:, :-1], s, dtype=jnp.float32) * pair_mask[..., None]
    to_oh = jax.nn.one_hot(paths[:, 1:], s, dtype=jnp.float32)
    trans_counts = jnp.einsum(
        "bts,btu->su", from_oh, to_oh, precision=jax.lax.Precision.HIGHEST
    )
    row_sums = jnp.sum(trans_counts, axis=1, keepdims=True)
    probs = trans_counts / jnp.maximum(row_sums, 1.0)
    # log(0) -> -inf without NaN; rows with no observed transitions stay -inf
    # (the reference would emit NaN there, signal.py:90 — divergence documented).
    new_log_a = jnp.where(probs > 0, jnp.log(jnp.maximum(probs, 1e-38)), -jnp.inf)

    total_score = jnp.sum(jnp.where(lengths > 0, scores, 0.0))
    return new_means, new_covs, new_log_a, counts, total_score


@dataclass
class TrainResult:
    model: WordHMM
    iterations: int
    converged: bool
    final_score: float


def train_word_hmm(
    label: str,
    features: Sequence[np.ndarray],
    cfg: SegmentalKMeansConfig = SegmentalKMeansConfig(),
    mesh=None,
) -> TrainResult:
    """Train one word model from its utterances' (T_i, D) features.

    Equivalent to HiddenMarkovModelTrainable.from_data (reference
    hidden_markov_model.py:233-281). With `mesh`, the utterance batch shards
    over the mesh's data axis and the E-step statistics cross the interconnect once
    per iteration (parallel.data_parallel.dp_kmeans_step; note its one-pass
    covariance moment form vs np.cov bit-parity here).
    """
    means, covs, log_a = init_parameters(np.asarray(features[0]), cfg)
    padded = pad_batch(features, cfg.length_multiple)
    data, lens = padded.data, padded.lengths
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from ..parallel.data_parallel import DATA_AXIS, dp_kmeans_step

        n_dev = mesh.devices.size
        if len(lens) % n_dev:
            pad_n = n_dev - len(lens) % n_dev
            data = np.concatenate(
                [data, np.zeros((pad_n,) + data.shape[1:], np.float32)]
            )
            lens = np.concatenate([lens, np.zeros(pad_n, np.int32)])
        sharding = NamedSharding(mesh, PartitionSpec(DATA_AXIS))
        batch = jax.device_put(data, sharding)
        lengths = jax.device_put(lens, sharding)
    else:
        batch = jnp.asarray(data)
        lengths = jnp.asarray(lens)

    converged = False
    it = 0
    score = float("-inf")
    for it in range(1, cfg.max_iterations + 1):
        if mesh is not None:
            new_means, new_covs, new_log_a, counts = dp_kmeans_step(
                jnp.asarray(means), jnp.asarray(covs), jnp.asarray(log_a),
                batch, lengths, mesh, cfg.num_states, cfg.cov_reg,
            )
            score = float("nan")
        else:
            new_means, new_covs, new_log_a, counts, score = kmeans_step(
                jnp.asarray(means), jnp.asarray(covs), jnp.asarray(log_a),
                batch, lengths, cfg.num_states, cfg.cov_reg,
            )
        counts_np = np.asarray(counts)
        if np.any(counts_np == 0):
            raise HMMTrainMeanFail(
                f"model {label!r}: states {np.where(counts_np == 0)[0].tolist()} "
                "received no frames"
            )
        new_means_np = np.asarray(new_means)
        if np.allclose(new_means_np, means, rtol=cfg.rtol, atol=cfg.atol):
            converged = True
            logger.info("model %s converged after %d iterations", label, it)
            break
        means, covs, log_a = new_means_np, np.asarray(new_covs), np.asarray(new_log_a)

    model = WordHMM(label=label, means=means, covariances=covs, log_a=log_a)
    return TrainResult(model=model, iterations=it, converged=converged,
                       final_score=float(score))


def train_digit_models(
    features_by_label: dict,
    cfg: SegmentalKMeansConfig = SegmentalKMeansConfig(),
    batched: bool = True,
) -> dict:
    """Train one model per label (reference scripts/project3_train.py:24-30).

    batched=True stacks every label into one (M, B, T, D) tensor and runs a
    single vmapped E+M step per iteration — the whole 11-model corpus trains
    as one device program per iteration instead of 11 sequential loops (the
    reference forks a process pool per model per iteration,
    hidden_markov_model.py:300-305). Falls back to the per-label loop when
    label batch sizes are wildly uneven.
    """
    if batched and len(features_by_label) > 1:
        return train_digit_models_batched(features_by_label, cfg)
    models = {}
    for label, feats in features_by_label.items():
        result = train_word_hmm(label, feats, cfg)
        models[label] = result.model
        logger.info(
            "trained %s: %d iters, converged=%s", label, result.iterations,
            result.converged,
        )
    return models


@partial(jax.jit, static_argnames=("num_states", "cov_reg"))
def _batched_kmeans_step(means, covs, log_a, batch, lengths, num_states, cov_reg):
    return jax.vmap(
        lambda m_, c_, a_, b_, l_: kmeans_step(m_, c_, a_, b_, l_, num_states, cov_reg)
    )(means, covs, log_a, batch, lengths)


def train_digit_models_batched(
    features_by_label: dict,
    cfg: SegmentalKMeansConfig = SegmentalKMeansConfig(),
) -> dict:
    """All labels trained simultaneously via a model axis on kmeans_step.

    Per-label utterance counts are padded with zero-length dummies (length 0
    => every step is a no-op and the statistics masks exclude them).
    Per-model convergence freezes that model's parameters (matching the
    reference's per-model convergence exception) while the rest continue.
    """
    labels = list(features_by_label)
    m = len(labels)
    feats = {l: [np.asarray(f) for f in features_by_label[l]] for l in labels}
    d = feats[labels[0]][0].shape[1]
    s = cfg.num_states

    b_max = max(len(v) for v in feats.values())
    t_max = max(f.shape[0] for v in feats.values() for f in v)
    from ..data.batching import round_up

    t_pad = round_up(t_max, cfg.length_multiple)
    batch = np.zeros((m, b_max, t_pad, d), np.float32)
    lengths = np.zeros((m, b_max), np.int32)
    means = np.zeros((m, s, d), np.float32)
    covs = np.zeros((m, s, d, d), np.float32)
    log_a = np.zeros((m, s, s), np.float32)
    for i, label in enumerate(labels):
        for j, f in enumerate(feats[label]):
            batch[i, j, : f.shape[0]] = f
            lengths[i, j] = f.shape[0]
        means[i], covs[i], log_a[i] = init_parameters(feats[label][0], cfg)

    batch_j = jnp.asarray(batch)
    lengths_j = jnp.asarray(lengths)
    converged = np.zeros(m, bool)
    iterations = np.zeros(m, np.int32)
    for it in range(1, cfg.max_iterations + 1):
        new_means, new_covs, new_log_a, counts, _scores = _batched_kmeans_step(
            jnp.asarray(means), jnp.asarray(covs), jnp.asarray(log_a),
            batch_j, lengths_j, cfg.num_states, cfg.cov_reg,
        )
        counts_np = np.asarray(counts)
        empty = (counts_np == 0) & ~converged[:, None]
        if np.any(empty):
            bad = [labels[i] for i in np.unique(np.argwhere(empty)[:, 0])]
            raise HMMTrainMeanFail(f"models with empty states: {bad}")
        new_means_np = np.asarray(new_means)
        for i in range(m):
            if converged[i]:
                continue
            if np.allclose(new_means_np[i], means[i], rtol=cfg.rtol, atol=cfg.atol):
                converged[i] = True
                iterations[i] = it
                continue
            means[i] = new_means_np[i]
            covs[i] = np.asarray(new_covs[i])
            log_a[i] = np.asarray(new_log_a[i])
        if converged.all():
            break

    models = {}
    for i, label in enumerate(labels):
        models[label] = WordHMM(
            label=label, means=means[i].copy(), covariances=covs[i].copy(),
            log_a=log_a[i].copy(),
        )
        logger.info(
            "trained %s (batched): converged=%s after %s iters",
            label, bool(converged[i]), int(iterations[i]) or "max",
        )
    return models
