"""K-mixture GMM-HMM word models with segmental k-means and Baum-Welch training.

Capability parity with the reference's deprecated GMM-HMM
(deprecated/gaussian_mixture_model.py:17-240): per-state mixture weights,
per-mixture full-covariance Gaussians, Viterbi training with per-frame
best-mixture assignment, and forward-likelihood scoring. K=1 reproduces the
live single-Gaussian path. Training here is batched: alignments come from the
scanned Viterbi; mixture responsibilities and all M-step statistics are one-hot
/ posterior-weighted matmuls.
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
from ..ops.forward_backward import forward_backward, forward_log_likelihood
from ..ops.gaussian import gmm_log_pdf, make_gmm_params
from ..ops.viterbi import viterbi_banded_batch
from .train_kmeans import HMMTrainMeanFail, SegmentalKMeansConfig, init_parameters

logger = logging.getLogger(__name__)


def pad_mixture_params(model, k_max: int):
    """(means (S, K_max, D), covs, weights) for a WordHMM or GMMWordHMM,
    padded to k_max mixtures — THE lifting convention shared by the
    decoder's composite stack and phone-tier composition: padding mixtures
    get zero weight (log 0 drops out of gmm_log_pdf's logsumexp) and
    identity covariances (well-conditioned, never evaluated)."""
    import numpy as np

    s_states = model.num_states
    d = int(model.means.shape[-1])
    mm = np.zeros((s_states, k_max, d), np.float32)
    cc = np.tile(np.eye(d, dtype=np.float32), (s_states, k_max, 1, 1))
    ww = np.zeros((s_states, k_max), np.float32)
    if isinstance(model, GMMWordHMM):
        k = model.num_mixtures
        mm[:, :k] = model.means
        cc[:, :k] = model.covariances
        ww[:, :k] = model.weights
    else:
        mm[:, 0] = model.means
        cc[:, 0] = model.covariances
        ww[:, 0] = 1.0
    return mm, cc, ww


@dataclass
class GMMWordHMM:
    """A left-to-right word model with K-mixture GMM emissions."""

    label: str
    means: np.ndarray  # (S, K, D)
    covariances: np.ndarray  # (S, K, D, D)
    weights: np.ndarray  # (S, K)
    log_a: np.ndarray  # (S, S)

    @property
    def num_states(self) -> int:
        return self.means.shape[0]

    @property
    def num_mixtures(self) -> int:
        return self.means.shape[1]

    def emission_params(self):
        return make_gmm_params(self.means, self.covariances, self.weights)

    def log_likelihoods(self, features) -> jnp.ndarray:
        return gmm_log_pdf(self.emission_params(), jnp.asarray(features))

    def predict(self, features, length=None):
        """Viterbi score + path (GMM analogue of HiddenMarkovModel.predict)."""
        from ..ops.viterbi import viterbi_banded

        log_b = self.log_likelihoods(features)
        return viterbi_banded(log_b, jnp.asarray(self.log_a), length)

    def forward_score(self, features, length=None) -> float:
        """Forward log-likelihood (deprecated/gaussian_mixture_model.py:223-239)."""
        log_b = self.log_likelihoods(features)
        s = self.num_states
        log_init = jnp.full((s,), -jnp.inf).at[0].set(0.0)
        return float(
            forward_log_likelihood(log_b, jnp.asarray(self.log_a), log_init, length)
        )


@partial(jax.jit, static_argnames=("num_states", "num_mixtures", "cov_reg"))
def _gmm_kmeans_step(
    means, covs, weights, log_a, batch, lengths,
    num_states: int, num_mixtures: int, cov_reg: float,
):
    """One segmental-k-means iteration with per-frame best-mixture assignment
    (deprecated/gaussian_mixture_model.py:86-150, re-expressed as matmuls)."""
    s, k = num_states, num_mixtures
    b, t, d = batch.shape
    params = make_gmm_params(means, covs, weights)

    def per_clip(x):
        return gmm_log_pdf(params, x, return_components=True)

    log_b, comp = jax.vmap(per_clip)(batch)  # (B,T,S), (B,T,S,K)
    _scores, paths = viterbi_banded_batch(log_b, log_a, lengths)

    mask = jnp.arange(t)[None, :] < lengths[:, None]
    oh_state = jax.nn.one_hot(paths, s, dtype=jnp.float32) * mask[..., None]
    # Best mixture of the *assigned* state per frame.
    comp_of_state = jnp.take_along_axis(
        comp, paths[..., None, None], axis=2
    )[:, :, 0, :]  # (B, T, K)
    best_mix = jnp.argmax(comp_of_state, axis=-1)  # (B, T)
    oh_mix = jax.nn.one_hot(best_mix, k, dtype=jnp.float32)
    w = oh_state[..., :, None] * oh_mix[..., None, :]  # (B, T, S, K)

    hi = jax.lax.Precision.HIGHEST
    counts = jnp.sum(w, axis=(0, 1))  # (S, K)
    sums = jnp.einsum("btsk,btd->skd", w, batch, precision=hi)
    safe = jnp.maximum(counts, 1.0)
    new_means = sums / safe[..., None]

    # Centered second moments, one slot per (state, mixture) pair.
    w_flat = w.reshape(b, t, s * k)
    means_flat = new_means.reshape(s * k, d)

    def m2_slot(slot):
        centered = batch - means_flat[slot]
        return jnp.einsum(
            "bt,btd,bte->de", w_flat[..., slot], centered, centered, precision=hi
        )

    m2 = jax.vmap(m2_slot)(jnp.arange(s * k)).reshape(s, k, d, d)
    denom = jnp.maximum(counts - 1.0, 1.0)
    new_covs = m2 / denom[..., None, None] + cov_reg * jnp.eye(d, dtype=jnp.float32)

    state_counts = jnp.sum(counts, axis=1, keepdims=True)
    new_weights = jnp.where(
        state_counts > 0, counts / jnp.maximum(state_counts, 1.0), weights
    )

    pair_mask = jnp.arange(t - 1)[None, :] < (lengths[:, None] - 1)
    from_oh = jax.nn.one_hot(paths[:, :-1], s, dtype=jnp.float32) * pair_mask[..., None]
    to_oh = jax.nn.one_hot(paths[:, 1:], s, dtype=jnp.float32)
    trans = jnp.einsum("bts,btu->su", from_oh, to_oh, precision=hi)
    row = jnp.sum(trans, axis=1, keepdims=True)
    probs = trans / jnp.maximum(row, 1.0)
    new_log_a = jnp.where(probs > 0, jnp.log(jnp.maximum(probs, 1e-38)), -jnp.inf)

    state_totals = jnp.sum(counts, axis=1)
    return new_means, new_covs, new_weights, new_log_a, counts, state_totals


def train_gmm_hmm(
    label: str,
    features: Sequence[np.ndarray],
    num_mixtures: int = 4,
    cfg: SegmentalKMeansConfig = SegmentalKMeansConfig(),
    seed: int = 0,
) -> GMMWordHMM:
    """Segmental k-means GMM-HMM training (deprecated GMM capability,
    K=NUM_MIXTURES=4 in the reference, deprecated/gaussian_mixture_model.py:15)."""
    s, k = cfg.num_states, num_mixtures
    base_means, base_covs, log_a = init_parameters(np.asarray(features[0]), cfg)
    d = base_means.shape[1]
    rng = np.random.default_rng(seed)
    # Jitter copies of the k-means init so mixtures can differentiate.
    means = (
        base_means[:, None, :]
        + rng.normal(0, 0.05, size=(s, k, d)).astype(np.float32)
    )
    covs = np.tile(base_covs[:, None], (1, k, 1, 1))
    weights = np.full((s, k), 1.0 / k, np.float32)

    padded = pad_batch(list(features), cfg.length_multiple)
    batch = jnp.asarray(padded.data)
    lengths = jnp.asarray(padded.lengths)

    for it in range(1, cfg.max_iterations + 1):
        new_means, new_covs, new_weights, new_log_a, counts, state_totals = (
            _gmm_kmeans_step(
                jnp.asarray(means), jnp.asarray(covs), jnp.asarray(weights),
                jnp.asarray(log_a), batch, lengths, s, k, cfg.cov_reg,
            )
        )
        if np.any(np.asarray(state_totals) == 0):
            raise HMMTrainMeanFail(f"GMM model {label!r}: empty state")
        new_means_np = np.asarray(new_means)
        # Empty mixtures keep their previous parameters.
        empty_mix = np.asarray(counts) == 0
        new_means_np = np.where(empty_mix[..., None], means, new_means_np)
        new_covs_np = np.where(
            empty_mix[..., None, None], covs, np.asarray(new_covs)
        )
        if np.allclose(new_means_np, means, rtol=cfg.rtol, atol=cfg.atol):
            logger.info("GMM model %s converged after %d iterations", label, it)
            break
        means = new_means_np
        covs = new_covs_np
        weights = np.asarray(new_weights)
        log_a = np.asarray(new_log_a)

    return GMMWordHMM(
        label=label, means=means, covariances=covs, weights=weights, log_a=log_a
    )


@partial(jax.jit, static_argnames=("cov_reg",))
def _bw_stats(means, covs, weights, log_a, batch, lengths, cov_reg: float):
    """Baum-Welch E-step statistics for a padded batch of one word's clips."""
    s, k, d = means.shape
    params = make_gmm_params(means, covs, weights)
    log_init = jnp.full((s,), -jnp.inf).at[0].set(0.0)

    hi = jax.lax.Precision.HIGHEST
    means_flat = means.reshape(s * k, d)

    def per_clip(x, length):
        log_b, comp = gmm_log_pdf(params, x, return_components=True)
        gamma, xi, loglik = forward_backward(log_b, log_a, log_init, length)
        # Mixture responsibilities within each state.
        log_resp = comp - jax.scipy.special.logsumexp(comp, axis=-1, keepdims=True)
        gamma_k = gamma[..., None] * jnp.exp(log_resp)  # (T, S, K)
        counts = jnp.sum(gamma_k, axis=0)  # (S, K)
        # Moments centered around the previous means: the raw one-pass form
        # cancels catastrophically under default-precision (TF32 on the GPU) einsums.
        g_flat = gamma_k.reshape(-1, s * k)

        def slot_stats(slot):
            centered = x - means_flat[slot]
            c_sum = jnp.einsum("t,td->d", g_flat[:, slot], centered, precision=hi)
            c_m2 = jnp.einsum(
                "t,td,te->de", g_flat[:, slot], centered, centered, precision=hi
            )
            return c_sum, c_m2

        c_sums, c_m2 = jax.vmap(slot_stats)(jnp.arange(s * k))
        return (
            counts, c_sums.reshape(s, k, d), c_m2.reshape(s, k, d, d), xi, loglik
        )

    counts, c_sums, c_m2, xi, loglik = jax.vmap(per_clip)(batch, lengths)
    counts = jnp.sum(counts, 0)
    c_sums = jnp.sum(c_sums, 0)
    c_m2 = jnp.sum(c_m2, 0)
    xi = jnp.sum(xi, 0)
    total_ll = jnp.sum(loglik)

    safe = jnp.maximum(counts, 1e-6)
    delta = c_sums / safe[..., None]  # new_mean - prev_mean
    new_means = means + delta
    # Recenter: sum g (x-mu_new)(x-mu_new)^T = c_m2 - counts * delta delta^T.
    m2_new = c_m2 - counts[..., None, None] * (
        delta[..., :, None] * delta[..., None, :]
    )
    new_covs = (
        m2_new / safe[..., None, None]
        + cov_reg * jnp.eye(d, dtype=jnp.float32)
    )
    state_tot = jnp.sum(counts, axis=1, keepdims=True)
    new_weights = counts / jnp.maximum(state_tot, 1e-6)
    row = jnp.sum(xi, axis=1, keepdims=True)
    probs = xi / jnp.maximum(row, 1e-6)
    new_log_a = jnp.where(probs > 1e-30, jnp.log(jnp.maximum(probs, 1e-38)), -jnp.inf)
    return new_means, new_covs, new_weights, new_log_a, counts, total_ll


def train_word_hmm_baum_welch(
    label: str,
    features: Sequence[np.ndarray],
    cfg: SegmentalKMeansConfig = SegmentalKMeansConfig(),
    init=None,
    tol: float = 1e-3,
):
    """Soft-EM (Baum-Welch) single-Gaussian word training: the K=1 GMM path
    collapsed back to a WordHMM. The reference only ever had the forward
    algorithm in its deprecated tier; this completes the Baum-Welch trainer
    the north star asks for alongside segmental k-means."""
    from .hmm import WordHMM

    if init is not None and not isinstance(init, GMMWordHMM):
        init = GMMWordHMM(
            label=init.label,
            means=init.means[:, None],
            covariances=init.covariances[:, None],
            weights=np.ones((init.num_states, 1), np.float32),
            log_a=init.log_a,
        )
    gmm = train_gmm_hmm_baum_welch(
        label, features, num_mixtures=1, cfg=cfg, init=init, tol=tol
    )
    return WordHMM(
        label=label,
        means=gmm.means[:, 0].copy(),
        covariances=gmm.covariances[:, 0].copy(),
        log_a=gmm.log_a.copy(),
    )


def train_gmm_hmm_baum_welch(
    label: str,
    features: Sequence[np.ndarray],
    num_mixtures: int = 1,
    cfg: SegmentalKMeansConfig = SegmentalKMeansConfig(),
    init: GMMWordHMM | None = None,
    tol: float = 1e-3,
) -> GMMWordHMM:
    """Soft-EM (Baum-Welch) refinement; stops on relative log-likelihood gain
    < tol. Usually seeded from segmental k-means (`init`)."""
    if init is None:
        init = train_gmm_hmm(label, features, num_mixtures, cfg)
    means, covs, weights, log_a = (
        init.means.copy(), init.covariances.copy(),
        init.weights.copy(), init.log_a.copy(),
    )
    padded = pad_batch(list(features), cfg.length_multiple)
    batch = jnp.asarray(padded.data)
    lengths = jnp.asarray(padded.lengths)

    last_ll = -np.inf
    for it in range(1, cfg.max_iterations + 1):
        new_means, new_covs, new_weights, new_log_a, counts, ll = _bw_stats(
            jnp.asarray(means), jnp.asarray(covs), jnp.asarray(weights),
            jnp.asarray(log_a), batch, lengths, cfg.cov_reg,
        )
        ll = float(ll)
        empty = np.asarray(counts) < 1e-3
        means = np.where(empty[..., None], means, np.asarray(new_means))
        covs = np.where(empty[..., None, None], covs, np.asarray(new_covs))
        weights = np.asarray(new_weights)
        log_a = np.asarray(new_log_a)
        if np.isfinite(last_ll) and abs(ll - last_ll) < tol * abs(last_ll):
            logger.info("BW %s converged after %d iterations (ll=%.2f)", label, it, ll)
            break
        if np.isfinite(last_ll) and ll < last_ll - 1e-3 * abs(last_ll):
            logger.warning("BW %s log-likelihood decreased: %.3f -> %.3f", label, last_ll, ll)
        last_ll = ll

    return GMMWordHMM(
        label=label, means=means, covariances=covs, weights=weights, log_a=log_a
    )
