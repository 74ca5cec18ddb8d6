"""Batched full-covariance Gaussian (and K-mixture GMM) log-densities.

The reference scores one frame under one state at a time through frozen
scipy.stats.multivariate_normal objects (reference: hidden_markov_model.py:20-48,
called per (t, state) inside the trellis loops at :189 and :526). Here the whole
(T, S) emission matrix is one whitening matmul:

    y[t, s, :] = L_s^{-1} (x_t - mu_s)        (precomputed W_s = L_s^{-1})
    logpdf[t, s] = -0.5 (D log 2pi + logdet Sigma_s + ||y[t, s]||^2)

GMM emissions (K mixtures per state) reduce over the mixture axis with
logsumexp; K=1 reproduces the single-Gaussian path exactly (capability from the
reference's deprecated GMM-HMM, deprecated/gaussian_mixture_model.py:152-164).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .logmath import logsumexp

_LOG_2PI = float(np.log(2.0 * np.pi))


class GaussianParams(NamedTuple):
    """Precomputed per-state Gaussian emission parameters.

    means:       (S, D)
    whiten:      (S, D, D)  inverse Cholesky factors W_s = L_s^{-1}
    log_norm:    (S,)       -0.5 * (D log 2pi + logdet Sigma_s)
    """

    means: jax.Array
    whiten: jax.Array
    log_norm: jax.Array

    @property
    def num_states(self) -> int:
        return self.means.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]


def make_gaussian_params(means: jax.Array, covariances: jax.Array) -> GaussianParams:
    """Build emission params from (S, D) means and (S, D, D) covariances.

    Cholesky + triangular inversion happen once per M-step, not per frame.
    """
    means = jnp.asarray(means, jnp.float32)
    covariances = jnp.asarray(covariances, jnp.float32)
    chol = jnp.linalg.cholesky(covariances)  # (S, D, D)
    d = means.shape[-1]
    eye = jnp.eye(d, dtype=jnp.float32)
    whiten = jax.vmap(
        lambda l: jax.scipy.linalg.solve_triangular(l, eye, lower=True)
    )(chol)
    log_det = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    log_norm = -0.5 * (d * _LOG_2PI + log_det)
    return GaussianParams(means=means, whiten=whiten, log_norm=log_norm)


def gaussian_log_pdf(
    params: GaussianParams, frames: jax.Array, precision=None
) -> jax.Array:
    """Emission matrix for a frame sequence.

    frames: (T, D) -> returns (T, S) log-densities. The contraction is a single
    (S*D, D) x (D, T) matmul.

    precision defaults to HIGHEST: f32-exact emissions, which reference
    decode parity depends on (an f32 dot without a precision runs in TF32 on
    the GPU).
    """
    if precision is None:
        precision = jax.lax.Precision.HIGHEST
    # y[t, s, d] = sum_e whiten[s, d, e] * frames[t, e]  minus the whitened mean.
    wx = jnp.einsum(
        "sde,te->tsd", params.whiten, frames,
        preferred_element_type=jnp.float32, precision=precision,
    )
    wmu = jnp.einsum(
        "sde,se->sd", params.whiten, params.means,
        preferred_element_type=jnp.float32, precision=precision,
    )
    y = wx - wmu[None, :, :]
    quad = jnp.sum(y * y, axis=-1)  # (T, S)
    return params.log_norm[None, :] - 0.5 * quad


class GaussianQuadParams(NamedTuple):
    """Quadratic-form emission parameters (the large-S layout).

    The whitening form contracts over K=D=39 and materializes a (T, S, D)
    intermediate. Expanding the quadratic form
        logpdf[t, s] = const_s + x_t^T (-0.5 P_s) x_t + x_t . (P_s mu_s)
    turns the heavy term into ONE (T, D^2) x (D^2, S) matmul with K = 1521.
    Numerics: one-pass form, ~1e-2 absolute emission error in
    f32 vs the whitening path (fine for accuracy, not for bit-parity); use
    make_gaussian_params/gaussian_log_pdf when exact reference parity matters.

    neg_half_p: (S, D*D) flattened -0.5 * precision matrices
    lin:        (D, S)   P_s mu_s stacked as columns
    const:      (S,)     log_norm_s - 0.5 mu_s^T P_s mu_s
    """

    neg_half_p: jax.Array
    lin: jax.Array
    const: jax.Array


def make_gaussian_quad_params(means, covariances) -> GaussianQuadParams:
    means = jnp.asarray(means, jnp.float32)
    covariances = jnp.asarray(covariances, jnp.float32)
    s, d = means.shape
    chol = jnp.linalg.cholesky(covariances)
    eye = jnp.eye(d, dtype=jnp.float32)
    prec = jax.vmap(lambda l: jax.scipy.linalg.cho_solve((l, True), eye))(chol)
    log_det = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    log_norm = -0.5 * (d * _LOG_2PI + log_det)
    hi = jax.lax.Precision.HIGHEST  # an f32 dot without it is TF32 on the GPU
    p_mu = jnp.einsum("sde,se->sd", prec, means, precision=hi)
    const = log_norm - 0.5 * jnp.einsum("sd,sd->s", p_mu, means, precision=hi)
    return GaussianQuadParams(
        neg_half_p=(-0.5 * prec).reshape(s, d * d),
        lin=p_mu.T,
        const=const,
    )


def gaussian_log_pdf_quad(
    params: GaussianQuadParams, frames: jax.Array, precision=None
) -> jax.Array:
    """(T, D) -> (T, S) via the quadratic-form matmul (see GaussianQuadParams).

    precision defaults to HIGHEST (true f32). The decoder's lower tiers
    (models/decoder.EMISSION_PRECISION) pass a cheaper dot; the whitening
    layout remains the bit-parity reference either way."""
    if precision is None:
        precision = jax.lax.Precision.HIGHEST
    t, d = frames.shape
    x2 = (frames[:, :, None] * frames[:, None, :]).reshape(t, d * d)
    quad = jnp.dot(x2, params.neg_half_p.T, precision=precision)
    lin = jnp.dot(frames, params.lin, precision=precision)
    return quad + lin + params.const[None, :]


class GMMParams(NamedTuple):
    """K-mixture GMM emission parameters.

    means:       (S, K, D)
    whiten:      (S, K, D, D)
    log_norm:    (S, K)
    log_weights: (S, K)
    """

    means: jax.Array
    whiten: jax.Array
    log_norm: jax.Array
    log_weights: jax.Array

    @property
    def num_states(self) -> int:
        return self.means.shape[0]

    @property
    def num_mixtures(self) -> int:
        return self.means.shape[1]


def make_gmm_params(
    means: jax.Array, covariances: jax.Array, weights: jax.Array
) -> GMMParams:
    """means (S, K, D), covariances (S, K, D, D), weights (S, K) -> GMMParams."""
    s, k, d = means.shape
    flat = make_gaussian_params(
        means.reshape(s * k, d), covariances.reshape(s * k, d, d)
    )
    log_w = jnp.log(jnp.asarray(weights, jnp.float32))
    return GMMParams(
        means=flat.means.reshape(s, k, d),
        whiten=flat.whiten.reshape(s, k, d, d),
        log_norm=flat.log_norm.reshape(s, k),
        log_weights=log_w,
    )


class GMMQuadParams(NamedTuple):
    """K-mixture GMM emissions in the quadratic-form layout: the (S, K)
    mixture grid flattens to S*K Gaussians so the heavy term stays ONE
    (T, D^2) x (D^2, S*K) matmul (see GaussianQuadParams) —
    the same large-S lever the single-Gaussian decode path uses, extended
    to GMM checkpoints. Zero-weight padded mixtures carry log(0) = -inf
    weights and drop out of the logsumexp exactly as in the whitening
    layout."""

    quad: GaussianQuadParams  # over the flattened (S*K,) Gaussian set
    log_weights: jax.Array    # (S, K)


def make_gmm_quad_params(
    means: jax.Array, covariances: jax.Array, weights: jax.Array
) -> GMMQuadParams:
    """means (S, K, D), covariances (S, K, D, D), weights (S, K)."""
    means = jnp.asarray(means, jnp.float32)
    covariances = jnp.asarray(covariances, jnp.float32)
    s, k, d = means.shape
    return GMMQuadParams(
        quad=make_gaussian_quad_params(
            means.reshape(s * k, d), covariances.reshape(s * k, d, d)
        ),
        log_weights=jnp.log(jnp.asarray(weights, jnp.float32)),
    )


def gmm_log_pdf_quad(
    params: GMMQuadParams, frames: jax.Array, precision=None
) -> jax.Array:
    """frames (T, D) -> (T, S) GMM log-densities via the quad layout.

    Same numeric contract as gaussian_log_pdf_quad (~1e-2 absolute drift
    vs the whitening layout; use gmm_log_pdf for bit-parity posteriors).
    precision as in gaussian_log_pdf_quad."""
    s, k = params.log_weights.shape
    comp = gaussian_log_pdf_quad(
        params.quad, frames, precision=precision
    ).reshape(-1, s, k)
    return logsumexp(comp + params.log_weights[None, :, :], axis=-1)


def gmm_log_pdf(
    params: GMMParams, frames: jax.Array, return_components: bool = False
):
    """frames (T, D) -> (T, S) GMM log-densities; optionally per-mixture (T, S, K)."""
    s, k, d = params.means.shape
    flat = GaussianParams(
        means=params.means.reshape(s * k, d),
        whiten=params.whiten.reshape(s * k, d, d),
        log_norm=params.log_norm.reshape(s * k),
    )
    comp = gaussian_log_pdf(flat, frames).reshape(-1, s, k)  # (T, S, K)
    weighted = comp + params.log_weights[None, :, :]
    out = logsumexp(weighted, axis=-1)
    if return_components:
        return out, weighted
    return out
