"""Log-domain and max-plus (tropical) primitives.

The reference does all trellis math with explicit -inf floats and Python loops
(reference: hidden_markov_model.py:160-208). Here the same semantics are expressed
as whole-vector ops that XLA fuses into a few device kernels.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# A finite stand-in for -inf where arithmetic between two masked values could
# produce NaN (e.g. -inf + -inf is fine, but -inf - -inf is not). Everywhere a
# true identity for `max` is needed we still use -inf, which JAX handles.
# (numpy scalar: module import must not touch a device backend.)
NEG_INF = np.float32(np.finfo(np.float32).min)


def max_plus_vecmat(alpha: jax.Array, log_m: jax.Array) -> tuple[jax.Array, jax.Array]:
    """One tropical (max-plus) vector-matrix product.

    new_alpha[s] = max_{s'} alpha[s'] + log_m[s', s]; also returns the argmax
    (first-max index, matching np.argmax semantics used by the reference at
    hidden_markov_model.py:186,523,547).

    alpha: (S,), log_m: (S, S) with log_m[s', s] = score of transitioning s'->s.
    Returns (new_alpha (S,), argmax (S,) int32).
    """
    scores = alpha[:, None] + log_m  # (S_from, S_to)
    return jnp.max(scores, axis=0), jnp.argmax(scores, axis=0).astype(jnp.int32)


def logsumexp(x: jax.Array, axis=None, keepdims: bool = False) -> jax.Array:
    """Numerically-stable log-sum-exp that tolerates all -inf slices."""
    m = jnp.max(x, axis=axis, keepdims=True)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    s = jnp.log(jnp.sum(jnp.exp(x - m_safe), axis=axis, keepdims=True)) + m_safe
    s = jnp.where(jnp.isfinite(m), s, m)  # all -inf in => -inf out
    return s if keepdims else jnp.squeeze(s, axis=axis) if axis is not None else s.reshape(())


def log_plus_vecmat(alpha: jax.Array, log_m: jax.Array) -> jax.Array:
    """One log-semiring vector-matrix product (forward-algorithm step)."""
    return logsumexp(alpha[:, None] + log_m, axis=0)


def safe_log(x: jax.Array) -> jax.Array:
    """log that maps 0 -> -inf without NaN from negative-zero noise."""
    return jnp.where(x > 0, jnp.log(jnp.maximum(x, jnp.finfo(x.dtype).tiny)), -jnp.inf)
