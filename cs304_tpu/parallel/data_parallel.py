"""Data-parallel training and decoding over a device mesh.

The reference's only parallelism is ProcessPoolExecutor fan-out of per-utterance
Viterbi alignments, with parameters shipped by fork/pickle and results gathered
in the parent (hidden_markov_model.py:300-305, 746-750; SURVEY.md §2.4). The
device-mesh equivalent: utterance batches sharded over the mesh's data axis via
shard_map, parameters replicated (they are tiny — 58 states of 39-dim
Gaussians), and the E-step sufficient statistics reduced with psum.
That one collective replaces the whole pickle-over-fork machinery.

Model parallelism is deliberately absent: the flagship model is ~58 states x
(39 + 39^2) floats (~350 KB) — replicating it is the correct sharding. Scaling
lives in the batch (corpus) dimension, exactly where the reference's process
pool put it.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.gaussian import gaussian_log_pdf, make_gaussian_params
from ..ops.viterbi import viterbi_banded_batch, viterbi_composite_batch

DATA_AXIS = "data"


def make_mesh(devices: Sequence[jax.Device] | None = None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def _local_kmeans_stats(means, covs, log_a, batch, lengths, num_states: int):
    """Per-shard E-step statistics (counts, centered frame sums, centered
    second moments, transition counts). Mirrors models.train_kmeans.kmeans_step's
    E-step.

    Moments are centered around the *previous* means (gathered per frame via
    the Viterbi path) and accumulated at Precision.HIGHEST: the naive one-pass
    form (raw second moment minus counts x mean-outer) cancels two large terms,
    and with default-precision einsums (TF32 on the GPU) the rounding can
    exceed the covariance regularizer and yield non-PSD covariances. Centering
    first keeps every accumulated term small, so a single psum still suffices.
    """
    s = num_states
    b, t, d = batch.shape
    hi = jax.lax.Precision.HIGHEST
    params = make_gaussian_params(means, covs)
    log_b = jax.vmap(lambda x: gaussian_log_pdf(params, x))(batch)
    _scores, paths = viterbi_banded_batch(log_b, log_a, lengths)

    mask = jnp.arange(t)[None, :] < lengths[:, None]
    oh = jax.nn.one_hot(paths, s, dtype=jnp.float32) * mask[..., None]
    counts = jnp.sum(oh, axis=(0, 1))
    centered = batch - means[paths]  # (B, T, D), small residuals
    c_sums = jnp.einsum("bts,btd->sd", oh, centered, precision=hi)
    c_m2 = jnp.einsum("bts,btd,bte->sde", oh, centered, centered, precision=hi)

    pair_mask = jnp.arange(t - 1)[None, :] < (lengths[:, None] - 1)
    from_oh = jax.nn.one_hot(paths[:, :-1], s, dtype=jnp.float32) * pair_mask[..., None]
    to_oh = jax.nn.one_hot(paths[:, 1:], s, dtype=jnp.float32)
    trans = jnp.einsum("bts,btu->su", from_oh, to_oh, precision=hi)
    return counts, c_sums, c_m2, trans


@partial(jax.jit, static_argnames=("mesh", "num_states", "cov_reg"))
def dp_kmeans_step(
    means, covs, log_a, batch, lengths, mesh: Mesh, num_states: int,
    cov_reg: float = 0.001,
):
    """One data-parallel segmental k-means iteration.

    batch (B, T, D) and lengths (B,) are sharded over the data axis; the
    sufficient statistics cross the interconnect once via psum; the (tiny) M-step
    runs replicated. B must be divisible by the mesh size.

    The covariance uses moments centered around the previous means (see
    _local_kmeans_stats) so a single collective suffices without the
    catastrophic cancellation of the raw one-pass form; the single-host
    trainer (models.train_kmeans) keeps the two-pass np.cov-parity form.
    """

    def step(means, covs, log_a, batch, lengths):
        counts, c_sums, c_m2, trans = _local_kmeans_stats(
            means, covs, log_a, batch, lengths, num_states
        )
        counts = jax.lax.psum(counts, DATA_AXIS)
        c_sums = jax.lax.psum(c_sums, DATA_AXIS)
        c_m2 = jax.lax.psum(c_m2, DATA_AXIS)
        trans = jax.lax.psum(trans, DATA_AXIS)

        safe = jnp.maximum(counts, 1.0)
        delta = c_sums / safe[:, None]  # new_mean - prev_mean
        new_means = means + delta
        d = batch.shape[-1]
        # Recenter second moments from prev means to new means:
        # sum (x-mu_new)(x-mu_new)^T = c_m2 - counts * delta delta^T.
        m2_new = c_m2 - counts[:, None, None] * (
            delta[:, :, None] * delta[:, None, :]
        )
        denom = jnp.maximum(counts - 1.0, 1.0)
        new_covs = (
            m2_new / denom[:, None, None]
            + cov_reg * jnp.eye(d, dtype=jnp.float32)
        )
        row = jnp.sum(trans, axis=1, keepdims=True)
        probs = trans / jnp.maximum(row, 1.0)
        new_log_a = jnp.where(probs > 0, jnp.log(jnp.maximum(probs, 1e-38)), -jnp.inf)
        return new_means, new_covs, new_log_a, counts

    rep = P()
    sharded = P(DATA_AXIS)
    return shard_map(
        step,
        mesh=mesh,
        in_specs=(rep, rep, rep, sharded, sharded),
        out_specs=(rep, rep, rep, rep),
        check_vma=False,
    )(means, covs, log_a, batch, lengths)


@partial(jax.jit, static_argnames=("mesh", "num_labels", "s_max"))
def dp_embedded_stats(
    means_sent, covs_sent, log_a_sent, lab_of_state, loc_of_state, pos_of_state,
    batch, lengths, mesh: Mesh, num_labels: int, s_max: int,
):
    """Data-parallel embedded-training statistics for one transcript batch.

    The sentence alignment (models.train_continuous._stats_pass) runs on each
    device's shard of utterances; the (L, S) / (L, S, D) / (L, S, S)
    sufficient statistics cross the interconnect once via psum. This shards the
    reference's per-transcript ProcessPool (hidden_markov_model.py:746-750).
    Returns (counts, sums, trans) replicated; per-utterance paths stay sharded.
    """
    from ..models.train_continuous import _stats_pass

    def step(means_sent, covs_sent, log_a_sent, lab, loc, pos, batch, lengths):
        counts, sums, trans, paths = _stats_pass(
            means_sent, covs_sent, log_a_sent, lab, loc, pos,
            batch, lengths, num_labels, s_max,
        )
        return (
            jax.lax.psum(counts, DATA_AXIS),
            jax.lax.psum(sums, DATA_AXIS),
            jax.lax.psum(trans, DATA_AXIS),
            paths,
        )

    rep = P()
    sharded = P(DATA_AXIS)
    return shard_map(
        step,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep, rep, rep, sharded, sharded),
        out_specs=(rep, rep, rep, sharded),
        check_vma=False,
    )(means_sent, covs_sent, log_a_sent, lab_of_state, loc_of_state,
      pos_of_state, batch, lengths)


@partial(jax.jit, static_argnames=("mesh",))
def dp_composite_decode(
    means, covs, log_a, lower_of_state, is_entry, is_exit, penalty,
    batch, lengths, mesh: Mesh,
):
    """Sharded continuous decoding: each device decodes its batch shard; no
    collectives needed (embarrassingly parallel, like the reference's eval
    pools at scripts/project5_test_ndigits_no_sil.py:33-41)."""

    def decode(means, covs, log_a, lower_of_state, is_entry, is_exit, penalty,
               batch, lengths):
        params = make_gaussian_params(means, covs)
        log_b = jax.vmap(lambda x: gaussian_log_pdf(params, x))(batch)
        return viterbi_composite_batch(
            log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths
        )

    rep = P()
    return shard_map(
        decode,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep, rep, rep, rep, P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )(means, covs, log_a, lower_of_state, is_entry, is_exit, penalty,
      batch, lengths)
