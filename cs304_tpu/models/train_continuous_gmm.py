"""Embedded continuous training with K-mixture GMM emissions.

Beyond-reference capability: the reference's GMM tier
(deprecated/gaussian_mixture_model.py:17-240) trains isolated words only and
was never wired into continuous decoding; here GMM emissions drop into the
SAME fused embedded-training design as the single-Gaussian trainer
(models/train_fused.py) — one XLA program per iteration, mesh-shardable —
and the trained models decode through the existing GMM continuous decoder
(models/decoder.py lifts mixed model dicts automatically).

Training semantics follow the reference's GMM pattern lifted to sentence
level: sentence-HMM Viterbi alignment under the GMM emission densities
(hard state assignment, as in gmm_hmm._gmm_kmeans_step), then SOFT mixture
responsibilities within the assigned state (the EM-correct split, matching
gmm_hmm._bw_stats's per-state responsibilities rather than the deprecated
tier's winner-take-all argmax — K=1 reduces exactly to the single-Gaussian
fused trainer either way).

The usual flow: train K=1 models with ContinuousTrainer, `promote_to_gmm`
them (mean splitting with jitter), then refine here.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.gaussian import make_gaussian_params, gaussian_log_pdf
from .gmm_hmm import GMMWordHMM
from .hmm import WordHMM
from .train_continuous import HMMTrainMeanFail, insert_silence
from .train_fused import (
    NEG,
    _banded_trellis_batch,
    _identity,
    _sentence_trans_diagonals,
    prepare_fused_corpus,
)

logger = logging.getLogger(__name__)


def promote_to_gmm(
    models: Dict[str, WordHMM | GMMWordHMM],
    num_mixtures: int,
    jitter: float = 1.0,
    seed: int = 0,
) -> Dict[str, GMMWordHMM]:
    """Split trained single-Gaussian models into K mixtures (VQ-style mixup).

    The first two mixtures start at mean ± jitter·std (per-dimension std from
    the state's own covariance diagonal — when promoting from an embedded-
    trained K=1 model those covariances reflect the data, so multimodal
    states begin with the split straddling their modes instead of both
    mixtures inside one). Further mixtures (K>2) get independent
    N(0, (jitter·std)²) offsets. Covariances are shared copies; weights start
    uniform. Models already GMMWordHMM pass through unchanged (K must match).
    """
    rng = np.random.default_rng(seed)
    out: Dict[str, GMMWordHMM] = {}
    for label, m in models.items():
        if isinstance(m, GMMWordHMM):
            if m.num_mixtures != num_mixtures:
                raise ValueError(
                    f"model {label!r} has K={m.num_mixtures}, expected "
                    f"{num_mixtures}"
                )
            out[label] = m
            continue
        s, d = m.means.shape
        std = np.sqrt(np.maximum(
            np.diagonal(m.covariances, axis1=-2, axis2=-1), 1e-8
        ))  # (S, D)
        offsets = np.zeros((s, num_mixtures, d), np.float32)
        if num_mixtures >= 2:
            offsets[:, 0] = jitter * std
            offsets[:, 1] = -jitter * std
        for k_i in range(2, num_mixtures):
            offsets[:, k_i] = rng.normal(0, jitter, size=(s, d)) * std
        means = (m.means[:, None, :] + offsets).astype(np.float32)
        out[label] = GMMWordHMM(
            label=label,
            means=means,
            covariances=np.tile(
                m.covariances[:, None], (1, num_mixtures, 1, 1)
            ).astype(np.float32),
            weights=np.full((s, num_mixtures), 1.0 / num_mixtures, np.float32),
            log_a=m.log_a.copy(),
        )
    return out


def _gmm_body(
    means_g, covs_g, weights_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    *, cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, num_mix: int, cross_word: str,
    reduce_fn=_identity,
):
    """One embedded GMM iteration as one XLA program.

    Shapes: means_g (L, S, K, D), covs_g (L, S, K, D, D), weights_g (L, S, K).
    Returns (new_means, new_covs, new_weights, new_log_a, counts (L, S, K),
    converged_l (L,), paths). Same M-step conventions as the fused
    single-Gaussian trainer (np.cov ddof=1 denominator, empty-slot and
    converged-label keep-old applied in-jit); empty MIXTURES additionally
    keep their previous parameters (reference gmm pattern,
    deprecated/gaussian_mixture_model.py empty-mixture handling mirrored in
    gmm_hmm.train_gmm_hmm).
    """
    l, s, k, d = means_g.shape
    f = num_labels * s_max
    fk = f * k
    n_chunks, c, t, _ = batch.shape
    b = n_chunks * c
    hi = jax.lax.Precision.HIGHEST

    params = make_gaussian_params(
        means_g.reshape(fk, d), covs_g.reshape(fk, d, d)
    )
    log_w = jnp.where(
        weights_g > 0, jnp.log(jnp.maximum(weights_g, 1e-38)), NEG
    ).reshape(f, k)

    # ---- pass 1: GMM emissions per sentence state (chunked) ----
    def emit_chunk(_, inp):
        bc, tidc = inp
        comp = gaussian_log_pdf(params, bc.reshape(c * t, d)).reshape(
            c, t, f, k
        )
        lb_slots = jax.scipy.special.logsumexp(
            comp + log_w[None, None], axis=-1
        )  # (C, T, F)
        flat_slot = lab_tab[tidc] * s_max + loc_tab[tidc]
        return None, jax.vmap(lambda lb, fs: lb[:, fs])(lb_slots, flat_slot)

    _, lb_sent = jax.lax.scan(emit_chunk, None, (batch, topo_id))
    s_sent = lb_sent.shape[-1]

    # ---- trellis: whole-batch banded sentence Viterbi ----
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

    # ---- pass A: responsibilities + zeroth/first-order stats + transitions
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
        flat = lab_p * s_max + loc_p  # (C, T) assigned slot

        comp = gaussian_log_pdf(params, bc.reshape(c * t, d)).reshape(
            c, t, f, k
        ) + log_w[None, None]
        comp_p = jnp.take_along_axis(
            comp, flat[..., None, None], axis=2
        )[:, :, 0, :]  # (C, T, K) assigned slot's weighted components
        r = jax.nn.softmax(comp_p, axis=-1)  # responsibilities within slot
        r = r * mask[..., None]

        oh = jax.nn.one_hot(flat, f, dtype=jnp.float32) * mask[..., None]
        counts = counts + jnp.einsum("ctf,ctk->fk", oh, r, precision=hi)
        rx = r[..., :, None] * bc[..., None, :]  # (C, T, K, D)
        sums = sums + jnp.einsum("ctf,ctkd->fkd", oh, rx, precision=hi)

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
        return (counts, sums, trans), r

    init = (
        jnp.zeros((f, k), jnp.float32),
        jnp.zeros((f, k, d), jnp.float32),
        jnp.zeros((f * s_max,), jnp.float32),
    )
    (counts_fk, sums, trans_f), r_all = jax.lax.scan(
        pass_a, init, (batch, lengths, topo_id, paths)
    )
    counts_fk = reduce_fn(counts_fk)
    sums = reduce_fn(sums)
    trans_f = reduce_fn(trans_f)
    trans = trans_f.reshape(l, s, s)

    # ---- M-step: means / weights + convergence ----
    counts = counts_fk.reshape(l, s, k)
    slot_used_k = slot_used[..., None]
    empty_mix = slot_used_k & (counts < 1.0)
    new_means = (
        sums / jnp.maximum(counts_fk, 1.0)[..., None]
    ).reshape(l, s, k, d)
    new_means = jnp.where(empty_mix[..., None], means_g, new_means)
    state_tot = jnp.sum(counts, axis=-1, keepdims=True)  # (L, S, 1)
    new_weights = jnp.where(
        state_tot > 0, counts / jnp.maximum(state_tot, 1.0), weights_g
    )
    close = jnp.abs(new_means - means_g) <= atol + rtol * jnp.abs(means_g)
    converged_l = jnp.all(
        close.all(-1).all(-1) | ~slot_used, axis=-1
    )  # (L,)

    # ---- pass B: covariance (König around the global weighted mean) ----
    new_means_flat = new_means.reshape(fk, d)
    total = jnp.maximum(jnp.sum(counts_fk), 1.0)
    c_glob = jnp.sum(sums.reshape(fk, d), axis=0) / total
    d_fk = new_means_flat - c_glob

    def pass_b(sxx, inp):
        bc, lc, tidc, path, r = inp
        lab_u = lab_tab[tidc]
        loc_u = loc_tab[tidc]
        lab_p = jnp.take_along_axis(lab_u, path, axis=1)
        loc_p = jnp.take_along_axis(loc_u, path, axis=1)
        flat = lab_p * s_max + loc_p
        mask = jnp.arange(t)[None, :] < lc[:, None]
        oh = jax.nn.one_hot(flat, f, dtype=jnp.float32) * mask[..., None]
        # (C, T, F, K) soft slot-mixture weights, flattened for one matmul.
        w = (oh[..., :, None] * r[..., None, :]).reshape(c * t, fk)
        xc = (bc - c_glob).reshape(c * t, d)
        x2 = (xc[:, :, None] * xc[:, None, :]).reshape(c * t, d * d)
        sxx = sxx + jax.lax.dot_general(
            w, x2, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=hi,
        )
        return sxx, None

    sxx_flat, _ = jax.lax.scan(
        pass_b, jnp.zeros((fk, d * d), jnp.float32),
        (batch, lengths, topo_id, paths, r_all),
    )
    sxx = reduce_fn(sxx_flat)
    m2 = (
        sxx.reshape(fk, d, d)
        - counts_fk.reshape(fk)[:, None, None]
        * (d_fk[:, :, None] * d_fk[:, None, :])
    ).reshape(l, s, k, d, d)
    denom = jnp.maximum(counts - 1.0, 1.0)[..., None, None]
    eye = jnp.eye(d, dtype=jnp.float32)
    new_covs = m2 / denom + cov_reg * eye
    new_covs = jnp.where(empty_mix[..., None, None], covs_g, new_covs)
    new_covs = jnp.where(slot_used_k[..., None, None], new_covs, eye)

    # ---- transitions (state-level, identical to the K=1 fused program) ----
    row_sums = trans.sum(axis=2, keepdims=True)
    probs = trans / jnp.maximum(row_sums, 1.0)
    new_log_a = jnp.where(probs > 0, jnp.log(probs), NEG)
    no_out = (row_sums[..., 0] < 1.0) & slot_used
    new_log_a = jnp.where(no_out[..., None], log_a_g, new_log_a)

    keep = converged_l[:, None, None]
    new_means = jnp.where(keep[..., None], means_g, new_means)
    new_covs = jnp.where(keep[..., None, None], covs_g, new_covs)
    new_weights = jnp.where(keep, weights_g, new_weights)
    new_log_a = jnp.where(keep, log_a_g, new_log_a)

    return (
        new_means, new_covs, new_weights, new_log_a, counts, converged_l,
        paths,
    )


@partial(jax.jit, static_argnames=(
    "num_labels", "s_max", "num_mix", "cross_word", "cov_reg", "rtol", "atol"))
def fused_gmm_iteration(
    means_g, covs_g, weights_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, num_mix: int, cross_word: str = "exit_only",
):
    """One embedded GMM training iteration as one XLA program (_gmm_body)."""
    return _gmm_body(
        means_g, covs_g, weights_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id,
        cov_reg=cov_reg, rtol=rtol, atol=atol,
        num_labels=num_labels, s_max=s_max, num_mix=num_mix,
        cross_word=cross_word,
    )


@partial(jax.jit, static_argnames=(
    "mesh", "num_labels", "s_max", "num_mix", "cross_word", "cov_reg",
    "rtol", "atol"))
def fused_gmm_iteration_sharded(
    means_g, covs_g, weights_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id, mesh,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, num_mix: int, cross_word: str = "exit_only",
):
    """Mesh-sharded fused GMM iteration (psum'd statistics; sharding layout
    as in train_fused.fused_viterbi_iteration_sharded)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.data_parallel import DATA_AXIS

    body = partial(
        _gmm_body,
        cov_reg=cov_reg, rtol=rtol, atol=atol,
        num_labels=num_labels, s_max=s_max, num_mix=num_mix,
        cross_word=cross_word,
        reduce_fn=lambda x: jax.lax.psum(x, DATA_AXIS),
    )
    rep, sh = P(), P(DATA_AXIS)
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(rep,) * 11 + (sh, sh, sh),
        out_specs=(rep, rep, rep, rep, rep, rep, sh),
        check_vma=False,
    )(
        means_g, covs_g, weights_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id,
    )


def _gmm_train_loop(one_iter, max_iterations: int):
    """Whole-run lax.while_loop over GMM iterations (train_fused._train_loop_body
    analogue with the weights array in the carry)."""

    def cond(carry):
        *_params, _counts, it, converged = carry
        return jnp.logical_and(it < max_iterations, ~converged)

    def body(carry):
        means, covs, weights, log_a, _counts, it, _conv = carry
        nm, nc, nw, nla, counts, converged_l, _paths = one_iter(
            means, covs, weights, log_a
        )
        return (nm, nc, nw, nla, counts, it + 1, jnp.all(converged_l))

    def run(means, covs, weights, log_a, counts0):
        init = (means, covs, weights, log_a, counts0, jnp.int32(0),
                jnp.bool_(False))
        return jax.lax.while_loop(cond, body, init)

    return run


@partial(jax.jit, static_argnames=(
    "num_labels", "s_max", "num_mix", "cross_word", "cov_reg", "rtol",
    "atol", "max_iterations"))
def fused_gmm_train_run(
    means_g, covs_g, weights_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, num_mix: int, cross_word: str,
    max_iterations: int,
):
    """The ENTIRE embedded GMM refinement as ONE XLA program (whole-run
    device loop; see train_fused.fused_train_run). Returns
    (means, covs, weights, log_a, counts, iterations, converged)."""

    def one_iter(means, covs, weights, log_a):
        return _gmm_body(
            means, covs, weights, log_a, slot_used,
            lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
            batch, lengths, topo_id,
            cov_reg=cov_reg, rtol=rtol, atol=atol,
            num_labels=num_labels, s_max=s_max, num_mix=num_mix,
            cross_word=cross_word,
        )

    run = _gmm_train_loop(one_iter, max_iterations)
    counts0 = jnp.zeros((num_labels, s_max, num_mix), jnp.float32)
    return run(means_g, covs_g, weights_g, log_a_g, counts0)


@partial(jax.jit, static_argnames=(
    "mesh", "num_labels", "s_max", "num_mix", "cross_word", "cov_reg",
    "rtol", "atol", "max_iterations"))
def fused_gmm_train_run_sharded(
    means_g, covs_g, weights_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id, mesh,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, num_mix: int, cross_word: str,
    max_iterations: int,
):
    """Whole-run GMM device loop over a data-parallel mesh (psums inside the
    while_loop cross the device interconnect)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.data_parallel import DATA_AXIS

    def run_shard(
        means_g, covs_g, weights_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id,
    ):
        def one_iter(means, covs, weights, log_a):
            return _gmm_body(
                means, covs, weights, log_a, slot_used,
                lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
                batch, lengths, topo_id,
                cov_reg=cov_reg, rtol=rtol, atol=atol,
                num_labels=num_labels, s_max=s_max, num_mix=num_mix,
                cross_word=cross_word,
                reduce_fn=lambda x: jax.lax.psum(x, DATA_AXIS),
            )

        run = _gmm_train_loop(one_iter, max_iterations)
        counts0 = jnp.zeros((num_labels, s_max, num_mix), jnp.float32)
        return run(means_g, covs_g, weights_g, log_a_g, counts0)

    rep, sh = P(), P(DATA_AXIS)
    return shard_map(
        run_shard,
        mesh=mesh,
        in_specs=(rep,) * 11 + (sh, sh, sh),
        out_specs=(rep,) * 7,
        check_vma=False,
    )(
        means_g, covs_g, weights_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id,
    )


@dataclass(frozen=True)
class GMMContinuousTrainConfig:
    """Embedded GMM refinement configuration (subset of
    ContinuousTrainConfig — bootstrap belongs to the K=1 phase)."""

    max_iterations: int = 10
    cov_reg: float = 0.001
    rtol: float = 1e-5
    atol: float = 1e-8
    insert_silence: bool = True
    silence_label: str = "S"
    on_empty_state: str = "keep"  # "keep" | "fail" (empty STATES, not mixes)
    cross_word: str = "exit_only"
    length_multiple: int = 32


class GMMContinuousTrainer:
    """Embedded re-estimation of K-mixture GMM word models from transcripts.

    Same external shape as ContinuousTrainer (train / models), fused-only:
    every iteration is one XLA program (or one shard_map program on a mesh).
    """

    def __init__(
        self,
        models: Dict[str, GMMWordHMM],
        cfg: GMMContinuousTrainConfig = GMMContinuousTrainConfig(),
        mesh=None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.labels: List[str] = sorted(models)
        self.label_index = {lab: i for i, lab in enumerate(self.labels)}
        self.state_counts = {lab: models[lab].num_states for lab in self.labels}
        ks = {models[lab].num_mixtures for lab in self.labels}
        if len(ks) != 1:
            raise ValueError(f"all models must share K, got {sorted(ks)}")
        self.k = ks.pop()
        self.s_max = max(self.state_counts.values())
        self.dim = models[self.labels[0]].means.shape[-1]
        l, s, k, d = len(self.labels), self.s_max, self.k, self.dim
        self.means_g = np.zeros((l, s, k, d), np.float32)
        self.covs_g = np.tile(
            np.eye(d, dtype=np.float32), (l, s, k, 1, 1)
        )
        self.weights_g = np.full((l, s, k), 1.0 / k, np.float32)
        self.log_a_g = np.full((l, s, s), -np.inf, np.float32)
        for lab in self.labels:
            i, m = self.label_index[lab], models[lab]
            n = m.num_states
            self.means_g[i, :n] = m.means
            self.covs_g[i, :n] = m.covariances
            self.weights_g[i, :n] = m.weights
            self.log_a_g[i, :n, :n] = m.log_a
        self._iterations_done = 0

    def _slot_used(self) -> np.ndarray:
        used = np.zeros((len(self.labels), self.s_max), bool)
        for lab, i in self.label_index.items():
            used[i, : self.state_counts[lab]] = True
        return used

    def models(self) -> Dict[str, GMMWordHMM]:
        out = {}
        for lab in self.labels:
            i, n = self.label_index[lab], self.state_counts[lab]
            out[lab] = GMMWordHMM(
                label=lab,
                means=self.means_g[i, :n].copy(),
                covariances=self.covs_g[i, :n].copy(),
                weights=self.weights_g[i, :n].copy(),
                log_a=self.log_a_g[i, :n, :n].copy(),
            )
        return out

    def train(self, labeled_features: Dict[str, Sequence[np.ndarray]]) -> int:
        """Run embedded GMM refinement; returns iterations performed."""
        cfg = self.cfg
        fused = prepare_fused_corpus(
            labeled_features, self.state_counts, self.label_index,
            insert_silence if cfg.insert_silence else (lambda x: x),
            cfg.length_multiple,
            # K-mixture emissions scale the whitened intermediate by K;
            # shrink the chunk to keep per-chunk memory at the K=1 level.
            chunk_utts=max(8, 64 // max(self.k, 1)),
            num_shards=(self.mesh.devices.size if self.mesh is not None else 1),
        )
        l, s = len(self.labels), self.s_max
        if cfg.on_empty_state == "keep":
            # Whole-run device loop: every refinement iteration in ONE
            # dispatch, convergence on-device (same contract as
            # ContinuousTrainer's device loop; "fail" needs the
            # per-iteration counts on the host, so it keeps the step loop).
            return self._train_device_loop(fused)
        it = self._iterations_done
        for it in range(self._iterations_done + 1, cfg.max_iterations + 1):
            args = (
                jnp.asarray(self.means_g), jnp.asarray(self.covs_g),
                jnp.asarray(self.weights_g), jnp.asarray(self.log_a_g),
                jnp.asarray(self._slot_used()),
                fused.lab_tab, fused.loc_tab, fused.pos_tab,
                fused.samew_tab, fused.cross_tab, fused.n_states_t,
                fused.batch, fused.lengths, fused.topo_id,
            )
            kwargs = dict(
                cov_reg=float(cfg.cov_reg), rtol=float(cfg.rtol),
                atol=float(cfg.atol), num_labels=l, s_max=s,
                num_mix=self.k, cross_word=cfg.cross_word,
            )
            if self.mesh is not None:
                out = fused_gmm_iteration_sharded(*args, self.mesh, **kwargs)
            else:
                out = fused_gmm_iteration(*args, **kwargs)
            (new_means, new_covs, new_weights, new_log_a, counts,
             converged_l, _paths) = out
            counts, converged_l = jax.device_get((counts, converged_l))
            state_tot = counts.sum(axis=-1)
            empty_states = self._slot_used() & (state_tot < 1)
            if np.any(empty_states):
                bad = np.argwhere(empty_states).tolist()
                if cfg.on_empty_state == "fail":
                    raise HMMTrainMeanFail(
                        f"(label, state) slots with no frames: {bad}"
                    )
                logger.warning("empty (label, state) slots kept: %s", bad)
            self._iterations_done = it
            if converged_l.all():
                logger.info("GMM embedded training converged after %d", it)
                return it
            self.means_g = np.asarray(new_means, np.float32)
            self.covs_g = np.asarray(new_covs, np.float32)
            self.weights_g = np.asarray(new_weights, np.float32)
            self.log_a_g = np.asarray(new_log_a, np.float32)
        return it

    def _train_device_loop(self, fused) -> int:
        cfg = self.cfg
        remaining = cfg.max_iterations - self._iterations_done
        if remaining <= 0:
            return self._iterations_done
        l, s = len(self.labels), self.s_max
        args = (
            jnp.asarray(self.means_g), jnp.asarray(self.covs_g),
            jnp.asarray(self.weights_g), jnp.asarray(self.log_a_g),
            jnp.asarray(self._slot_used()),
            fused.lab_tab, fused.loc_tab, fused.pos_tab,
            fused.samew_tab, fused.cross_tab, fused.n_states_t,
            fused.batch, fused.lengths, fused.topo_id,
        )
        kwargs = dict(
            cov_reg=float(cfg.cov_reg), rtol=float(cfg.rtol),
            atol=float(cfg.atol), num_labels=l, s_max=s,
            num_mix=self.k, cross_word=cfg.cross_word,
            max_iterations=int(remaining),
        )
        if self.mesh is not None:
            out = fused_gmm_train_run_sharded(*args, self.mesh, **kwargs)
        else:
            out = fused_gmm_train_run(*args, **kwargs)
        means, covs, weights, log_a, counts, n_it, converged = out
        counts, n_it, converged = jax.device_get((counts, n_it, converged))
        state_tot = counts.sum(axis=-1)
        empty_states = self._slot_used() & (state_tot < 1)
        if np.any(empty_states):
            logger.warning(
                "final iteration left empty (label, state) slots: %s",
                np.argwhere(empty_states).tolist(),
            )
        self.means_g = np.asarray(means, np.float32)
        self.covs_g = np.asarray(covs, np.float32)
        self.weights_g = np.asarray(weights, np.float32)
        self.log_a_g = np.asarray(log_a, np.float32)
        self._iterations_done += int(n_it)
        if converged:
            logger.info(
                "GMM embedded training converged after %d iterations",
                self._iterations_done,
            )
        return self._iterations_done
