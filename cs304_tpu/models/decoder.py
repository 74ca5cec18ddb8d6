"""Continuous-speech decoder over the flattened composite state space.

Equivalent of HiddenMarkovModelInference (reference hidden_markov_model.py:413-581):
loads word models (optionally including the silence model "S"), flattens them,
runs the composite Viterbi, and converts the state path to a digit string. The
inter-word penalty is a first-class parameter (the reference pokes the private
attribute from scripts, e.g. project5_test_ndigits_with_sil.py:62).
"""
from __future__ import annotations

import logging
from functools import partial
from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..data.batching import pad_batch
from ..ops.gaussian import gaussian_log_pdf, make_gaussian_params
from ..ops.viterbi import viterbi_composite_batch
from .hmm import DEFAULT_WORD_PENALTY, WordHMM, stack_word_models

logger = logging.getLogger(__name__)

# emission_precision tiers of the quad layout -> the dot precision of its
# (N, D^2) x (D^2, S) product. On the GPU an f32 dot without a precision runs
# in TF32, so each tier names its arithmetic explicitly:
# - "highest": true f32 (the exact-f32 contract);
# - "high": three bf16 passes with f32 accumulation (hi*hi + hi*lo + lo*hi),
#   the tier validated at agreement 1.0 on two trained 100-word checkpoints;
# - "default": the backend's default f32 dot, which is TF32 on the GPU. The
#   tier validated as a negative (0.825 vs 0.9625 exact-sequence on the
#   trained 100-word corpus) was a 1-pass bf16 dot, not TF32; TF32 has not
#   been measured.
EMISSION_PRECISION = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    "default": jax.lax.Precision.DEFAULT,
}


def auto_backend() -> str:
    """What backend="auto" resolves to: the scan-free trellis kernel where
    it compiles (the GPU), the banded fast scan elsewhere. Both give
    bitwise-identical decodes."""
    from ..ops.pallas import has_kernels

    return "scanfree" if has_kernels() else "fast"


class ContinuousDecoder:
    """Batched continuous decoding with optional silence handling.

    Accepts single-Gaussian WordHMMs, K-mixture GMMWordHMMs, or a mix (the
    Gaussians are lifted to K=1 mixtures). GMM decoding extends the reference,
    whose GMM tier was never wired into the continuous decoder
    (deprecated/gaussian_mixture_model.py).
    """

    def __init__(
        self,
        models,
        penalty: float = DEFAULT_WORD_PENALTY,
        sort_labels: bool = True,
        backend: str = "auto",
        bigram=None,
        lm_weight: float = 1.0,
        beam: float | None = None,
        emissions: str = "whiten",
        emission_precision: str = "highest",
    ) -> None:
        if isinstance(models, dict):
            models = list(models.values())
        if sort_labels:
            # The reference walks the checkpoint dir in sorted order
            # (hidden_markov_model.py:431), which fixes tie-break order.
            models = sorted(models, key=lambda m: m.label)
        if backend not in ("auto", "scan", "fast", "scanfree"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "auto":
            backend = auto_backend()
        if bigram is not None and backend == "scanfree":
            # The kernel hard-codes the one-shared-penalty entry update; the
            # fast banded path supports per-pair penalties via a (W, W)
            # tropical matvec over per-word best exits.
            logger.info("bigram LM decoding uses the fast banded backend")
            backend = "fast"
        if beam is not None:
            if beam <= 0:
                raise ValueError(f"beam must be positive, got {beam}")
            if backend != "fast":
                # Only the banded fast step implements the per-frame prune
                # (ops/viterbi.viterbi_composite_batch_fast's beam arg).
                logger.info("beam pruning uses the fast banded backend")
                backend = "fast"
        if emissions not in ("whiten", "quad"):
            raise ValueError(f"unknown emissions layout {emissions!r}")
        if emission_precision not in EMISSION_PRECISION:
            raise ValueError(
                f"unknown emission precision {emission_precision!r}"
            )
        if emission_precision != "highest" and emissions != "quad":
            # The whitening layout IS the bit-parity reference; only the
            # quad layout (which already trades ~1e-2 logpdf drift for
            # speed) offers the lower tiers (see EMISSION_PRECISION).
            raise ValueError(
                "emission_precision tiers below 'highest' require "
                "emissions='quad' (the whitening layout stays f32-exact "
                "by contract)"
            )
        self.backend = backend
        self.beam = beam
        # "whiten": f32-exact whitening matmul (reference parity). "quad":
        # the serving path's quadratic-form layout — one (T, D^2) x (D^2, S)
        # matmul, no (T, S, D) intermediate (~1e-2 absolute logpdf drift;
        # only exact near-ties in the argmax can flip).
        # Honored by predict/predict_batch/viterbi_batch,
        # predict_signal_batch, and the counted/duration/grammar modes;
        # n-best/lattice/posterior-confidence paths deliberately stay on
        # the whitening layout (their posterior measures are the parity
        # reference). GMM checkpoints honor the knob too: the (S, K) grid
        # flattens to S*K quad Gaussians + logsumexp (gmm_log_pdf_quad).
        self.emissions = emissions
        self.emission_precision = emission_precision
        self._bigram = bigram
        self._lm_weight = lm_weight

        from .gmm_hmm import GMMWordHMM

        if any(isinstance(m, GMMWordHMM) for m in models):
            gaussian_views, gmm_stack = _lift_to_gmm(models)
            self.composite = stack_word_models(gaussian_views, penalty)
            self._gmm = gmm_stack  # (means, covs, weights) stacked over states
        else:
            self.composite = stack_word_models(models, penalty)
            self._gmm = None

    @property
    def penalty(self) -> float:
        return self.composite.penalty

    @penalty.setter
    def penalty(self, value: float) -> None:
        self.composite.penalty = value

    def _penalty_arg(self):
        """Penalty operand for the selected backend, plus LM extras.

        Returns (penalty, lm_extras): no LM -> (scalar, None); LM + scan
        backend -> ((S, S) per-pair matrix through the dense transition
        matrix, None); LM + fast backend -> (scalar, ((W, W) pair matrix,
        word_of_state, uppers)) for the banded step's tropical matvec."""
        if self._bigram is None:
            return jnp.float32(self.composite.penalty), None
        from ..ops.lm import pair_penalty_matrix, word_pair_penalties

        if self.backend == "scan":
            return jnp.asarray(pair_penalty_matrix(
                self.composite, self._bigram, self._lm_weight,
            )), None
        pair = word_pair_penalties(
            self.composite, self._bigram, self._lm_weight
        )
        return jnp.float32(self.composite.penalty), (
            jnp.asarray(pair),
            jnp.asarray(self.composite.word_of_state, dtype=jnp.int32),
            jnp.asarray(self.composite.uppers, dtype=jnp.int32),
        )

    def _beam_arg(self):
        return None if self.beam is None else jnp.float32(self.beam)

    def predict(self, features, skip_silence: bool = True) -> str:
        return self.predict_batch([np.asarray(features)], skip_silence)[0]

    def predict_batch(
        self, features: Sequence[np.ndarray], skip_silence: bool = True
    ) -> List[str]:
        """Decode a ragged list of (T_i, D) features to digit strings.

        The path -> word compaction runs ON DEVICE (ops/words.py) as an
        epilogue of the decode program, so the host reads back only
        (B, max_words) word ids instead of the padded (B, T) path — ~20x
        less readback. Utterances
        are bucketed by padded length like viterbi_batch. If a transcript
        somehow exceeds the word buffer, that batch falls back to the host
        path walk (never silently truncates)."""
        idx_buckets = self._buckets(features)
        out: List[str] = [""] * len(features)
        for idx in idx_buckets:
            chunk = [features[i] for i in idx]
            try:
                handles = self._dispatch(chunk, skip_silence)
                strings = self._consume(handles)
            except ValueError:
                scores, paths, lengths = self.viterbi_batch(
                    chunk, bucket=False
                )
                strings = [
                    "".join(
                        self.composite.path_to_labels(
                            paths[i, :l], skip_silence
                        )
                    )
                    for i, l in enumerate(lengths)
                ]
            for i, s in zip(idx, strings):
                out[i] = s
        return out

    def _buckets(self, features: Sequence[np.ndarray]) -> List[List[int]]:
        """Group utterance indices by padded length (128-frame multiples)."""
        buckets: Dict[int, List[int]] = {}
        for i, f in enumerate(features):
            key = -(-max(np.asarray(f).shape[0], 1) // 128) * 128
            buckets.setdefault(key, []).append(i)
        return list(buckets.values())

    def predict_batches(self, feature_batches, skip_silence: bool = True):
        """Generator over BATCHES of feature lists with double buffering:
        batch i+1 is dispatched to the device before batch i's results are
        pulled to the host, so device execution can overlap host-side
        consumption (the standard dispatch-ahead serving loop)."""
        pending = None
        for features in feature_batches:
            handles = self._dispatch(features, skip_silence)
            if pending is not None:
                yield self._consume(pending)
            pending = handles
        if pending is not None:
            yield self._consume(pending)

    def predict_signal_batch(
        self, signals: Sequence[np.ndarray], skip_silence: bool = True,
        mcfg=None, length_multiple: int = 16000,
    ) -> List[str]:
        """Decode RAW audio end-to-end on device: MFCC + trellis + word
        compaction in ONE program per length bucket — no feature round-trip.
        Profiled in benchmarks/serving_bench.py: the serving finals path
        spent most of its wall time pulling device features to the host and
        re-uploading them; this is the fused alternative (the same shape as
        bench.py's headline program plus the word epilogue)."""
        from ..ops.mfcc import MFCCConfig

        if mcfg is None:
            mcfg = MFCCConfig()
        out: List[str] = [""] * len(signals)
        buckets: Dict[int, List[int]] = {}
        for i, s in enumerate(signals):
            key = -(-max(len(s), 1) // length_multiple) * length_multiple
            buckets.setdefault(key, []).append(i)
        c = self.composite
        wos, lowers, uppers, sil = self._word_args(skip_silence)
        pen, lm_extras = self._penalty_arg()
        from ..ops.words import ids_to_strings

        for key, idx in buckets.items():
            # Pad the BATCH dimension to a power of two as well: serving
            # finals arrive in arbitrary group sizes, and every new (B, L)
            # shape otherwise compiles a fresh program.
            b_pad = max(4, 1 << (len(idx) - 1).bit_length())
            padded = np.zeros((b_pad, key), np.float32)
            n_samples = np.full(b_pad, 160, np.int32)  # 1-frame dummies
            for row, i in enumerate(idx):
                sig = np.asarray(signals[i], np.float32).reshape(-1)
                padded[row, : len(sig)] = sig
                n_samples[row] = len(sig)
            if self._gmm is not None:
                means, covs, weights = self._gmm
                handles = _decode_signals_gmm_words(
                    jnp.asarray(means), jnp.asarray(covs),
                    jnp.asarray(weights), jnp.asarray(c.log_a),
                    jnp.asarray(c.lower_of_state), jnp.asarray(c.is_entry),
                    jnp.asarray(c.is_exit), pen,
                    jnp.asarray(padded), jnp.asarray(n_samples),
                    wos, lowers, uppers, sil, mcfg, self.backend, lm_extras,
                    beam=self._beam_arg(),
                )
            else:
                handles = _decode_signals_words(
                    jnp.asarray(c.means), jnp.asarray(c.covariances),
                    jnp.asarray(c.log_a), jnp.asarray(c.lower_of_state),
                    jnp.asarray(c.is_entry), jnp.asarray(c.is_exit), pen,
                    jnp.asarray(padded), jnp.asarray(n_samples),
                    wos, lowers, uppers, sil, mcfg, self.backend, lm_extras,
                    beam=self._beam_arg(), emissions=self.emissions,
                    emission_precision=self.emission_precision,
                )
            _scores, ids, counts = jax.device_get(handles)
            try:
                texts = ids_to_strings(ids, counts, c.labels)[: len(idx)]
            except ValueError:
                # A transcript exceeded the device word buffer (>64 words):
                # fall back to the staged path, whose own fallback walks the
                # full path on the host — never silently truncates (same
                # contract as predict_batch._consume).
                from ..ops.mfcc import mfcc_batch

                texts = self.predict_batch(
                    mfcc_batch([signals[i] for i in idx], cfg=mcfg),
                    skip_silence,
                )
            for row, i in enumerate(idx):
                out[i] = texts[row]
        return out

    def predict_batch_with_confidence(
        self, features: Sequence[np.ndarray], skip_silence: bool = True
    ):
        """Batched decode with per-word posterior confidences:
        [[(label, start, end, confidence), ...] per utterance]
        (ops/lattice.word_confidences_batch — one vmapped max-plus decode +
        one vmapped sum-semiring pass). GMM-aware. Confidences are computed
        under the flat-penalty measure (an attached bigram LM affects
        predict/predict_batch but not these posteriors)."""
        from ..ops.lattice import word_confidences_batch

        log_b = None
        if self._gmm is not None:
            from ..ops.gaussian import gmm_log_pdf, make_gmm_params

            means, covs, weights = self._gmm
            params = make_gmm_params(
                jnp.asarray(means), jnp.asarray(covs), jnp.asarray(weights)
            )
            log_b = [
                gmm_log_pdf(params, jnp.asarray(f)) for f in features
            ]
        return word_confidences_batch(
            self.composite, features, log_b=log_b, skip_silence=skip_silence
        )

    def predict_batch_counted(
        self, features: Sequence[np.ndarray], n_words: int,
        skip_silence: bool = True,
    ) -> List[str]:
        """Decode constrained to EXACTLY n_words non-silence words
        (ops/viterbi_counted.py — the trellis composed with a word-count
        automaton). Utterances where no such path exists (score -inf, e.g.
        too few frames for n_words) fall back to the unconstrained decode.
        GMM-aware; the flat penalty is used (no bigram LM in the counted
        trellis)."""
        from ..ops.viterbi_counted import viterbi_composite_counted_batch

        c = self.composite
        padded = pad_batch(features, 128)
        log_b = self._emissions(jnp.asarray(padded.data))
        counted = jnp.asarray(c.word_of_state != c._silence_word)
        scores, paths = viterbi_composite_counted_batch(
            log_b, jnp.asarray(c.log_a), jnp.asarray(c.lower_of_state),
            jnp.asarray(c.is_entry), jnp.asarray(c.is_exit), counted,
            jnp.float32(c.penalty), n_words, jnp.asarray(padded.lengths),
        )
        scores = np.asarray(scores)
        paths = np.asarray(paths)
        out: List[str] = []
        fallback_idx = [i for i in range(len(features))
                        if not np.isfinite(scores[i])]
        fallbacks = {}
        if fallback_idx:
            logger.info(
                "counted decode: %d utterance(s) have no %d-word path; "
                "falling back to unconstrained", len(fallback_idx), n_words,
            )
            preds = self.predict_batch(
                [features[i] for i in fallback_idx], skip_silence
            )
            fallbacks = dict(zip(fallback_idx, preds))
        for i in range(len(features)):
            if i in fallbacks:
                out.append(fallbacks[i])
                continue
            labels = c.path_to_labels(
                paths[i, : padded.lengths[i]], skip_silence=skip_silence
            )
            out.append("".join(labels))
        return out

    def predict_batch_duration(
        self, features: Sequence[np.ndarray],
        min_duration=2, max_duration=None,
        skip_silence: bool = True, constrain_silence: bool = False,
    ) -> List[str]:
        """Decode under explicit state-duration constraints
        (ops/viterbi_duration.py — the trellis composed with per-state
        duration counters): every word state must persist >= min_duration
        frames (int, or {label: int}) and may persist <= max_duration.
        Suppresses the single-frame state transits behind spurious word
        insertions. Utterances with no duration-feasible path (score -inf,
        e.g. too few frames) fall back to the unconstrained decode.
        GMM-aware; the flat penalty is used (no bigram LM here)."""
        from ..ops.viterbi_duration import (
            duration_arrays,
            viterbi_composite_duration_batch,
        )

        c = self.composite
        min_dur, max_dur, d_cap = duration_arrays(
            c, min_duration, max_duration, constrain_silence
        )
        padded = pad_batch(features, 128)
        log_b = self._emissions(jnp.asarray(padded.data))
        scores, paths = viterbi_composite_duration_batch(
            log_b, jnp.asarray(c.log_a), jnp.asarray(c.lower_of_state),
            jnp.asarray(c.is_entry), jnp.asarray(c.is_exit),
            jnp.float32(c.penalty), jnp.asarray(min_dur),
            jnp.asarray(max_dur), jnp.asarray(padded.lengths), d_cap=d_cap,
        )
        scores = np.asarray(scores)
        paths = np.asarray(paths)
        out: List[str] = []
        fallback_idx = [i for i in range(len(features))
                        if not np.isfinite(scores[i])]
        fallbacks = {}
        if fallback_idx:
            logger.info(
                "duration decode: %d utterance(s) have no duration-feasible "
                "path; falling back to unconstrained", len(fallback_idx),
            )
            preds = self.predict_batch(
                [features[i] for i in fallback_idx], skip_silence
            )
            fallbacks = dict(zip(fallback_idx, preds))
        for i in range(len(features)):
            if i in fallbacks:
                out.append(fallbacks[i])
                continue
            labels = c.path_to_labels(
                paths[i, : padded.lengths[i]], skip_silence=skip_silence
            )
            out.append("".join(labels))
        return out

    def predict_batch_grammar(
        self, features: Sequence[np.ndarray], grammar,
        skip_silence: bool = True,
    ) -> List[str]:
        """Decode constrained to word sequences a WordDFA accepts
        (ops/grammar.py — the trellis composed with the automaton): digit
        patterns with per-position alphabets, finite command sets, count
        ranges. Utterances with no accepted path (score -inf) fall back to
        the unconstrained decode. GMM-aware; the flat penalty is used (no
        bigram LM in the grammar trellis)."""
        from ..ops.grammar import viterbi_composite_grammar_batch

        c = self.composite
        if list(grammar.labels) != list(c.labels):
            raise ValueError(
                f"grammar vocabulary {grammar.labels} does not match the "
                f"decoder's labels {c.labels}"
            )
        padded = pad_batch(features, 128)
        log_b = self._emissions(jnp.asarray(padded.data))
        scores, paths = viterbi_composite_grammar_batch(
            log_b, jnp.asarray(c.log_a), jnp.asarray(c.lower_of_state),
            jnp.asarray(c.is_entry), jnp.asarray(c.is_exit),
            jnp.asarray(c.word_of_state.astype(np.int32)),
            jnp.asarray(grammar.next_state), jnp.asarray(grammar.accept),
            jnp.float32(c.penalty), jnp.asarray(padded.lengths),
        )
        scores = np.asarray(scores)
        paths = np.asarray(paths)
        out: List[str] = []
        fallback_idx = [i for i in range(len(features))
                        if not np.isfinite(scores[i])]
        fallbacks = {}
        if fallback_idx:
            logger.info(
                "grammar decode: %d utterance(s) have no accepted path; "
                "falling back to unconstrained", len(fallback_idx),
            )
            preds = self.predict_batch(
                [features[i] for i in fallback_idx], skip_silence
            )
            fallbacks = dict(zip(fallback_idx, preds))
        for i in range(len(features)):
            if i in fallbacks:
                out.append(fallbacks[i])
                continue
            labels = c.path_to_labels(
                paths[i, : padded.lengths[i]], skip_silence=skip_silence
            )
            out.append("".join(labels))
        return out

    def _emissions(self, batch):
        """(B, T, D) padded features -> (B, T, S) log densities with the
        decoder's actual emission model (GMM when present; honors the
        emissions="quad" layout for Gaussian models)."""
        if self._gmm is not None:
            from ..ops.gaussian import gmm_log_pdf, make_gmm_params

            means, covs, weights = self._gmm
            params = make_gmm_params(
                jnp.asarray(means), jnp.asarray(covs), jnp.asarray(weights)
            )
            return jax.vmap(lambda x: gmm_log_pdf(params, x))(batch)
        if self.emissions == "quad":
            from ..ops.gaussian import (
                gaussian_log_pdf_quad,
                make_gaussian_quad_params,
            )

            qparams = make_gaussian_quad_params(
                jnp.asarray(self.composite.means),
                jnp.asarray(self.composite.covariances),
            )
            return jax.vmap(
                lambda x: gaussian_log_pdf_quad(qparams, x)
            )(batch)
        params = make_gaussian_params(
            jnp.asarray(self.composite.means),
            jnp.asarray(self.composite.covariances),
        )
        return jax.vmap(lambda x: gaussian_log_pdf(params, x))(batch)

    def predict_nbest(self, features, n: int = 4, beam_k: int | None = None):
        """N-best word strings for one utterance: [(score, text), ...].

        Uses the decoder's ACTUAL emission densities — for K-mixture models
        the GMM log-densities, not the composite's single-Gaussian view
        (nbest_decode's default log_b would silently score with mixture 0
        only on a GMM checkpoint).

        An attached bigram LM is NOT applied inside the k-best forward —
        hypotheses and scores use the flat penalty (so they are comparable
        to the lattice/posterior measure, not to an LM-weighted predict).
        Apply the LM afterwards with ops.lm.rescore_nbest."""
        from ..ops.nbest import nbest_decode

        log_b = None
        if self._gmm is not None:
            from ..ops.gaussian import gmm_log_pdf, make_gmm_params

            means, covs, weights = self._gmm
            params = make_gmm_params(
                jnp.asarray(means), jnp.asarray(covs), jnp.asarray(weights)
            )
            log_b = gmm_log_pdf(params, jnp.asarray(features))
        return nbest_decode(
            self.composite, features, n=n, beam_k=beam_k, log_b=log_b
        )

    def _word_args(self, skip_silence: bool):
        c = self.composite
        sil = (
            c.labels.index("S") if (skip_silence and "S" in c.labels) else -1
        )
        return (
            jnp.asarray(c.word_of_state.astype(np.int32)),
            jnp.asarray(c.lowers.astype(np.int32)),
            jnp.asarray(c.uppers.astype(np.int32)),
            sil,
        )

    def _dispatch(self, features: Sequence[np.ndarray],
                  skip_silence: bool = True):
        """Enqueue one batch (decode + on-device word compaction); returns
        device handles without blocking."""
        c = self.composite
        padded = pad_batch(features, 128)
        wos, lowers, uppers, sil = self._word_args(skip_silence)
        pen, lm_extras = self._penalty_arg()
        if self._gmm is not None:
            means, covs, weights = self._gmm
            return _decode_batch_gmm_words(
                jnp.asarray(means), jnp.asarray(covs), jnp.asarray(weights),
                jnp.asarray(c.log_a), jnp.asarray(c.lower_of_state),
                jnp.asarray(c.is_entry), jnp.asarray(c.is_exit),
                pen,
                jnp.asarray(padded.data), jnp.asarray(padded.lengths),
                wos, lowers, uppers, sil,
                self.backend, lm_extras, beam=self._beam_arg(),
                emissions=self.emissions,
                emission_precision=self.emission_precision,
            )
        return _decode_batch_words(
            jnp.asarray(c.means), jnp.asarray(c.covariances),
            jnp.asarray(c.log_a), jnp.asarray(c.lower_of_state),
            jnp.asarray(c.is_entry), jnp.asarray(c.is_exit),
            pen,
            jnp.asarray(padded.data), jnp.asarray(padded.lengths),
            wos, lowers, uppers, sil,
            self.backend, lm_extras, beam=self._beam_arg(),
            emissions=self.emissions,
            emission_precision=self.emission_precision,
        )

    def _consume(self, handles):
        from ..ops.words import ids_to_strings

        # One batched transfer (jax.device_get) instead of per-array
        # np.asarray syncs.
        _scores, ids, counts = jax.device_get(handles)
        return ids_to_strings(ids, counts, self.composite.labels)

    def viterbi_batch(self, features: Sequence[np.ndarray], bucket: bool = True):
        """Returns (scores (B,), paths (B, T) np.int32, lengths (B,)).

        bucket=True groups utterances by padded length (multiples of 128
        frames) and decodes each bucket separately, so a corpus sweep mixing
        1-digit and 7-digit utterances doesn't pay max-length padding for
        everything (SURVEY.md §7 "ragged utterance lengths"). Paths are
        returned padded to the LONGEST bucket for a uniform array.
        """
        if bucket and len(features) > 1:
            buckets: Dict[int, List[int]] = {}
            for i, f in enumerate(features):
                key = -(-max(f.shape[0], 1) // 128) * 128
                buckets.setdefault(key, []).append(i)
            if len(buckets) > 1:
                b = len(features)
                t_max = max(buckets)
                scores = np.zeros(b, np.float32)
                paths = np.zeros((b, t_max), np.int32)
                lengths = np.zeros(b, np.int32)
                for idx in buckets.values():
                    s_k, p_k, l_k = self.viterbi_batch(
                        [features[i] for i in idx], bucket=False
                    )
                    scores[idx] = s_k
                    paths[idx, : p_k.shape[1]] = p_k
                    lengths[idx] = l_k
                return scores, paths, lengths

        c = self.composite
        padded = pad_batch(features, 128)
        if self._gmm is not None:
            means, covs, weights = self._gmm
            pen, lm_extras = self._penalty_arg()
            scores, paths = _decode_batch_gmm(
                jnp.asarray(means), jnp.asarray(covs), jnp.asarray(weights),
                jnp.asarray(c.log_a), jnp.asarray(c.lower_of_state),
                jnp.asarray(c.is_entry), jnp.asarray(c.is_exit),
                pen,
                jnp.asarray(padded.data), jnp.asarray(padded.lengths),
                self.backend, lm_extras, beam=self._beam_arg(),
                emissions=self.emissions,
                emission_precision=self.emission_precision,
            )
        else:
            pen, lm_extras = self._penalty_arg()
            scores, paths = _decode_batch(
                jnp.asarray(c.means),
                jnp.asarray(c.covariances),
                jnp.asarray(c.log_a),
                jnp.asarray(c.lower_of_state),
                jnp.asarray(c.is_entry),
                jnp.asarray(c.is_exit),
                pen,
                jnp.asarray(padded.data),
                jnp.asarray(padded.lengths),
                self.backend, lm_extras, beam=self._beam_arg(),
                emissions=self.emissions,
                emission_precision=self.emission_precision,
            )
        return np.asarray(scores), np.asarray(paths), padded.lengths


def _lift_to_gmm(models):
    """Mixed WordHMM/GMMWordHMM list -> (gaussian boundary views, stacked
    per-state GMM params padded to a common K — pad_mixture_params is the
    one shared lifting convention)."""
    from .gmm_hmm import GMMWordHMM, pad_mixture_params

    k_max = max(
        m.num_mixtures if isinstance(m, GMMWordHMM) else 1 for m in models
    )
    views, means_l, covs_l, weights_l = [], [], [], []
    for m in models:
        mm, cc, ww = pad_mixture_params(m, k_max)
        if isinstance(m, GMMWordHMM):
            views.append(
                WordHMM(label=m.label, means=m.means[:, 0],
                        covariances=m.covariances[:, 0], log_a=m.log_a)
            )
        else:
            views.append(m)
        means_l.append(mm)
        covs_l.append(cc)
        weights_l.append(ww)
    stack = (
        np.concatenate(means_l), np.concatenate(covs_l), np.concatenate(weights_l)
    )
    return views, stack


def _select_impl(backend: str):
    from ..ops.pallas.trellis_scanfree import viterbi_composite_batch_scanfree
    from ..ops.viterbi import viterbi_composite_batch_fast

    return {
        "scan": viterbi_composite_batch,
        "fast": viterbi_composite_batch_fast,
        # One GPU kernel for forward + backtrace, bitwise-identical to
        # "fast" (ops/pallas/trellis_scanfree.py).
        "scanfree": viterbi_composite_batch_scanfree,
    }[backend]


def _run_impl(backend, log_b, log_a, lower_of_state, is_entry, is_exit,
              penalty, lengths, lm_extras, beam=None):
    if lm_extras is not None or beam is not None:
        # Bigram LM per-pair penalties and beam pruning: only the fast
        # banded step takes them directly (the scan route gets an (S, S)
        # penalty instead; no other backend implements the prune).
        from ..ops.viterbi import viterbi_composite_batch_fast

        pair, word_of_state, uppers = (
            lm_extras if lm_extras is not None else (None, None, None)
        )
        return viterbi_composite_batch_fast(
            log_b, log_a, lower_of_state, is_entry, is_exit, penalty,
            lengths, pair_penalty=pair, word_of_state=word_of_state,
            uppers=uppers, beam=beam,
        )
    return _select_impl(backend)(
        log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths
    )


@partial(jax.jit, static_argnames=("backend", "emissions",
                                   "emission_precision"))
def _decode_batch(
    means, covs, log_a, lower_of_state, is_entry, is_exit, penalty, batch, lengths,
    backend: str = "scan", lm_extras=None, beam=None,
    emissions: str = "whiten", emission_precision: str = "highest",
):
    if emissions == "quad":
        from ..ops.gaussian import (
            gaussian_log_pdf_quad,
            make_gaussian_quad_params,
        )

        prec = EMISSION_PRECISION[emission_precision]
        qparams = make_gaussian_quad_params(means, covs)
        log_b = jax.vmap(
            lambda x: gaussian_log_pdf_quad(qparams, x, precision=prec)
        )(batch)
    else:
        params = make_gaussian_params(means, covs)
        log_b = jax.vmap(lambda x: gaussian_log_pdf(params, x))(batch)
    return _run_impl(
        backend, log_b, log_a, lower_of_state, is_entry, is_exit, penalty,
        lengths, lm_extras, beam,
    )


@partial(jax.jit, static_argnames=("backend", "emissions",
                                   "emission_precision"))
def _decode_batch_gmm(
    means, covs, weights, log_a, lower_of_state, is_entry, is_exit, penalty,
    batch, lengths, backend: str = "fast", lm_extras=None, beam=None,
    emissions: str = "whiten", emission_precision: str = "highest",
):
    if emissions == "quad":
        # The large-S lever extended to GMM checkpoints: the (S, K) grid
        # flattens to S*K quad-layout Gaussians (one matmul), then
        # logsumexp over K. Same ~1e-2 drift contract as the
        # single-Gaussian quad path.
        from ..ops.gaussian import gmm_log_pdf_quad, make_gmm_quad_params

        prec = EMISSION_PRECISION[emission_precision]
        qparams = make_gmm_quad_params(means, covs, weights)
        log_b = jax.vmap(
            lambda x: gmm_log_pdf_quad(qparams, x, precision=prec)
        )(batch)
    else:
        from ..ops.gaussian import gmm_log_pdf, make_gmm_params

        # Zero-weight padded mixtures contribute log(0) = -inf and drop
        # out of the logsumexp.
        params = make_gmm_params(means, covs, weights)
        log_b = jax.vmap(lambda x: gmm_log_pdf(params, x))(batch)
    return _run_impl(
        backend, log_b, log_a, lower_of_state, is_entry, is_exit, penalty,
        lengths, lm_extras, beam,
    )


# Serving decode with the word compaction fused in as a device epilogue
# (ops/words.py): readback is (B, max_words) ids + counts, not (B, T) paths.
MAX_WORDS = 64


@partial(jax.jit, static_argnames=("backend", "max_words", "emissions",
                                   "emission_precision"))
def _decode_batch_words(
    means, covs, log_a, lower_of_state, is_entry, is_exit, penalty, batch,
    lengths, word_of_state, lowers, uppers, silence_word,
    backend: str = "scan", lm_extras=None, max_words: int = MAX_WORDS,
    beam=None, emissions: str = "whiten", emission_precision: str = "highest",
):
    from ..ops.words import words_from_paths

    scores, paths = _decode_batch(
        means, covs, log_a, lower_of_state, is_entry, is_exit, penalty,
        batch, lengths, backend, lm_extras, beam, emissions,
        emission_precision,
    )
    ids, counts = words_from_paths(
        paths, lengths, word_of_state, lowers, uppers, silence_word,
        max_words=max_words,
    )
    return scores, ids, counts


@partial(jax.jit, static_argnames=("mcfg", "backend", "max_words",
                                   "emissions", "emission_precision"))
def _decode_signals_words(
    means, covs, log_a, lower_of_state, is_entry, is_exit, penalty, signals,
    n_samples, word_of_state, lowers, uppers, silence_word, mcfg,
    backend: str = "fast", lm_extras=None, max_words: int = MAX_WORDS,
    beam=None, emissions: str = "whiten", emission_precision: str = "highest",
):
    """Raw (B, L) audio -> (scores, word ids, counts), one XLA program."""
    from ..ops.mfcc import mfcc_features_batch
    from ..ops.words import words_from_paths

    feats, n_frames = mfcc_features_batch(signals, n_samples, mcfg)
    if emissions == "quad":
        from ..ops.gaussian import (
            gaussian_log_pdf_quad,
            make_gaussian_quad_params,
        )

        prec = EMISSION_PRECISION[emission_precision]
        qparams = make_gaussian_quad_params(means, covs)
        log_b = jax.vmap(
            lambda x: gaussian_log_pdf_quad(qparams, x, precision=prec)
        )(feats)
    else:
        params = make_gaussian_params(means, covs)
        log_b = jax.vmap(lambda x: gaussian_log_pdf(params, x))(feats)
    scores, paths = _run_impl(
        backend, log_b, log_a, lower_of_state, is_entry, is_exit, penalty,
        n_frames, lm_extras, beam,
    )
    ids, counts = words_from_paths(
        paths, n_frames, word_of_state, lowers, uppers, silence_word,
        max_words=max_words,
    )
    return scores, ids, counts


@partial(jax.jit, static_argnames=("mcfg", "backend", "max_words"))
def _decode_signals_gmm_words(
    means, covs, weights, log_a, lower_of_state, is_entry, is_exit, penalty,
    signals, n_samples, word_of_state, lowers, uppers, silence_word, mcfg,
    backend: str = "fast", lm_extras=None, max_words: int = MAX_WORDS,
    beam=None,
):
    from ..ops.gaussian import gmm_log_pdf, make_gmm_params
    from ..ops.mfcc import mfcc_features_batch
    from ..ops.words import words_from_paths

    feats, n_frames = mfcc_features_batch(signals, n_samples, mcfg)
    params = make_gmm_params(means, covs, weights)
    log_b = jax.vmap(lambda x: gmm_log_pdf(params, x))(feats)
    scores, paths = _run_impl(
        backend, log_b, log_a, lower_of_state, is_entry, is_exit, penalty,
        n_frames, lm_extras, beam,
    )
    ids, counts = words_from_paths(
        paths, n_frames, word_of_state, lowers, uppers, silence_word,
        max_words=max_words,
    )
    return scores, ids, counts


@partial(jax.jit, static_argnames=("backend", "max_words", "emissions",
                                   "emission_precision"))
def _decode_batch_gmm_words(
    means, covs, weights, log_a, lower_of_state, is_entry, is_exit, penalty,
    batch, lengths, word_of_state, lowers, uppers, silence_word,
    backend: str = "fast", lm_extras=None, max_words: int = MAX_WORDS,
    beam=None, emissions: str = "whiten", emission_precision: str = "highest",
):
    from ..ops.words import words_from_paths

    scores, paths = _decode_batch_gmm(
        means, covs, weights, log_a, lower_of_state, is_entry, is_exit,
        penalty, batch, lengths, backend, lm_extras, beam,
        emissions, emission_precision,
    )
    ids, counts = words_from_paths(
        paths, lengths, word_of_state, lowers, uppers, silence_word,
        max_words=max_words,
    )
    return scores, ids, counts
