"""Word-level HMMs and the flattened composite model, as stacked arrays.

The reference represents a word HMM as a Python list of frozen scipy Gaussians
plus a dict-of-tuples sparse transition matrix (hidden_markov_model.py:61-62,
transition_probability.py:15), and builds the composite multi-word state space
by block-diagonal dict concatenation (transition_probability.py:70-75) with
separate boundary bookkeeping (model_boundary.py). Here everything is arrays:

  WordHMM:      means (S, D), covariances (S, D, D), log_a (S, S) dense
  CompositeHMM: the concatenation of its words' arrays + int boundary vectors

At 58 composite states (11 digits x 5 + 3 silence), dense (S, S) costs nothing
and removes every dict lookup from the hot path.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..ops.gaussian import GaussianParams, gaussian_log_pdf, make_gaussian_params
from ..ops.viterbi import viterbi_banded, viterbi_composite

logger = logging.getLogger(__name__)

# Default inter-word log transition penalty (reference hidden_markov_model.py:419).
DEFAULT_WORD_PENALTY = float(np.log(0.005))


def uniform_forward_log_a(num_states: int) -> np.ndarray:
    """Initial transition matrix: row i uniform over states i..S-1
    (reference transition_probability.py:42-52), in log space."""
    log_a = np.full((num_states, num_states), -np.inf, np.float32)
    for i in range(num_states):
        log_a[i, i:] = np.log(1.0 / (num_states - i))
    return log_a


@dataclass
class WordHMM:
    """A single left-to-right word model."""

    label: str
    means: np.ndarray  # (S, D)
    covariances: np.ndarray  # (S, D, D)
    log_a: np.ndarray  # (S, S), -inf for zero-probability transitions

    _emission_cache: GaussianParams | None = field(default=None, repr=False)

    @property
    def num_states(self) -> int:
        return self.means.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def emission_params(self) -> GaussianParams:
        if self._emission_cache is None:
            self._emission_cache = make_gaussian_params(self.means, self.covariances)
        return self._emission_cache

    def log_likelihoods(self, features) -> jnp.ndarray:
        """(T, D) -> (T, S) emission log-densities."""
        return gaussian_log_pdf(self.emission_params(), jnp.asarray(features))

    def predict(self, features, length=None):
        """Viterbi score + state path for one utterance
        (reference HiddenMarkovModel.predict, hidden_markov_model.py:75-91)."""
        log_b = self.log_likelihoods(features)
        return viterbi_banded(log_b, jnp.asarray(self.log_a), length)


@dataclass
class CompositeHMM:
    """Flattened multi-word state space for continuous decoding/training.

    Equivalent to HiddenMarkovModelInference's loaded state
    (hidden_markov_model.py:421-456) plus ModelBoundary.
    """

    labels: List[str]
    state_counts: List[int]
    means: np.ndarray  # (S_total, D)
    covariances: np.ndarray  # (S_total, D, D)
    log_a: np.ndarray  # (S_total, S_total) block-diagonal
    penalty: float = DEFAULT_WORD_PENALTY

    _emission_cache: GaussianParams | None = field(default=None, repr=False)

    def __post_init__(self) -> None:
        bounds = np.cumsum([0] + list(self.state_counts))
        self.lowers = bounds[:-1].astype(np.int32)  # word entry states
        self.uppers = (bounds[1:] - 1).astype(np.int32)  # word exit states
        s = int(bounds[-1])
        self.num_states = s
        lower_of = np.zeros(s, np.int32)
        word_of = np.zeros(s, np.int32)
        for w, lo in enumerate(self.lowers):
            lower_of[lo:] = lo
            word_of[lo:] = w
        self.lower_of_state = lower_of
        self.word_of_state = word_of
        self.is_entry = np.zeros(s, bool)
        self.is_entry[self.lowers] = True
        self.is_exit = np.zeros(s, bool)
        self.is_exit[self.uppers] = True
        self._silence_word = (
            self.labels.index("S") if "S" in self.labels else None
        )

    def emission_params(self) -> GaussianParams:
        if self._emission_cache is None:
            self._emission_cache = make_gaussian_params(self.means, self.covariances)
        return self._emission_cache

    def log_likelihoods(self, features) -> jnp.ndarray:
        return gaussian_log_pdf(self.emission_params(), jnp.asarray(features))

    def viterbi(self, features, length=None):
        log_b = self.log_likelihoods(features)
        return viterbi_composite(
            log_b,
            jnp.asarray(self.log_a),
            jnp.asarray(self.lower_of_state),
            jnp.asarray(self.is_entry),
            jnp.asarray(self.is_exit),
            self.penalty,
            length,
        )

    # -- path decoding (host-side, mirrors ModelBoundary.get_labels,
    #    model_boundary.py:107-139; fully vectorized — the per-point Python
    #    walk was the serving-loop bottleneck at ~1.6 ms/utterance) ----------
    def path_to_labels(self, path: np.ndarray, skip_silence: bool = True) -> List[str]:
        path = np.asarray(path)
        # Run-length compress to state-change points.
        keep = np.ones(len(path), bool)
        keep[1:] = path[1:] != path[:-1]
        points = path[keep]
        words = self.word_of_state[points]
        # A word is emitted at point i when the word changes, or when the same
        # word is re-entered exit->entry (repeated word,
        # model_boundary.py:131-135). Point 0 always emits.
        emit = np.ones(len(points), bool)
        emit[1:] = (words[1:] != words[:-1]) | (
            (points[:-1] == self.uppers[words[1:]])
            & (points[1:] == self.lowers[words[1:]])
        )
        emitted = words[emit]
        if skip_silence and self._silence_word is not None:
            emitted = emitted[emitted != self._silence_word]
        return [self.labels[w] for w in emitted]

    def word_state_range(self, label: str) -> Tuple[int, int]:
        w = self.labels.index(label)
        return int(self.lowers[w]), int(self.uppers[w]) + 1


def stack_word_models(
    models: Sequence[WordHMM], penalty: float = DEFAULT_WORD_PENALTY
) -> CompositeHMM:
    """Concatenate word models into one composite state space.

    Replaces LogTransitionProbabilities.append + ModelBoundary.append
    (reference hidden_markov_model.py:431-456) with array concatenation.
    """
    state_counts = [m.num_states for m in models]
    s_total = sum(state_counts)
    d = models[0].dim
    means = np.concatenate([m.means for m in models], axis=0)
    covs = np.concatenate([m.covariances for m in models], axis=0)
    log_a = np.full((s_total, s_total), -np.inf, np.float32)
    base = 0
    for m in models:
        n = m.num_states
        log_a[base : base + n, base : base + n] = m.log_a
        base += n
    return CompositeHMM(
        labels=[m.label for m in models],
        state_counts=state_counts,
        means=means,
        covariances=covs,
        log_a=log_a,
        penalty=penalty,
    )


def sentence_hmm(labels: str, models: Dict[str, WordHMM]) -> CompositeHMM:
    """Concatenate word models in transcript order (the training-time sentence
    HMM, reference HiddenMarkovModelMultiWord.from_labels,
    hidden_markov_model.py:638-664).

    Cross-word transitions inside the skip-2 band are FREE (log prob 0): the
    reference's sentence Viterbi reuses the single-word banded recursion over
    the concatenated states, and its sparse matrix returns 0.0 for any key it
    never stored — which is exactly every cross-word (old, new) pair
    (transition_probability.py:17-23, hidden_markov_model.py:591-593). That
    accident is what lets training alignments flow between words, so we
    reproduce it deliberately here.
    """
    composite = stack_word_models([models[l] for l in labels])
    word_of = composite.word_of_state
    cross = word_of[:, None] != word_of[None, :]
    s = composite.num_states
    frm = np.arange(s)[:, None]
    to = np.arange(s)[None, :]
    band = (frm <= to) & (frm >= to - 2)
    composite.log_a = np.where(cross & band, 0.0, composite.log_a).astype(np.float32)
    return composite
