"""Drop-in API compatibility with the reference's `loe_speech_recognition`.

A user of the reference package can `from cs304_tpu.compat import ...` the
same names with the same call shapes (reference src/loe_speech_recognition/
__init__.py:1-30) and get the batched JAX implementations underneath:

    MFCC(signal, sample_rate).feature_vector          # (39, T) like mfcc.py:47
    MFCC.batch(signals, sample_rate)                   # list of (T, 39)
    TIDigits("./ConvertedTIDigits").train_dataset["1"]
    HiddenMarkovModelTrainable.from_data(label, mfccs, 5, 100)
    model.predict(features) -> (score, path)
    model.save(folder); HiddenMarkovModel.from_folder(folder/label)
    HiddenMarkovModelInference.from_folder(folder, labels).predict(feats) -> "4Z2"
    HiddenMarkovModelTrainContinuous.from_folder(...).train(labeled_mfccs)
    ModelCollection.load_from_files(folder).predict(feats) -> "7"
    DynamicTimeWarping(sequences, sample).search() -> (index, distance)

Checkpoint compatibility is ONE-WAY: this package saves/loads the npz format
(utils/checkpoint.py) in the reference's directory layout (<dir>/<label>/...),
and `import_reference_checkpoint()` below converts an existing reference
`.cache/` of scipy pickles (log_trans_probs.pickle + multivariate_normals.pickle
per label, reference hidden_markov_model.py:93-115) into live models / npz.
The reverse direction (writing pickles the reference can read) is deliberately
unsupported — it would re-introduce the pickle format this package replaces.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# Same-name re-exports that already match the reference surface.
from .audio.capture import Segmentation  # noqa: F401
from .audio.endpointing import SignalSeparation  # noqa: F401
from .data.ti_digits import (  # noqa: F401
    TI_DIGITS_LABELS,
    DataLoader,
    TIDigits,
)
from .reporting.csvnia import CSVReader, CSVWriter  # noqa: F401
from .reporting.visualizer import (  # noqa: F401
    plot_confusion_matrix_from_lists,
    plot_line,
)

from .models.decoder import ContinuousDecoder
from .models.hmm import WordHMM
from .models.train_continuous import ContinuousTrainConfig, ContinuousTrainer
from .models.train_kmeans import SegmentalKMeansConfig, train_word_hmm
from .ops.dtw import DTWRecognizer
from .ops.mfcc import MFCCConfig, mfcc_batch, mfcc_features
from .utils import checkpoint as _ckpt


# Reference type alias (ti_digits.py:13): the valid digit labels.
TI_DIGITS_LABEL_TYPE = str


class Signal:
    """Alignment container (reference signal.py:15-50): a feature sequence
    plus its Viterbi path, with per-state frame slicing."""

    def __init__(self, num_of_state: int, signal, path) -> None:
        self.num_of_state = num_of_state
        self.signal = np.asarray(signal)
        self.path = np.asarray(path)

    @property
    def order_by_state(self):
        """Frames grouped per state assuming a monotone path
        (reference signal.py:24-47); None for states with no frames."""
        segments = []
        start = 0
        for state in range(self.num_of_state):
            end = start
            while end < len(self.path) and self.path[end] == state:
                end += 1
            segments.append(self.signal[start:end] if end > start else None)
            start = end
        return segments

    @property
    def order_by_signal(self):
        return list(zip(self.signal, self.path))


class MFCC:
    """reference mfcc.py:13-84 — coefficient-major feature_vector."""

    def __init__(self, signal, sample_rate, n_mfcc: int = 13) -> None:
        signal = np.asarray(signal, np.float32)
        if signal.ndim != 1:
            raise ValueError("Input signal must be 1-dimensional.")
        cfg = MFCCConfig(sample_rate=float(sample_rate), n_mfcc=n_mfcc)
        feats, t_valid = mfcc_features(signal, cfg=cfg)
        self._feature_vector = np.asarray(feats)[: int(t_valid)].T  # (39, T)

    @property
    def feature_vector(self) -> np.ndarray:
        return self._feature_vector

    @classmethod
    def batch(cls, signals, sample_rate) -> List[np.ndarray]:
        """List of transposed (T, 39) features (reference mfcc.py:71-84)."""
        return mfcc_batch(list(signals), float(sample_rate))


class HiddenMarkovModel:
    """Single-word HMM with the reference's predict/save/from_folder surface
    (hidden_markov_model.py:51-158)."""

    def __init__(self, label: str, core: WordHMM | None = None) -> None:
        self.label = label
        self._core = core

    def __str__(self) -> str:
        return self.label

    @property
    def num_of_states(self) -> int:
        return self._core.num_states

    @property
    def dim_of_features(self) -> int:
        return self._core.dim

    def predict(self, signal) -> Tuple[float, np.ndarray]:
        score, path = self._core.predict(np.asarray(signal, np.float32))
        return float(score), np.asarray(path)

    def save(self, parent_folder_path: str = "./cache") -> None:
        _ckpt.save_model(self._core, parent_folder_path)

    @classmethod
    def from_folder(cls, model_folder_path: str) -> "HiddenMarkovModel":
        core = _ckpt.load_model(model_folder_path)
        return cls(core.label, core)


class HiddenMarkovModelTrainable(HiddenMarkovModel):
    """Segmental k-means training surface (hidden_markov_model.py:233-281)."""

    @classmethod
    def from_data(
        cls,
        label: str,
        mfccs: Sequence[np.ndarray],
        num_of_states: int = 5,
        max_iterations: int = 100,
        **_compat_flags,
    ) -> "HiddenMarkovModelTrainable":
        cfg = SegmentalKMeansConfig(
            num_states=num_of_states, max_iterations=max_iterations
        )
        result = train_word_hmm(label, list(mfccs), cfg)
        return cls(label, result.model)


class HiddenMarkovModelInference:
    """Continuous decoder surface (hidden_markov_model.py:413-461)."""

    def __init__(self, decoder: ContinuousDecoder) -> None:
        self._decoder = decoder

    @classmethod
    def from_folder(
        cls, folder_path: str, models_to_load: List[str]
    ) -> "HiddenMarkovModelInference":
        models = _ckpt.load_models(folder_path, labels=list(models_to_load))
        return cls(ContinuousDecoder(models))

    @property
    def _log_transition_probability_between_words(self) -> float:
        return self._decoder.penalty

    @_log_transition_probability_between_words.setter
    def _log_transition_probability_between_words(self, value: float) -> None:
        # The reference's scripts poke this private attribute
        # (project5_test_ndigits_with_sil.py:62); keep it working.
        self._decoder.penalty = value

    def predict(self, signal) -> str:
        return self._decoder.predict(np.asarray(signal, np.float32))


class HiddenMarkovModelTrainContinuous:
    """Embedded continuous training surface (hidden_markov_model.py:667-797)."""

    def __init__(self, trainer: ContinuousTrainer) -> None:
        self._trainer = trainer

    @classmethod
    def from_folder(
        cls, folder_path: str, models_to_load: List[str], **_compat_flags
    ) -> "HiddenMarkovModelTrainContinuous":
        models = _ckpt.load_models(folder_path, labels=list(models_to_load))
        return cls(ContinuousTrainer(models, ContinuousTrainConfig()))

    def train(self, labeled_mfccs: Dict[str, List[np.ndarray]],
              max_iterations: int = 100) -> None:
        self._trainer.cfg = ContinuousTrainConfig(max_iterations=max_iterations)
        self._trainer.train(labeled_mfccs)

    def save(self, folder_path: str) -> None:
        _ckpt.save_models(self._trainer.models(), folder_path)


class ModelCollection:
    """Isolated argmax classifier surface (model_collection.py:15-40), plus
    the continuous method the reference script calls but never implemented
    (predict_continuous_controller, SURVEY.md §2 #14)."""

    def __init__(self, models: Dict[str, WordHMM]) -> None:
        from .models.collection import ModelCollection as _MC

        self._mc = _MC.from_models([models[l] for l in sorted(models)])
        self._models = models

    @classmethod
    def load_from_files(cls, folder_path: str) -> "ModelCollection":
        models = _ckpt.load_models(folder_path, labels=list(TI_DIGITS_LABELS))
        return cls(models)

    def predict(self, signal) -> str:
        return self._mc.predict(np.asarray(signal, np.float32))

    def predict_continuous_controller(self, signal, penalty: float = -100.0) -> str:
        decoder = ContinuousDecoder(self._models, penalty=penalty)
        return decoder.predict(np.asarray(signal, np.float32))


class DynamicTimeWarping:
    """Multi-template DTW surface (dynamic_time_wrapping.py:14-116): raw
    signals in, (best index, distance) out."""

    def __init__(
        self,
        sequences: List[np.ndarray],
        sample: np.ndarray,
        sample_rate=16000,
        pruning: bool = True,
        pruning_factor: float = 4.0,
        **_compat_flags,
    ) -> None:
        feats = MFCC.batch(list(sequences), sample_rate)
        self._rec = DTWRecognizer.from_features(
            feats, pruning=pruning, pruning_factor=pruning_factor
        )
        self._sample = MFCC(np.asarray(sample, np.float32), sample_rate).feature_vector.T

    def search(self) -> Tuple[int, float]:
        return self._rec.search(self._sample)


def import_reference_checkpoint(
    folder_path: str,
    labels: Sequence[str] | None = None,
    save_npz_to: str | None = None,
) -> Dict[str, "WordHMM"]:
    """Best-effort importer for checkpoints written BY THE ACTUAL REFERENCE.

    Reads each <folder>/<label>/{log_trans_probs,multivariate_normals}.pickle
    (reference hidden_markov_model.py:93-115: a LogTransitionProbabilities
    sparse dict and a list of scipy-frozen MultivariateNormal wrappers) and
    converts them to WordHMMs. The reference's classes are not importable
    here, so stub classes are registered under the pickled module paths —
    dataclass pickles restore via __dict__, no reference code runs.

    SECURITY NOTE: pickle.load executes arbitrary bytecode by design — only
    point this at checkpoints you trust.

    save_npz_to: optionally also write the converted models in this package's
    npz format (utils/checkpoint.py) for future loads.
    """
    import os
    import pickle
    import sys
    import types

    from .models.hmm import WordHMM

    # Stub modules matching the reference's pickled class paths.
    for mod_name, cls_names in (
        ("loe_speech_recognition.transition_probability",
         ("SparseMatrix", "TransitionProbabilities", "LogTransitionProbabilities")),
        ("loe_speech_recognition.hidden_markov_model", ("MultivariateNormal",)),
    ):
        if mod_name not in sys.modules:
            pkg_name = mod_name.rsplit(".", 1)[0]
            if pkg_name not in sys.modules:
                sys.modules[pkg_name] = types.ModuleType(pkg_name)
            mod = types.ModuleType(mod_name)
            for cls_name in cls_names:
                stub = type(cls_name, (), {})
                setattr(mod, cls_name, stub)
            sys.modules[mod_name] = mod

    if labels is None:
        labels = sorted(
            d for d in os.listdir(folder_path)
            if os.path.isdir(os.path.join(folder_path, d))
        )
    out: Dict[str, WordHMM] = {}
    for label in labels:
        model_dir = os.path.join(folder_path, label)
        with open(os.path.join(model_dir, "log_trans_probs.pickle"), "rb") as f:
            ltp = pickle.load(f)
        with open(os.path.join(model_dir, "multivariate_normals.pickle"), "rb") as f:
            mns = pickle.load(f)
        s = int(ltp.num_of_states)
        log_a = np.full((s, s), -np.inf, np.float32)
        for (i, j), v in ltp._core.items():
            log_a[i, j] = v
        means, covs = [], []
        for mn in mns:
            frozen = mn._core  # scipy multivariate_normal_frozen
            means.append(np.asarray(frozen.mean, np.float32))
            cov = getattr(frozen, "cov", None)
            if cov is None or not isinstance(cov, np.ndarray):
                cov = np.asarray(frozen.cov_object.covariance)
            covs.append(np.asarray(cov, np.float32))
        out[label] = WordHMM(
            label=label,
            means=np.stack(means),
            covariances=np.stack(covs),
            log_a=log_a,
        )
    if save_npz_to:
        from .utils import checkpoint as _ckpt_mod

        _ckpt_mod.save_models(out, save_npz_to)
    return out


# The reference package's full export list (src/loe_speech_recognition/
# __init__.py:11-30), name for name.
__all__ = [
    "MFCC", "Segmentation", "DynamicTimeWarping", "TIDigits",
    "TI_DIGITS_LABELS", "DataLoader", "HiddenMarkovModel",
    "HiddenMarkovModelTrainable", "HiddenMarkovModelInference",
    "HiddenMarkovModelTrainContinuous", "Signal", "ModelCollection",
    "TI_DIGITS_LABEL_TYPE", "plot_confusion_matrix_from_lists", "plot_line",
    "CSVReader", "CSVWriter", "SignalSeparation",
]
