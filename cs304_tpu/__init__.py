"""cs304_tpu — a JAX speech-recognition framework that runs on an NVIDIA GPU.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
loeeeee/CS-304-Speech-Recognition-Code (reference mounted at /root/reference):

- MFCC front-end (39-dim: 13 normalized MFCCs + delta + delta-delta), jittable and
  vmappable, bit-comparable to the reference's librosa pipeline
  (reference: src/loe_speech_recognition/mfcc.py).
- Single-word left-to-right HMMs with full-covariance Gaussian (and K-mixture GMM)
  emissions, Viterbi via lax.scan with all-states-parallel max-plus updates
  (reference: src/loe_speech_recognition/hidden_markov_model.py:51-208).
- Segmental k-means (Viterbi) training, batched over padded utterances
  (reference: hidden_markov_model.py:211-410).
- Continuous-speech composite decoder with inter-word penalties and silence models
  (reference: hidden_markov_model.py:413-581).
- Embedded continuous training over digit-string transcripts
  (reference: hidden_markov_model.py:584-797).
- Multi-template DTW recognizer (reference: dynamic_time_wrapping.py).
- TI-Digits corpus plumbing, endpointing, reporting, checkpoints, typed configs.

The compute path is pure JAX (jit/vmap/scan/pallas); batch-level parallelism is
expressed with jax.sharding over a device Mesh (replacing the reference's
ProcessPoolExecutor fan-out, hidden_markov_model.py:300-305).
"""

__version__ = "0.1.0"

import importlib as _importlib

# Public name -> defining submodule. Resolved lazily (PEP 562) so that optional
# heavy imports (matplotlib, audio backends) only load when actually used.
_EXPORTS = {
    "MFCCConfig": ".ops.mfcc",
    "mfcc_features": ".ops.mfcc",
    "mfcc_batch": ".ops.mfcc",
    "GaussianParams": ".ops.gaussian",
    "gaussian_log_pdf": ".ops.gaussian",
    "make_gaussian_params": ".ops.gaussian",
    "viterbi_banded": ".ops.viterbi",
    "viterbi_composite": ".ops.viterbi",
    "WordHMM": ".models.hmm",
    "CompositeHMM": ".models.hmm",
    "stack_word_models": ".models.hmm",
    "train_word_hmm": ".models.train_kmeans",
    "SegmentalKMeansConfig": ".models.train_kmeans",
    "ContinuousDecoder": ".models.decoder",
    "WordDFA": ".ops.grammar",
    "BatchedStreamingComposite": ".ops.streaming_batch",
    "ServingSessionPool": ".serving",
    "UtteranceResult": ".serving",
    "ForcedAligner": ".models.align",
    "map_adapt": ".models.adapt",
    "self_adapt": ".models.adapt",
    "AlignResult": ".models.align",
    "WordSegment": ".models.align",
    "ModelCollection": ".models.collection",
    "ContinuousTrainer": ".models.train_continuous",
    "insert_silence": ".models.train_continuous",
    "TIDigits": ".data.ti_digits",
    "DataLoader": ".data.ti_digits",
    "TI_DIGITS_LABELS": ".data.ti_digits",
    "SyntheticTIDigits": ".data.synthetic",
    "pad_batch": ".data.batching",
    "SignalSeparation": ".audio.endpointing",
    "Segmentation": ".audio.capture",
    "CSVReader": ".reporting.csvnia",
    "CSVWriter": ".reporting.csvnia",
    "plot_confusion_matrix_from_lists": ".reporting.visualizer",
    "plot_line": ".reporting.visualizer",
    "confusion_matrix": ".reporting.visualizer",
    "DTWRecognizer": ".ops.dtw",
    "forward_backward": ".ops.forward_backward",
    "forward_log_likelihood": ".ops.forward_backward",
    "GMMWordHMM": ".models.gmm_hmm",
    "train_gmm_hmm": ".models.gmm_hmm",
    "train_gmm_hmm_baum_welch": ".models.gmm_hmm",
    "Lattice": ".ops.lattice",
    "nbest_lattice": ".ops.lattice",
    "forward_lattice": ".ops.lattice",
    "word_confidences": ".ops.lattice",
    "word_confidences_batch": ".ops.lattice",
    "spot_keyword": ".ops.lattice",
    "consensus_decode": ".ops.lattice",
    "viterbi_composite_counted": ".ops.viterbi_counted",
    "word_occupancy_posteriors": ".ops.lattice",
    "word_end_log_posteriors": ".ops.lattice",
    "WordBigram": ".ops.lm",
    "train_word_bigram": ".ops.lm",
    "rescore_nbest": ".ops.lm",
    "wer": ".reporting.metrics",
    "corpus_wer": ".reporting.metrics",
    "edit_ops": ".reporting.metrics",
    "GMMContinuousTrainer": ".models.train_continuous_gmm",
    "GMMContinuousTrainConfig": ".models.train_continuous_gmm",
    "promote_to_gmm": ".models.train_continuous_gmm",
    "Lexicon": ".models.lexicon",
    "compose_word_models": ".models.lexicon",
    "uniform_phone_boot": ".models.lexicon",
    "train_phone_models": ".models.lexicon",
    "train_biphone_models": ".models.biphone",
    "compose_word_models_biphone": ".models.biphone",
    "biphone_lexicon": ".models.biphone",
    "train_triphone_models": ".models.triphone",
    "compose_word_models_triphone": ".models.triphone",
    "triphone_lexicon": ".models.triphone",
    "make_word_corpus": ".data.wordvocab",
    "make_lexicon": ".data.wordvocab",
    "save_models": ".utils.checkpoint",
    "load_models": ".utils.checkpoint",
    "save_model": ".utils.checkpoint",
    "load_model": ".utils.checkpoint",
    "Config": ".utils.config",
    "sentence_hmm": ".models.hmm",
    "plot_spectrogram": ".reporting.spectrograms",
    "plot_mel_spectrogram": ".reporting.spectrograms",
    "plot_mfcc": ".reporting.spectrograms",
    "nbest_decode": ".ops.nbest",
    "StreamingComposite": ".ops.streaming",
    "StreamingMFCC": ".ops.streaming_mfcc",
    "make_mesh": ".parallel.data_parallel",
    "dp_kmeans_step": ".parallel.data_parallel",
    "dp_composite_decode": ".parallel.data_parallel",
}


def __getattr__(name):
    if name in _EXPORTS:
        module = _importlib.import_module(_EXPORTS[name], __name__)
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_EXPORTS)
