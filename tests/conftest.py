"""Test configuration: run everything on CPU with 8 virtual devices.

Multi-device sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count). Tests marked `gpu` need a CUDA GPU:
chip_smoke.py runs them on the card with CS304_TEST_PLATFORM=gpu, which
leaves the platform to JAX; everywhere else the `gpu` fixture skips them.
"""
import os

ON_GPU = os.environ.get("CS304_TEST_PLATFORM") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

# Integration tier: modules that shell out to the CLI scripts (each subprocess
# re-imports jax and re-compiles) or train real systems inline. Everything
# else — kernel/oracle/parity coverage — is the fast default tier.
_SLOW_MODULES = {
    "test_cli_chain",
    "test_cli_rich_decode",
    "test_scripts_smoke",
    "test_tidigits_tree",
}


def pytest_collection_modifyitems(config, items):
    """Auto-tier: anything using the session-scoped trained_system fixture,
    living in a subprocess-CLI module, or listed in tests/tiers.py (measured
    integration-weight tests, VERDICT r3 #4) is `slow`. Default runs stay
    fast with `pytest -m "not slow"`; the full suite is unchanged."""
    import os as _os
    import sys as _sys

    _sys.path.insert(0, _os.path.dirname(__file__))
    from tiers import RETIERED_SLOW

    for item in items:
        rel_id = item.nodeid.split("tests/")[-1]
        if (
            "trained_system" in getattr(item, "fixturenames", ())
            or item.module.__name__ in _SLOW_MODULES
            or rel_id in RETIERED_SLOW
        ):
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Route the decoder's 'scanfree' backend (the GPU trellis kernel)
    through the Pallas interpreter."""
    from functools import partial

    from cs304_tpu.ops.pallas import trellis_scanfree

    monkeypatch.setattr(
        trellis_scanfree, "viterbi_composite_batch_scanfree",
        partial(trellis_scanfree.viterbi_composite_batch_scanfree,
                interpret=True),
    )


@pytest.fixture
def gpu():
    """For tests marked `gpu`: skip unless JAX computes on a CUDA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run by chip_smoke.py on the card)")


@pytest.fixture(scope="session")
def trained_system():
    """The full reference pipeline, trained once per test session:
    project5 boot (endpointed digits + noise silence model) followed by
    project6 embedded continuous training. Used by the continuous-decoding
    and embedded-training test modules."""
    from cs304_tpu.audio.endpointing import SignalSeparation
    from cs304_tpu.data.synthetic import SyntheticTIDigits
    from cs304_tpu.data.ti_digits import DIGIT_LABELS
    from cs304_tpu.models.train_continuous import (
        ContinuousTrainConfig,
        ContinuousTrainer,
    )
    from cs304_tpu.models.train_kmeans import (
        SegmentalKMeansConfig,
        train_digit_models,
        train_word_hmm,
    )
    from cs304_tpu.ops.mfcc import mfcc_batch

    corpus = SyntheticTIDigits(
        num_train_speakers=6, num_test_speakers=2, takes_per_digit=3
    )
    sep = SignalSeparation()
    feats = {
        l: mfcc_batch(sep.remove_empty_batch(corpus.train_dataset[l]))
        for l in DIGIT_LABELS
    }
    boot = train_digit_models(
        feats, SegmentalKMeansConfig(num_states=5, max_iterations=15, length_multiple=32)
    )
    noises = [n for n in sep.get_all_noises() if len(n) >= 9 * sep.frame_size]
    boot["S"] = train_word_hmm(
        "S", mfcc_batch(noises),
        SegmentalKMeansConfig(num_states=3, max_iterations=15, length_multiple=32),
    ).model

    transcripts = ["12", "4Z", "375", "9O2", "186Z", "54321"]
    labeled = {
        tr: mfcc_batch(
            [
                corpus.sentence_audio(tr, spk, jitter_seed=take)
                for spk in range(6)
                for take in range(3)
            ]
        )
        for tr in transcripts
    }
    trainer = ContinuousTrainer(
        dict(boot),
        ContinuousTrainConfig(max_iterations=4, length_multiple=64, cov_reg=0.1),
    )
    iterations = trainer.train(labeled)
    return {
        "corpus": corpus,
        "boot_models": boot,
        "embedded_models": trainer.models(),
        "train_transcripts": transcripts,
        "iterations": iterations,
        "separator": sep,
    }
