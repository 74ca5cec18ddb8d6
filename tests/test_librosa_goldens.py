"""Parity against REAL librosa output.

Two modes, best available wins:

1. If `tests/golden/librosa_goldens.npz` is committed (generated by
   tests/golden/make_librosa_goldens.py on any machine with librosa), assert
   the JAX front-end matches those genuine librosa features.
2. Else if librosa happens to be importable here, compute the reference
   pipeline live and assert against it.
3. Else skip with an actionable message (this environment has no network and
   no librosa wheel; VERDICT missing #2 tracks getting the npz committed).

Either way the comparison target is librosa's own code, not the in-repo
re-derivation (tests/reference_mfcc.py), so the correlated-blind-spot risk is
broken as soon as the goldens land.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest

_GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
_GOLDEN_NPZ = os.path.join(_GOLDEN_DIR, "librosa_goldens.npz")
sys.path.insert(0, _GOLDEN_DIR)

from make_librosa_goldens import golden_signals  # noqa: E402

_HAS_GOLDENS = os.path.exists(_GOLDEN_NPZ)
_HAS_LIBROSA = importlib.util.find_spec("librosa") is not None


def _expected_features():
    if _HAS_GOLDENS:
        data = np.load(_GOLDEN_NPZ)
        sigs = {k[len("signal_"):]: data[k] for k in data.files
                if k.startswith("signal_")}
        feats = {k[len("features_"):]: data[k] for k in data.files
                 if k.startswith("features_")}
        return sigs, feats, "committed goldens"
    if _HAS_LIBROSA:
        from make_librosa_goldens import librosa_reference_features

        sigs = golden_signals()
        feats = {name: librosa_reference_features(sig)
                 for name, sig in sigs.items()}
        return sigs, feats, "live librosa"
    pytest.skip(
        "no real-librosa oracle available: commit tests/golden/"
        "librosa_goldens.npz (run make_librosa_goldens.py on a machine with "
        "librosa) or install librosa"
    )


def test_mfcc_matches_real_librosa():
    from cs304_tpu.ops.mfcc import mfcc_batch

    sigs, feats, source = _expected_features()
    ours = mfcc_batch(list(sigs.values()))
    for got, (name, want) in zip(ours, feats.items()):
        assert got.shape == want.shape, (name, got.shape, want.shape)
        err = np.abs(got - want).max()
        assert err <= 1e-4, f"{name} vs {source}: max abs err {err}"
