#!/usr/bin/env python
"""Generate real-librosa golden feature vectors for the MFCC parity test.

Run this ON A MACHINE WITH LIBROSA INSTALLED (any OS/arch — the goldens are
pure float arrays) and commit the resulting `librosa_goldens.npz` next to this
script. The in-repo parity test (tests/test_librosa_goldens.py) then asserts
the JAX front-end against genuine librosa output instead of a same-author
re-derivation.

    python tests/golden/make_librosa_goldens.py

The signals are generated deterministically here so this script and the test
agree byte-for-byte on the inputs. The feature pipeline below is the
reference's exact call sequence (/root/reference/src/loe_speech_recognition/
mfcc.py:31-43): melspectrogram(n_mels=40, n_fft=320, hop=160, fmin=133.33,
fmax=6855.4976) -> power_to_db(ref=max) -> mfcc(n_mfcc=13) -> delta (width 9)
-> concat([per-frame-normalized mfcc; delta; delta2]).T
"""
import os

import numpy as np

SAMPLE_RATE = 16000


def golden_signals() -> dict:
    """Deterministic test clips covering the parity-relevant regimes."""
    rng = np.random.RandomState(20260816)  # legacy RandomState: stable forever
    t = lambda n: np.arange(n) / SAMPLE_RATE

    def tone(n, f0, f1, amp):
        x = t(n)
        return (amp * (np.sin(2 * np.pi * f0 * x)
                       + 0.5 * np.sin(2 * np.pi * f1 * x))).astype(np.float32)

    sigs = {
        # ~1.5s speech-like two-formant tone + noise
        "speech_like": (tone(24000, 440.0, 1800.0, 6000.0)
                        + rng.randn(24000).astype(np.float32) * 50.0),
        # shortest legal clip: exactly delta_width frames (9 = 1 + 1280//160)
        "short_9_frames": (tone(1280, 700.0, 2100.0, 3000.0)
                           + rng.randn(1280).astype(np.float32) * 20.0),
        # pure near-silence (exercises power_to_db ref=max on tiny power)
        "near_silent": rng.randn(8000).astype(np.float32) * 1e-3,
        # hard-clipped loud signal (flat-top frames, top_db clamp active)
        "clipped": np.clip(tone(16000, 300.0, 900.0, 40000.0),
                           -32767.0, 32767.0).astype(np.float32),
        # long clip, odd length not divisible by hop
        "long_odd": (tone(52341, 220.0, 2600.0, 8000.0)
                     + rng.randn(52341).astype(np.float32) * 100.0),
        # int16-quantized (the WAV-file path's dtype journey)
        "int16_roundtrip": tone(12000, 550.0, 1500.0, 12000.0)
        .astype(np.int16).astype(np.float32),
    }
    return sigs


def librosa_reference_features(signal: np.ndarray) -> np.ndarray:
    """The reference's MFCC.feature_vector.T via real librosa calls."""
    import librosa

    mel = librosa.feature.melspectrogram(
        y=signal, sr=SAMPLE_RATE, n_mels=40, n_fft=320, hop_length=160,
        fmin=133.33, fmax=6855.4976,
    )
    log_mel = librosa.power_to_db(mel, ref=np.max)
    mfccs = librosa.feature.mfcc(S=log_mel, sr=SAMPLE_RATE, n_mfcc=13)
    d1 = librosa.feature.delta(mfccs)
    d2 = librosa.feature.delta(mfccs, order=2)
    # The reference's normalize_mfccs: axis=0 of the (13, T) array — across
    # coefficients per frame (its docstring says otherwise; parity keeps it).
    mean = np.mean(mfccs, axis=0, keepdims=True)
    std = np.std(mfccs, axis=0, keepdims=True)
    normalized = (mfccs - mean) / (std + 1e-8)
    return np.concatenate((normalized, d1, d2), axis=0).T.astype(np.float32)


def main() -> None:
    out = {}
    for name, sig in golden_signals().items():
        out[f"signal_{name}"] = sig
        out[f"features_{name}"] = librosa_reference_features(sig)
        print(f"{name}: signal {sig.shape} -> features {out[f'features_{name}'].shape}")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "librosa_goldens.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
