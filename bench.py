#!/usr/bin/env python
"""Headline benchmark: end-to-end MFCC + composite-Viterbi decode throughput.

Workload: B synthetic ~1.5 s utterances -> 39-dim MFCC front-end -> 58-state
composite continuous Viterbi (11 digit words x 5 states + 3-state silence),
the reference's project5/6 decode hot path. The device pipeline is one jitted
program over the whole batch: MFCC, quad-layout emissions (XLA) and the
composite trellis of ContinuousDecoder's backend="auto" (the scan-free GPU
kernel on the GPU). The baseline is a NumPy/SciPy re-implementation of the
reference's algorithm (per-clip MFCC + Python-loop trellis with per-(t,state)
scipy logpdf — hidden_markov_model.py:481-581), measured on a few utterances
and extrapolated (it is ~4 orders of magnitude slower).

Prints ONE JSON line:
  {"metric": ..., "value": utt/s, "unit": "utt/s", "vs_baseline": speedup,
   "device": {"platform", "kind", "count"}, "card": nvidia-smi name, limit}
"""
import json
import subprocess
import time

import numpy as np

# Serving batch. 512 was the throughput peak of a sweep made on a different
# accelerator; on the GPU the batch size is not tuned yet.
BATCH = 512
SECONDS = 1.5
SAMPLE_RATE = 16000
BASELINE_CLIPS = 3


def make_signals(batch: int, seconds: float, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    sigs = []
    for i in range(batch):
        f0 = rng.uniform(200, 900)
        f1 = rng.uniform(900, 2600)
        sig = (
            np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6))
            + 0.6 * np.sin(2 * np.pi * f1 * t + rng.uniform(0, 6))
        ) * 6000.0
        sig += rng.normal(0, 50.0, n)
        sigs.append(sig.astype(np.float32))
    return np.stack(sigs)


def device_pipeline(backend: str | None = None):
    """The jitted (signals, num_samples) -> (scores, paths) decode program,
    with the trellis of `backend` (default: what backend="auto" resolves to
    on this platform)."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _flagship_params
    from cs304_tpu.models.decoder import _decode_batch, auto_backend
    from cs304_tpu.ops.mfcc import MFCCConfig, mfcc_features

    comp = _flagship_params()
    cfg = MFCCConfig()
    params = (
        jnp.asarray(comp.means), jnp.asarray(comp.covariances),
        jnp.asarray(comp.log_a), jnp.asarray(comp.lower_of_state),
        jnp.asarray(comp.is_entry), jnp.asarray(comp.is_exit),
        jnp.float32(comp.penalty),
    )
    backend = backend or auto_backend()

    # The device-side path -> word-id compaction (ops/words.py) is not in
    # this program: it is timed as part of ContinuousDecoder.predict_batch.
    @jax.jit
    def decode(signals, num_samples):
        feats, n_frames = jax.vmap(lambda s, n: mfcc_features(s, n, cfg))(
            signals, num_samples
        )
        return _decode_batch(*params, feats, n_frames, backend=backend,
                             emissions="quad")

    return decode


def main() -> None:
    import jax

    from cs304_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    signals = make_signals(BATCH, SECONDS)
    num_samples = np.full(BATCH, signals.shape[1], np.int32)
    decode = device_pipeline()

    sj = jax.device_put(signals)
    nj = jax.device_put(num_samples)
    jax.block_until_ready(decode(sj, nj))  # compile + warm up

    # Best of 3 windows of 20 reps.
    reps = 20
    best_dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = decode(sj, nj)
        jax.block_until_ready(out)
        best_dt = min(best_dt, time.perf_counter() - t0)
    device_ups = BATCH * reps / best_dt

    # NumPy-reference baseline on a few clips, extrapolated.
    import scipy.stats
    from __graft_entry__ import _flagship_params
    from benchmarks.reference_numpy import numpy_composite_viterbi, numpy_mfcc

    comp = _flagship_params()
    gaussians = [
        scipy.stats.multivariate_normal(comp.means[i], comp.covariances[i])
        for i in range(comp.num_states)
    ]
    t0 = time.perf_counter()
    for i in range(BASELINE_CLIPS):
        feats = numpy_mfcc(signals[i])
        numpy_composite_viterbi(
            feats, gaussians, comp.log_a, comp.lowers, comp.uppers, comp.penalty
        )
    ref_dt = time.perf_counter() - t0
    ref_ups = BASELINE_CLIPS / ref_dt

    dev = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip().splitlines()
    except OSError:  # no NVIDIA driver: the device entry says what ran
        card = []
    print(
        json.dumps(
            {
                "metric": "utterances/sec (MFCC+composite Viterbi decode, "
                          f"58-state, B={BATCH}, 1.5s clips)",
                "value": round(device_ups, 2),
                "unit": "utt/s",
                "vs_baseline": round(device_ups / ref_ups, 1),
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "card": card[0] if card else None,
            }
        )
    )


if __name__ == "__main__":
    main()
