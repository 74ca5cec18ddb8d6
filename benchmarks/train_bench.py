#!/usr/bin/env python
"""Embedded-training throughput benchmark (the reference's project6 workload).

bench.py measures the serving/decode path; this measures the TRAINING hot
loop: one full embedded re-estimation iteration — sentence-HMM Viterbi
alignment of every utterance, sufficient statistics, and the M-step — over a
flagship-scale task (11 digit words x 5 states + 3-state silence, 39-dim
full-covariance Gaussians, silence-interleaved transcripts of 2-7 digits).

Device side: ContinuousTrainer._iteration (the real trainer code: jitted
_stats_pass alignment + two-pass centered covariance + host M-step).
Baseline: the reference's computational pattern for the same E-step — a
per-utterance Python trellis over the concatenated sentence states with one
frozen-scipy logpdf call per (t, state) and per-state frame pooling
(hidden_markov_model.py:584-664 drives :160-208 there; means/np.cov update
:320-350) — measured on a few utterances and extrapolated.

Prints ONE JSON line:
  {"metric": ..., "value": utt/s/iteration, "unit": "utt/s", "vs_baseline": x}
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

UTTS_PER_TRANSCRIPT = 128
FRAMES_MEAN = 150
DIM = 39
TRANSCRIPTS = ["14", "27Z", "4Z2Z", "58361", "9O4738", "14Z9O72", "6O3"]
BASELINE_CLIPS = 2


def make_models(seed: int = 0):
    from cs304_tpu.models.hmm import WordHMM, uniform_forward_log_a
    from cs304_tpu.data.ti_digits import DIGIT_LABELS

    rng = np.random.default_rng(seed)
    models = {}
    for label in sorted(list(DIGIT_LABELS) + ["S"]):
        s = 3 if label == "S" else 5
        means = rng.normal(size=(s, DIM)).astype(np.float32) * 2.0
        a = rng.normal(size=(s, DIM, 8)).astype(np.float32) * 0.1
        covs = a @ np.transpose(a, (0, 2, 1)) + 0.5 * np.eye(DIM, dtype=np.float32)
        models[label] = WordHMM(
            label=label, means=means, covariances=covs,
            log_a=uniform_forward_log_a(s),
        )
    return models


def sample_corpus(models, seed: int = 1):
    """Sample utterances from the silence-interleaved sentence models so the
    alignment runs over realistic paths (not that timing depends on it)."""
    from cs304_tpu.models.train_continuous import insert_silence

    rng = np.random.default_rng(seed)
    labeled = {}
    for transcript in TRANSCRIPTS:
        sentence = insert_silence(transcript)
        feats = []
        for _ in range(UTTS_PER_TRANSCRIPT):
            frames = []
            for word in sentence:
                m = models[word]
                dwell = rng.integers(2, 6, size=m.num_states)
                for s_i, n in enumerate(dwell):
                    mu = m.means[s_i]
                    frames.append(
                        mu + rng.normal(0, 0.7, size=(n, DIM)).astype(np.float32)
                    )
            x = np.concatenate(frames).astype(np.float32)
            feats.append(x[:FRAMES_MEAN] if len(x) > FRAMES_MEAN else x)
        labeled[transcript] = feats
    return labeled


def time_device_iteration(models, labeled, fused: bool, update: str = "viterbi"):
    """Time one full embedded-training iteration (align + stats + M-step).

    fused=True: the single-program path (models/train_fused.py, one device
    sync per iteration). fused=False: the legacy per-transcript path (2+
    dispatches per transcript per iteration). update="baum_welch" times the
    soft-count (forward-backward) variant of the same iteration."""
    import jax

    from cs304_tpu.models.train_continuous import (
        ContinuousTrainConfig,
        ContinuousTrainer,
    )

    cfg = ContinuousTrainConfig(
        max_iterations=3, silence_bootstrap=False, cov_reg=0.1,
        on_empty_state="keep", fused=fused, update=update,
    )
    trainer = ContinuousTrainer(models, cfg)
    n_utts = sum(len(v) for v in labeled.values())
    n_frames = sum(x.shape[0] for v in labeled.values() for x in v)
    if fused:
        from cs304_tpu.models.train_continuous import insert_silence
        from cs304_tpu.models.train_fused import prepare_fused_corpus

        batches = prepare_fused_corpus(
            labeled, trainer.state_counts, trainer.label_index,
            insert_silence, cfg.length_multiple,
        )

        def iteration():
            trainer._iteration_fused(batches)
            if trainer._dev_state is not None:
                jax.block_until_ready(trainer._dev_state)
    else:
        batches = trainer._prepare_batches(labeled)
        iteration = lambda: trainer._iteration(batches)

    iteration()  # compile + first stats
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        iteration()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    return n_utts / dt, n_utts, n_frames, dt


def time_device_loop(models, labeled, iters: int = 3):
    """Per-iteration time inside the whole-run lax.while_loop (zero host
    syncs between iterations — train() with no checkpoint_dir). The corpus
    is prepared/uploaded once, like the per-iteration measurements; corpus
    upload is a one-time cost either way."""
    from cs304_tpu.models.train_continuous import (
        ContinuousTrainConfig,
        ContinuousTrainer,
        insert_silence,
    )
    from cs304_tpu.models.train_fused import prepare_fused_corpus

    cfg = ContinuousTrainConfig(
        max_iterations=iters, silence_bootstrap=False, cov_reg=0.1,
        on_empty_state="keep", fused=True,
    )
    tr = ContinuousTrainer(models, cfg)
    batches = prepare_fused_corpus(
        labeled, tr.state_counts, tr.label_index, insert_silence,
        cfg.length_multiple,
    )

    init = (tr.means_g.copy(), tr.covs_g.copy(), tr.log_a_g.copy())

    def run():
        # Restore the INITIAL parameters: _train_device_loop syncs trained
        # params back into the trainer, so without this later runs would
        # start near-converged and the per-iteration figure would be
        # dominated by the fixed dispatch/readback overhead divided by 1-2
        # iterations.
        tr.means_g, tr.covs_g, tr.log_a_g = (a.copy() for a in init)
        tr._iterations_done = 0
        tr._dev_state = None
        t0 = time.perf_counter()
        n = tr._train_device_loop(batches)
        # _train_device_loop syncs the final parameters to host, so the
        # timer covers every iteration's full work (nothing left deferred).
        return (time.perf_counter() - t0) / max(n, 1)

    run()  # compile
    return min(run() for _ in range(3))


def baseline_iteration_rate(models, labeled):
    """Reference-pattern E-step+pooling on BASELINE_CLIPS utterances/transcript."""
    import scipy.stats

    from cs304_tpu.models.train_continuous import insert_silence

    t0 = time.perf_counter()
    n_done = 0
    for transcript, feats in labeled.items():
        sentence = insert_silence(transcript)
        # Concatenate word models into the sentence HMM
        # (reference hidden_markov_model.py:638-664).
        gaussians, log_a_blocks = [], []
        for word in sentence:
            m = models[word]
            for s_i in range(m.num_states):
                gaussians.append(
                    scipy.stats.multivariate_normal(
                        m.means[s_i], m.covariances[s_i]
                    )
                )
            log_a_blocks.append(m.log_a)
        s_total = len(gaussians)
        log_a = np.full((s_total, s_total), -np.inf)
        off = 0
        for blk in log_a_blocks:
            n = blk.shape[0]
            log_a[off:off + n, off:off + n] = blk
            if off + n < s_total:
                log_a[off + n - 1, off + n] = 0.0
            off += n

        pools = [[] for _ in range(s_total)]
        for x in feats[:BASELINE_CLIPS]:
            t_total = x.shape[0]
            # Python trellis, skip-2 band, one scipy logpdf per (t, state)
            # (reference hidden_markov_model.py:160-208 over the sentence).
            alpha = np.full(s_total, -np.inf)
            alpha[0] = gaussians[0].logpdf(x[0])
            tracer = np.zeros((t_total, s_total), np.int32)
            for t in range(1, t_total):
                new_alpha = np.full(s_total, -np.inf)
                for s_i in range(s_total):
                    lo = max(s_i - 2, 0)
                    cands = alpha[lo:s_i + 1] + log_a[lo:s_i + 1, s_i]
                    k = int(np.argmax(cands))
                    new_alpha[s_i] = cands[k] + gaussians[s_i].logpdf(x[t])
                    tracer[t, s_i] = lo + k
                alpha = new_alpha
            # Backtrace + frame pooling by state (signal.py:24-47 there).
            s_i = s_total - 1
            path = [s_i]
            for t in range(t_total - 1, 0, -1):
                s_i = int(tracer[t, s_i])
                path.append(s_i)
            for t, st in enumerate(reversed(path)):
                pools[st].append(x[t])
            n_done += 1
        # M-step pattern: means + np.cov per pooled state (:331-345 there).
        for pool in pools:
            if len(pool) > 1:
                arr = np.stack(pool)
                arr.mean(axis=0)
                np.cov(arr.T, ddof=1)
    dt = time.perf_counter() - t0
    return n_done / dt


def main():
    models = make_models()
    labeled = sample_corpus(models)
    fused_rate, n_utts, n_frames, dt = time_device_iteration(models, labeled, True)
    legacy_rate, _, _, legacy_dt = time_device_iteration(models, labeled, False)
    bw_rate, _, _, bw_dt = time_device_iteration(
        models, labeled, True, update="baum_welch"
    )
    loop_dt = time_device_loop(models, labeled, iters=6)
    loop_rate = n_utts / loop_dt
    base_rate = baseline_iteration_rate(models, labeled)

    # Algorithmic FLOP model of one fused iteration (same convention as
    # mfu_breakdown.py: 2 FLOPs per MAC, padded frames since padding is
    # computed too). Dominated by the all-slot emission whitening and the
    # pass-B second-moment matmul, both ~2*F*D^2 per frame.
    d = DIM
    f_slots = 11 * 5 + 3  # flagship (label, state) slots incl. padding rows
    frames_padded = sum(
        -(-max(x.shape[0] for x in v) // 32) * 32 * len(v)
        for v in labeled.values()
    )
    flop_per_iter = frames_padded * (
        2 * f_slots * d * d      # emissions: whitening matmul
        + 2 * f_slots * d * d    # pass B: (slots, frames) x (frames, D^2)
        + 2 * f_slots * (d + 1)  # pass A: counts/sums one-hot einsums
        + d * d                  # pass B: per-frame outer product
    )
    # HIGHEST matmuls run in true f32: the FP32 rate outside the tensor
    # cores (published peaks keyed by device kind, mfu_breakdown.PEAKS).
    from benchmarks.mfu_breakdown import device_peaks

    mfu = flop_per_iter / loop_dt / device_peaks()["fp32"]
    print(json.dumps({
        "metric": (
            "utterances/sec per embedded-training iteration "
            f"(12 models, {n_utts} utts x ~{FRAMES_MEAN} frames, "
            "align+stats+M-step, whole-run device loop steady state)"
        ),
        "value": round(loop_rate, 1),
        "unit": "utt/s",
        "vs_baseline": round(loop_rate / base_rate, 1),
        "device_iteration_sec": round(dt, 4),
        "legacy_path_utt_per_s": round(legacy_rate, 1),
        "legacy_iteration_sec": round(legacy_dt, 4),
        "fused_baum_welch_iteration_sec": round(bw_dt, 4),
        "device_loop_sec_per_iteration": round(loop_dt, 4),
        "gflop_per_iteration": round(flop_per_iter / 1e9, 1),
        "mfu_f32_pct": round(100 * mfu, 2),
        "baseline_utt_per_s": round(base_rate, 2),
    }))


if __name__ == "__main__":
    main()
