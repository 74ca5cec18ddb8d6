#!/usr/bin/env python
"""Phase-level timing + FLOP/byte model + roofline share for the decode
pipeline.

Where does the time in the MFCC + composite-Viterbi pipeline go, and how far
from the card's roofline is each phase? Each phase is timed as its own jitted
program with a scalar-reduced output, on device-resident inputs, ending in
block_until_ready.

Default run: the 58-state flagship at bench.py's shape. `--states-sweep` (or
`--words N`) runs the large-vocabulary breakdown at 100/200/500 words
(503/1003/2503 composite states; synthetic composites, timing does not need
trained models): quad vs whitening emissions, banded scan vs the scan-free
kernel vs the dense trellis, each against both rooflines.

FLOP accounting is algorithmic (one multiply-add = 2 FLOPs). A phase's
compute roofline uses the peak of the arithmetic its matmuls run in: true
f32 for Precision.HIGHEST (the CUDA cores' FP32 rate), three bf16 tensor-core
passes for the "high" tier, TF32 for "default"; elementwise phases (the
trellis) use the FP32 rate. Peaks are the published figures of the device in
PEAKS; a device that is not in the table is an error.

Prints one JSON object per configuration with per-phase {ms, gflop, tflops,
peak_frac, gb, gbps, hbm_frac, bound, roofline_frac}.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

BATCH = 512
SECONDS = 1.5

# Published peaks, dense, by jax device_kind. Source: NVIDIA H100 data sheet
# (SXM part, 700 W): 989 TFLOP/s bf16, 495 TF32, 67 FP32 outside the tensor
# cores, 3.35 TB/s HBM3.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "hbm": 3.35e12,
    },
}
# emission_precision tier -> (peak key, passes over that unit per FLOP).
ARITHMETIC = {"highest": ("fp32", 1), "high": ("bf16", 3),
              "default": ("tf32", 1)}


def device_peaks() -> dict:
    import jax

    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise SystemExit(f"no published peaks for device {kind!r}; add it "
                         "to PEAKS with its source")
    return PEAKS[kind]


def time_phase(fn, *args, reps: int = 10, windows: int = 3) -> float:
    """Best-window mean seconds per call."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def report_phase(peaks, dt, b_used, flop, matmul_frac, byts, tier="highest"):
    """One phase's numbers. matmul_frac: the share of `flop` that runs as
    matmuls at `tier`; the rest is elementwise FP32 work."""
    unit, passes = ARITHMETIC[tier]
    t_compute = (flop * matmul_frac * passes / peaks[unit]
                 + flop * (1.0 - matmul_frac) / peaks["fp32"])
    t_memory = byts / peaks["hbm"]
    return {
        "ms": round(dt * 1e3, 3),
        "utt_per_s": round(b_used / dt, 1),
        "gflop": round(flop / 1e9, 2),
        "tflops": round(flop / dt / 1e12, 3),
        "peak_frac": round(t_compute / dt, 4),
        "gb": round(byts / 1e9, 3),
        "gbps": round(byts / dt / 1e9, 1),
        "hbm_frac": round(byts / dt / peaks["hbm"], 4),
        "bound": "compute" if t_compute > t_memory else "bandwidth",
        "roofline_frac": round(max(t_compute, t_memory) / dt, 4),
    }


def device_entry() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def large_s(num_words: int, batch: int = 512, t_frames: int = 152) -> None:
    """Large-vocabulary phase breakdown on a synthetic composite
    (S = 5*num_words + 3), against the reference hot loop it replaces
    (hidden_markov_model.py:481-581, pure Python per (t, state))."""
    import jax
    import jax.numpy as jnp

    from cs304_tpu.models.decoder import EMISSION_PRECISION
    from cs304_tpu.models.hmm import (
        WordHMM,
        stack_word_models,
        uniform_forward_log_a,
    )
    from cs304_tpu.ops.gaussian import (
        gaussian_log_pdf,
        gaussian_log_pdf_quad,
        make_gaussian_params,
        make_gaussian_quad_params,
    )
    from cs304_tpu.ops.pallas.trellis_scanfree import (
        viterbi_composite_batch_scanfree,
    )
    from cs304_tpu.ops.viterbi import (
        viterbi_composite_batch,
        viterbi_composite_batch_fast,
    )

    peaks = device_peaks()
    d = 39
    rng = np.random.default_rng(0)
    models = [
        WordHMM(
            label=f"w{i:03d}",
            means=rng.normal(size=(5, d)).astype(np.float32),
            covariances=np.tile(np.eye(d, dtype=np.float32), (5, 1, 1)),
            log_a=uniform_forward_log_a(5),
        )
        for i in range(num_words)
    ]
    models.append(WordHMM(
        label="S", means=rng.normal(size=(3, d)).astype(np.float32),
        covariances=np.tile(np.eye(d, dtype=np.float32), (3, 1, 1)),
        log_a=uniform_forward_log_a(3),
    ))
    comp = stack_word_models(models, penalty=-100.0)
    s = int(comp.num_states)
    trellis_args = (
        jnp.asarray(comp.log_a), jnp.asarray(comp.lower_of_state),
        jnp.asarray(comp.is_entry), jnp.asarray(comp.is_exit),
        jnp.float32(comp.penalty),
    )
    means = jnp.asarray(comp.means)
    covs = jnp.asarray(comp.covariances)
    qparams = make_gaussian_quad_params(means, covs)
    wparams = make_gaussian_params(means, covs)

    feats = jax.device_put(
        rng.normal(size=(batch, t_frames, d)).astype(np.float32)
    )
    lengths = jax.device_put(np.full(batch, t_frames, np.int32))

    # Whitening emissions and the dense trellis materialize (T, S, D) and
    # (B, S, S) intermediates; keep their batch small (their cost is the
    # point being shown).
    b_small = max(batch // 8, 8)

    def emission_quad(tier):
        prec = EMISSION_PRECISION[tier]
        return jax.jit(lambda fe: jnp.sum(jax.vmap(
            lambda x: gaussian_log_pdf_quad(qparams, x, precision=prec))(fe)))

    @jax.jit
    def emission_whiten(fe):
        return jnp.sum(jax.vmap(lambda x: gaussian_log_pdf(wparams, x))(fe))

    @jax.jit
    def _logb(fe):
        return jax.vmap(lambda x: gaussian_log_pdf_quad(qparams, x))(fe)

    def trellis(impl):
        return jax.jit(lambda log_b, le: sum(
            jnp.sum(o) for o in impl(log_b, *trellis_args, le)))

    @jax.jit
    def e2e_quad_scanfree(fe, le):
        log_b = jax.vmap(lambda x: gaussian_log_pdf_quad(qparams, x))(fe)
        scores, paths = viterbi_composite_batch_scanfree(
            log_b, *trellis_args, le)
        return jnp.sum(scores) + jnp.sum(paths)

    log_b = jax.block_until_ready(_logb(feats))
    f_big = batch * t_frames
    f_small = b_small * t_frames
    quad_flop = f_big * (d * d + 2 * s * (d * d + d))
    quad_frac = 2 * s * (d * d + d) / (d * d + 2 * s * (d * d + d))
    # read feats + write/read the (T, D^2) expansion + write log_b
    quad_bytes = 4 * (f_big * d + 2 * f_big * d * d + f_big * s + s * d * d)
    trellis_flop = f_big * 10 * s
    # read log_b + write int32 backpointers + backtrace re-read
    trellis_bytes = 4 * 3 * f_big * s
    phases = {
        "emission_quad_highest": (emission_quad("highest"), (feats,), batch,
                                  quad_flop, quad_frac, quad_bytes, "highest"),
        "emission_quad_high": (emission_quad("high"), (feats,), batch,
                               quad_flop, quad_frac, quad_bytes, "high"),
        "emission_whiten": (
            emission_whiten, (feats[:b_small],), b_small,
            f_small * (2 * s * d * d + 3 * s * d),
            2 * s * d * d / (2 * s * d * d + 3 * s * d),
            # the (T, S, D) whitened intermediate is written + read
            4 * (f_small * d + 2 * f_small * s * d + f_small * s
                 + s * d * d),
            "highest",
        ),
        "trellis_fast": (trellis(viterbi_composite_batch_fast),
                         (log_b, lengths), batch, trellis_flop, 0.0,
                         trellis_bytes, "highest"),
        "trellis_scanfree": (trellis(viterbi_composite_batch_scanfree),
                             (log_b, lengths), batch, trellis_flop, 0.0,
                             trellis_bytes, "highest"),
        "e2e_quad_scanfree": (
            e2e_quad_scanfree, (feats, lengths), batch,
            quad_flop + trellis_flop,
            quad_flop * quad_frac / (quad_flop + trellis_flop),
            quad_bytes + trellis_bytes, "highest",
        ),
    }
    if s * s * b_small * 4 * 3 < 12e9:
        phases["trellis_dense"] = (
            trellis(viterbi_composite_batch),
            (log_b[:b_small], lengths[:b_small]), b_small,
            f_small * 4 * s * s, 0.0,
            4 * (2 * f_small * s * s + 2 * f_small * s), "highest",
        )

    report = {
        "num_words": num_words, "states": s, "batch": batch,
        "frames_per_utt": t_frames, "device": device_entry(),
    }
    for name, (fn, args_, b_used, flop, frac, byts, tier) in phases.items():
        dt = time_phase(fn, *args_, reps=5)
        report[name] = report_phase(peaks, dt, b_used, flop, frac, byts, tier)
    print(json.dumps(report, indent=2))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from bench import device_pipeline, make_signals
    from __graft_entry__ import _flagship_params
    from cs304_tpu.models.decoder import auto_backend
    from cs304_tpu.ops.gaussian import (
        gaussian_log_pdf_quad,
        make_gaussian_quad_params,
    )
    from cs304_tpu.ops.mfcc import MFCCConfig, mfcc_features
    from cs304_tpu.ops.pallas.trellis_scanfree import (
        viterbi_composite_batch_scanfree,
    )
    from cs304_tpu.ops.viterbi import viterbi_composite_batch_fast

    peaks = device_peaks()
    comp = _flagship_params()
    cfg = MFCCConfig()
    qparams = make_gaussian_quad_params(jnp.asarray(comp.means),
                                        jnp.asarray(comp.covariances))
    trellis_args = (
        jnp.asarray(comp.log_a), jnp.asarray(comp.lower_of_state),
        jnp.asarray(comp.is_entry), jnp.asarray(comp.is_exit),
        jnp.float32(comp.penalty),
    )

    signals = make_signals(BATCH, SECONDS)
    n = signals.shape[1]
    sj = jax.device_put(signals)
    nj = jax.device_put(np.full(BATCH, n, np.int32))

    s = int(comp.num_states)
    d = 39
    t_frames = n // cfg.hop_length + 1
    n_bins = cfg.n_fft // 2 + 1

    @jax.jit
    def mfcc_only(sig, ns):
        feats, n_frames = jax.vmap(lambda x, m: mfcc_features(x, m, cfg))(sig, ns)
        return jnp.sum(feats) + jnp.sum(n_frames)

    @jax.jit
    def emission_only(feats):
        return jnp.sum(jax.vmap(
            lambda x: gaussian_log_pdf_quad(qparams, x))(feats))

    def trellis(impl):
        return jax.jit(lambda log_b, le: sum(
            jnp.sum(o) for o in impl(log_b, *trellis_args, le)))

    decode = device_pipeline()

    @jax.jit
    def end_to_end(sig, ns):
        """The serving pipeline exactly as bench.py runs it."""
        scores, paths = decode(sig, ns)
        return jnp.sum(scores) + jnp.sum(paths)

    feats, n_frames = jax.jit(jax.vmap(
        lambda x, m: mfcc_features(x, m, cfg)))(sj, nj)
    log_b = jax.block_until_ready(jax.jit(jax.vmap(
        lambda x: gaussian_log_pdf_quad(qparams, x)))(feats))

    f = BATCH * t_frames
    dft = 2 * 2 * cfg.n_fft * n_bins
    mfcc_flop = f * (dft + 3 * n_bins + 2 * n_bins * cfg.n_mels
                     + 2 * cfg.n_mels * cfg.n_mfcc
                     + 6 * cfg.n_mfcc * cfg.delta_width + 12 * cfg.n_mfcc)
    quad_per_frame = d * d + 2 * s * (d * d + d)
    trellis_flop = f * 10 * s
    phases = {
        "mfcc": (mfcc_only, (sj, nj), mfcc_flop, f * dft / mfcc_flop,
                 4 * (BATCH * n + f * (n_bins + d))),
        "emission": (emission_only, (feats,), f * quad_per_frame,
                     2 * s * (d * d + d) / quad_per_frame,
                     4 * (f * d + 2 * f * d * d + f * s)),
        "trellis_fast": (trellis(viterbi_composite_batch_fast),
                         (log_b, n_frames), trellis_flop, 0.0, 4 * 3 * f * s),
        "trellis_scanfree": (trellis(viterbi_composite_batch_scanfree),
                             (log_b, n_frames), trellis_flop, 0.0,
                             4 * 3 * f * s),
    }
    report = {"batch": BATCH, "frames_per_utt": t_frames, "states": s,
              "device": device_entry()}
    times = {}
    for name, (fn, args_, flop, frac, byts) in phases.items():
        times[name] = time_phase(fn, *args_)
        report[name] = report_phase(peaks, times[name], BATCH, flop, frac,
                                    byts)
    t_e2e = time_phase(end_to_end, sj, nj)
    report["end_to_end"] = {"ms": round(t_e2e * 1e3, 3),
                            "utt_per_s": round(BATCH / t_e2e, 1)}
    trellis_name = f"trellis_{auto_backend()}"
    sum_phases = times["mfcc"] + times["emission"] + times[trellis_name]
    report["phase_sum_vs_e2e"] = round(sum_phases / t_e2e, 3)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--states-sweep", action="store_true",
                    help="large-vocabulary breakdown at 100/200/500 words "
                         "(503/1003/2503 states) instead of the flagship")
    ap.add_argument("--words", type=int, default=None,
                    help="single large-vocabulary size (number of words)")
    ap.add_argument("--batch", type=int, default=512)
    a = ap.parse_args()
    if a.words is not None:
        large_s(a.words, batch=a.batch)
    elif a.states_sweep:
        for w in (100, 200, 500):
            large_s(w, batch=a.batch)
    else:
        main()
