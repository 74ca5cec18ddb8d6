#!/usr/bin/env python
"""Smoke run of the recognizer on an NVIDIA GPU, end to end, in one process.

    python chip_smoke.py           # phases 1-6 on one GPU
    python chip_smoke.py --four    # only the data-parallel path, on 4 GPUs

Phases (one GPU): device; the trellis kernel against the XLA scan at real
widths (B=512, T=151, S=58 and S=5003) plus the tests marked `gpu`; boot +
fused embedded training of the 58-state digit system on the synthetic
corpus; held-out decoding through ContinuousDecoder; concurrent
ServingSessionPool sessions; the bench.py decode program.

The model is the flagship at full width: 11 digit words x 5 states + a
3-state silence model = 58 composite states, 39-dim full-covariance
Gaussians, trained from a seeded synthetic TI-Digits corpus.

Every time is printed with the card's name and power limit. Any failure
raises: the process exits non-zero and prints no result line. The last line
of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DIGITS = "123456789OZ"
TRAIN_TRANSCRIPTS = ["12", "4Z", "375", "9O2", "186Z", "54321", "7", "O8"]
CARD = ""


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok, what) -> None:
    """Fail the run (unlike assert, this survives python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def timed(label: str, fn, *args, reps: int = 5):
    """Best wall time of `reps` calls after one warm-up; every output is
    waited for with block_until_ready."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    say(f"  {label}: {best * 1e3:.3f} ms  [{CARD}]")
    return out, best


def composite(num_words: int, seed: int = 0):
    """Random words x 5 states + a 3-state silence, 39-dim Gaussians."""
    from cs304_tpu.models.hmm import (
        WordHMM,
        stack_word_models,
        uniform_forward_log_a,
    )

    rng = np.random.default_rng(seed)
    models = []
    for i in range(num_words + 1):
        s = 3 if i == num_words else 5
        a = rng.normal(size=(s, 39, 8)).astype(np.float32) * 0.1
        models.append(WordHMM(
            label="S" if i == num_words else f"w{i:04d}",
            means=rng.normal(size=(s, 39)).astype(np.float32),
            covariances=a @ np.transpose(a, (0, 2, 1))
            + 0.5 * np.eye(39, dtype=np.float32),
            log_a=uniform_forward_log_a(s),
        ))
    return stack_word_models(models, penalty=-100.0)


# -- phase 1 ----------------------------------------------------------------

def phase_device(count: int):
    global CARD
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX computes on {jax.default_backend()!r}, not a GPU"
        )
    devices = jax.devices()
    if len(devices) < count:
        raise SystemExit(
            f"chip_smoke: {count} GPUs needed, JAX sees {len(devices)}"
        )
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("phase 1 device")
    say(CARD)
    say(f"  jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    return devices


# -- phase 2 ----------------------------------------------------------------

def phase_kernels() -> None:
    import jax
    import jax.numpy as jnp
    import pytest

    from cs304_tpu.ops.gaussian import (
        gaussian_log_pdf,
        gaussian_log_pdf_quad,
        make_gaussian_params,
        make_gaussian_quad_params,
    )
    from cs304_tpu.ops.pallas.trellis_scanfree import (
        viterbi_composite_batch_scanfree,
    )
    from cs304_tpu.ops.viterbi import viterbi_composite_batch_fast
    from cs304_tpu.models.decoder import EMISSION_PRECISION

    say("phase 2 kernels at real widths")
    fast = jax.jit(viterbi_composite_batch_fast)
    kernel = jax.jit(viterbi_composite_batch_scanfree)
    for b, t, words in ((512, 151, 11), (512, 151, 1000)):
        comp = composite(words)
        s = comp.num_states
        rng = np.random.default_rng(0)
        frames = jnp.asarray(rng.normal(size=(b, t, 39)).astype(np.float32))
        lengths = jnp.asarray(np.r_[np.full(b // 2, t),
                                    rng.integers(2, t + 1, size=b - b // 2)]
                              .astype(np.int32))
        qp = make_gaussian_quad_params(jnp.asarray(comp.means),
                                       jnp.asarray(comp.covariances))
        say(f" B={b} T={t} S={s}")
        emitted = {}
        for tier in ("highest", "high"):
            emit = jax.jit(lambda x, p=EMISSION_PRECISION[tier]: jax.vmap(
                lambda f: gaussian_log_pdf_quad(qp, f, precision=p))(x))
            emitted[tier], _ = timed(f"emissions quad/{tier} (XLA)", emit,
                                     frames)
        log_b = emitted["highest"]
        wp = make_gaussian_params(jnp.asarray(comp.means),
                                  jnp.asarray(comp.covariances))
        whiten = jax.jit(jax.vmap(lambda f: gaussian_log_pdf(wp, f)))
        if s < 1000:
            # At S=5003 the (B, T, S, D) whitened intermediate is ~60 GB.
            timed("emissions whiten/highest (XLA)", whiten, frames)
        # The quad form's contract: at HIGHEST within 1e-2 absolute of the
        # whitening form (the expanded quadratic's cancellation residual).
        # The "high" tier is judged by decode agreement, so it is printed.
        ref = np.asarray(whiten(frames[:16]))
        for tier in ("highest", "high"):
            err = float(np.abs(np.asarray(emitted[tier][:16]) - ref).max())
            say(f"  quad/{tier} vs whiten/highest: max abs diff {err:.3g} "
                f"(log-densities down to {ref.min():.4g})")
            check(tier != "highest" or err <= 1e-2, err)
        args = (jnp.asarray(comp.log_a), jnp.asarray(comp.lower_of_state),
                jnp.asarray(comp.is_entry), jnp.asarray(comp.is_exit),
                jnp.float32(comp.penalty), lengths)
        (ref_s, ref_p), t_fast = timed("trellis XLA scan (fast)", fast,
                                       log_b, *args)
        (got_s, got_p), t_kern = timed("trellis kernel (scanfree)", kernel,
                                       log_b, *args)
        same = (np.array_equal(np.asarray(ref_s), np.asarray(got_s))
                and np.array_equal(np.asarray(ref_p), np.asarray(got_p)))
        say(f"  kernel bitwise == scan: {same}; speedup "
            f"{t_fast / t_kern:.2f}x")
        check(same, f"kernel differs from the scan at S={s}")
        for name, fn in (("scan", fast), ("kernel", kernel)):
            mem = fn.lower(log_b, *args).compile().memory_analysis()
            say(f"  memory_analysis {name}: {mem}")
    say(" tests marked gpu:")
    os.environ["CS304_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", REPO,
                      os.path.join(REPO, "tests", "test_pallas_scanfree.py")])
    check(rc == 0, f"gpu tests failed (pytest exit {rc})")


# -- phase 3 ----------------------------------------------------------------

def train_system(speakers: int = 6, iterations: int = 4, mesh=None,
                 boot=None):
    """Segmental k-means boot, then fused embedded training. Returns
    (corpus, boot models, trainer)."""
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

    corpus = SyntheticTIDigits(num_train_speakers=speakers,
                               num_test_speakers=2, takes_per_digit=3)
    if boot is None:
        sep = SignalSeparation()
        feats = {
            lab: mfcc_batch(sep.remove_empty_batch(corpus.train_dataset[lab]))
            for lab in DIGIT_LABELS
        }
        kcfg = dict(max_iterations=15, length_multiple=32)
        boot = train_digit_models(
            feats, SegmentalKMeansConfig(num_states=5, **kcfg))
        noises = [n for n in sep.get_all_noises()
                  if len(n) >= 9 * sep.frame_size]
        boot["S"] = train_word_hmm(
            "S", mfcc_batch(noises),
            SegmentalKMeansConfig(num_states=3, **kcfg),
        ).model
    labeled = {
        tr: mfcc_batch([corpus.sentence_audio(tr, spk, jitter_seed=take)
                        for spk in range(speakers) for take in range(3)])
        for tr in TRAIN_TRANSCRIPTS
    }
    trainer = ContinuousTrainer(
        dict(boot),
        ContinuousTrainConfig(max_iterations=iterations, length_multiple=64,
                              cov_reg=0.1),
        mesh=mesh,
    )
    trainer.train(labeled)
    return corpus, boot, trainer


def phase_train():
    say("phase 3 train")
    t0 = time.perf_counter()
    corpus, _boot, trainer = train_system()
    models = trainer.models()
    for name in ("means_g", "covs_g"):
        arr = getattr(trainer, name)
        check(np.isfinite(arr).all(), f"non-finite {name}")
    check(not trainer.last_empty_slots, trainer.last_empty_slots)
    states = sum(m.means.shape[0] for m in models.values())
    say(f"  {len(models)} models, {states} states, "
        f"{trainer._iterations_done} embedded iterations, no empty state; "
        f"boot+train {time.perf_counter() - t0:.1f} s  [{CARD}]")
    check(states == 58, states)
    return corpus, models


# -- phase 4 ----------------------------------------------------------------

def held_out(corpus, n: int = 48, seed: int = 5):
    rng = np.random.default_rng(seed)
    test_speakers = range(corpus.num_train_speakers,
                          corpus.num_train_speakers + corpus.num_test_speakers)
    out = []
    for i in range(n):
        tr = "".join(rng.choice(list(DIGITS), size=int(rng.integers(1, 8))))
        spk = test_speakers[i % len(test_speakers)]
        out.append((tr, corpus.sentence_audio(tr, spk, jitter_seed=100 + i)))
    return out


def phase_decode(corpus, models):
    from cs304_tpu.models.decoder import ContinuousDecoder
    from cs304_tpu.ops.mfcc import mfcc_batch

    say("phase 4 decode")
    sentences = held_out(corpus)
    truth = [tr for tr, _ in sentences]
    feats = mfcc_batch([sig for _, sig in sentences])
    routes = {
        "auto": ContinuousDecoder(models),
        "auto+quad": ContinuousDecoder(models, emissions="quad"),
        "scan/whiten": ContinuousDecoder(models, backend="scan",
                                         emissions="whiten"),
    }
    check(routes["auto"].backend == "scanfree", routes["auto"].backend)
    hyps = {}
    for name, dec in routes.items():
        dec.predict_batch(feats)  # compile
        t0 = time.perf_counter()
        hyps[name] = dec.predict_batch(feats)
        dt = time.perf_counter() - t0
        acc = np.mean([h == r for h, r in zip(hyps[name], truth)])
        say(f"  {name} (backend {dec.backend}): exact-sequence {acc:.4f} on "
            f"{len(truth)} held-out sentences, {dt * 1e3:.1f} ms  [{CARD}]")
        check(acc >= 0.85, f"{name}: exact-sequence {acc} < 0.85")
    for name in ("auto", "auto+quad"):
        agree = np.mean([a == b for a, b in
                         zip(hyps[name], hyps["scan/whiten"])])
        say(f"  agreement {name} vs scan/whiten (f32 parity path): "
            f"{agree:.4f}")
        check(agree >= 0.95, f"{name} agrees {agree} with the parity path")
    return sentences


# -- phase 5 ----------------------------------------------------------------

def phase_serve(corpus, models, sentences, sessions: int = 4):
    from cs304_tpu.audio.capture import Segmentation, SegmentationDone
    from cs304_tpu.models.decoder import ContinuousDecoder
    from cs304_tpu.ops.mfcc import mfcc_batch
    from cs304_tpu.serving import ServingSessionPool

    say("phase 5 serve")
    rng = np.random.default_rng(9)

    def silence(sec):
        return rng.normal(0, 20.0, int(sec * 16000)).astype(np.float32)

    audio, expected = {}, {}
    offline = ContinuousDecoder(models, penalty=-100.0)
    pool = ServingSessionPool(models, num_slots=2 * sessions)
    for i in range(sessions):
        _, sig = sentences[i]
        stream = np.concatenate([silence(0.3), sig, silence(0.6)])
        seg = Segmentation(stream=None)
        seg.audio_cache.put(stream)
        try:
            seg.routine()
        except SegmentationDone:
            pass
        endpointed = seg.result_signal()
        expected[i] = (offline.predict(mfcc_batch([endpointed])[0]),
                       len(endpointed))
        audio[pool.open()] = stream
    finals = {s: [] for s in audio}
    cursor = 0
    t0 = time.perf_counter()
    rounds = 0
    while any(cursor < len(a) for a in audio.values()):
        step = {s: a[cursor:cursor + 1600] for s, a in audio.items()
                if cursor < len(a)}
        cursor += 1600
        rounds += 1
        for s, results in pool.feed(step).items():
            finals[s].extend(results)
        pool.partials(list(audio))
    dt = time.perf_counter() - t0
    for i, s in enumerate(audio):
        got = [(r.text, r.num_samples) for r in finals[s]]
        say(f"  session {s}: final {got} offline {expected[i]}")
        check(got == [expected[i]], (got, expected[i]))
    say(f"  {sessions} sessions, {rounds} feed rounds of 0.1 s, "
        f"{dt:.2f} s wall; every final == offline decode  [{CARD}]")


# -- phase 6 ----------------------------------------------------------------

def phase_bench() -> None:
    """The bench.py decode program, compiled: once with the trellis kernel
    (what backend="auto" resolves to on the GPU) and once with the XLA scan,
    timed end to end on the same inputs."""
    import jax

    sys.path.insert(0, REPO)
    import bench

    say("phase 6 bench.py decode program")
    signals = bench.make_signals(bench.BATCH, bench.SECONDS)
    num_samples = np.full(bench.BATCH, signals.shape[1], np.int32)
    sj, nj = jax.device_put(signals), jax.device_put(num_samples)
    results, times = {}, {}
    for backend in ("scanfree", "fast"):
        decode = bench.device_pipeline(backend)
        compiled = decode.lower(sj, nj).compile()
        triton = "__gpu$xla.gpu.triton" in compiled.as_text()
        say(f"  {backend}: Triton kernel custom call in the compiled HLO: "
            f"{triton}; memory_analysis: {compiled.memory_analysis()}")
        check(triton == (backend == "scanfree"), (backend, triton))
        results[backend], times[backend] = timed(
            f"bench.py decode ({backend}), B={bench.BATCH} x "
            f"{bench.SECONDS} s", decode, sj, nj)
        say(f"  {backend}: {bench.BATCH / times[backend]:.1f} "
            f"utterances/s  [{CARD}]")
    (scores, paths), (ref_scores, ref_paths) = (results["scanfree"],
                                                results["fast"])
    check(np.isfinite(np.asarray(scores)).all(), "non-finite scores")
    check(np.asarray(paths).shape == (bench.BATCH, 151), paths.shape)
    same = (np.array_equal(np.asarray(scores), np.asarray(ref_scores))
            and np.array_equal(np.asarray(paths), np.asarray(ref_paths)))
    say(f"  kernel route == scan route bitwise: {same}; end-to-end speedup "
        f"{times['fast'] / times['scanfree']:.2f}x")
    check(same, "kernel route differs from the scan route")


# -- four GPUs ----------------------------------------------------------------

def phase_four(devices) -> None:
    """Mesh-sharded fused training, dp_composite_decode and the sharded
    BatchedStreamingComposite on four GPUs, each against the same work on
    one device."""
    import jax
    import jax.numpy as jnp

    from cs304_tpu.data.batching import pad_batch
    from cs304_tpu.models.decoder import ContinuousDecoder
    from cs304_tpu.ops.mfcc import mfcc_batch
    from cs304_tpu.ops.streaming_batch import BatchedStreamingComposite
    from cs304_tpu.parallel.data_parallel import (
        DATA_AXIS,
        dp_composite_decode,
        make_mesh,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(devices[:4])
    say(f"phase four: mesh {dict(mesh.shape)} over "
        f"{[d.id for d in devices[:4]]}")

    t0 = time.perf_counter()
    corpus, boot, single = train_system(speakers=4)
    t1 = time.perf_counter()
    _c, _b, sharded = train_system(speakers=4, mesh=mesh, boot=boot)
    t2 = time.perf_counter()
    check(single._iterations_done == sharded._iterations_done,
          "sharded training ran another number of iterations")
    # The tolerances of tests/test_parallel.py: the psum adds the statistics
    # in another order, and covariances amplify that through the centered
    # second moments.
    for name, rtol, atol in (("means_g", 1e-4, 1e-4), ("covs_g", 5e-2, 5e-3),
                             ("log_a_g", 1e-4, 1e-4)):
        x, y = getattr(single, name), getattr(sharded, name)
        check((np.isfinite(x) == np.isfinite(y)).all(), name)
        fin = np.isfinite(x)
        np.testing.assert_allclose(y[fin], x[fin], rtol=rtol, atol=atol,
                                   err_msg=name)
        say(f"  fused training {name}: sharded == single within rtol {rtol} "
            f"atol {atol} (max abs diff "
            f"{float(np.abs(y[fin] - x[fin]).max()):.3g})")
    say(f"  single {t1 - t0:.1f} s, 4-way {t2 - t1:.1f} s, each with its "
        f"corpus and compiles  [{CARD}]")

    models = single.models()
    sentences = held_out(corpus, n=32)
    feats = mfcc_batch([sig for _, sig in sentences])
    dec = ContinuousDecoder(models, backend="scan")
    c = dec.composite
    padded = pad_batch(feats, 128)
    shard = NamedSharding(mesh, P(DATA_AXIS))
    params = (jnp.asarray(c.means), jnp.asarray(c.covariances),
              jnp.asarray(c.log_a), jnp.asarray(c.lower_of_state),
              jnp.asarray(c.is_entry), jnp.asarray(c.is_exit),
              jnp.float32(c.penalty))
    s4, p4 = dp_composite_decode(*params, jax.device_put(padded.data, shard),
                                 jax.device_put(padded.lengths, shard), mesh)
    s1, p1, _lengths = dec.viterbi_batch(list(feats), bucket=False)
    same = np.array_equal(np.asarray(p4), p1)
    say(f"  dp_composite_decode paths == single-device decode: {same}")
    check(same, "sharded decode paths differ")
    np.testing.assert_allclose(np.asarray(s4), s1, rtol=1e-5)

    def stream(mesh_arg):
        pool = BatchedStreamingComposite.from_models(
            models, penalty=-100.0, num_slots=8, chunk_size=32,
            max_frames=512, mesh=mesh_arg,
        )
        slots = [pool.start() for _ in range(8)]
        for start in range(0, padded.data.shape[1], 32):
            pool.step({s: feats[i][start:start + 32]
                       for i, s in enumerate(slots)
                       if start < feats[i].shape[0]})
        return pool.finalize(slots)

    got, ref = stream(mesh), stream(None)
    same = all(got[s][1] == ref[s][1] for s in ref)
    say(f"  sharded BatchedStreamingComposite texts == single: {same} "
        f"({[got[s][1] for s in sorted(got)]})")
    check(same, "sharded streaming texts differ")
    for s in ref:
        check(abs(got[s][0] - ref[s][0]) <= 1e-5 * abs(ref[s][0]) + 1e-3,
              (got[s][0], ref[s][0]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the data-parallel path, on four GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from cs304_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = phase_device(4 if args.four else 1)
    if args.four:
        phase_four(devices)
    else:
        phase_kernels()
        corpus, models = phase_train()
        sentences = phase_decode(corpus, models)
        phase_serve(corpus, models, sentences)
        phase_bench()
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
