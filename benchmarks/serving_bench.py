#!/usr/bin/env python
"""End-to-end serving-session capacity: raw audio -> endpointed transcripts.

Feeds N concurrent sessions 100 ms audio chunks round-robin through
ServingSessionPool (per-session endpointing + optional streaming partials +
batched offline-parity finals) and reports the real-time factor: how many
live microphones one process sustains. Unlike streaming_bench.py (device
trellis only), this includes the HOST work — the per-frame endpointing state
machine and the causal front-end — which is the expected bottleneck at high
session counts.
"""
import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def run(num_sessions: int, seconds: float, partials: bool,
        poll_partials: bool, steady: bool = False,
        checkpoint_dir: str | None = None) -> dict:
    """steady=True runs the measurement window twice and reports the second
    — the finals decode programs compile per (batch, length) bucket and the
    buckets only emerge as utterances endpoint, so a first window includes
    one-time compiles."""
    from cs304_tpu.data.synthetic import SyntheticTIDigits
    from cs304_tpu.serving import ServingSessionPool
    from cs304_tpu.utils.checkpoint import load_models

    models = load_models(checkpoint_dir) if checkpoint_dir else None
    if models is None:
        # Fall back to quickly-trained boot models (capacity is shape-bound,
        # not accuracy-bound).
        from cs304_tpu.data.ti_digits import DIGIT_LABELS
        from cs304_tpu.models.train_kmeans import (
            SegmentalKMeansConfig,
            train_digit_models,
            train_word_hmm,
        )
        from cs304_tpu.audio.endpointing import SignalSeparation
        from cs304_tpu.ops.mfcc import mfcc_batch

        corpus0 = SyntheticTIDigits(num_train_speakers=2, num_test_speakers=1,
                                    takes_per_digit=2)
        sep = SignalSeparation()
        feats = {l: mfcc_batch(sep.remove_empty_batch(corpus0.train_dataset[l]))
                 for l in DIGIT_LABELS}
        models = train_digit_models(feats, SegmentalKMeansConfig(
            num_states=5, max_iterations=4, length_multiple=32))
        noises = [n for n in sep.get_all_noises()
                  if len(n) >= 9 * sep.frame_size]
        models["S"] = train_word_hmm("S", mfcc_batch(noises),
                                     SegmentalKMeansConfig(
                                         num_states=3, max_iterations=4,
                                         length_multiple=32)).model

    corpus = SyntheticTIDigits(num_train_speakers=6, num_test_speakers=2,
                               takes_per_digit=3)
    rng = np.random.default_rng(0)
    sr = 16000
    transcripts = ["375", "186Z", "54321", "12", "9O2", "4Z"]

    def session_audio(i):
        pieces = [rng.normal(0, 20.0, int(0.3 * sr)).astype(np.float32)]
        for j in range(2):
            tr = transcripts[(i + j) % len(transcripts)]
            pieces.append(corpus.sentence_audio(tr, i % 6, jitter_seed=j))
            pieces.append(
                rng.normal(0, 20.0, int(0.4 * sr)).astype(np.float32)
            )
        audio = np.concatenate(pieces)
        return audio[: int(seconds * sr)]

    audio = {i: session_audio(i) for i in range(num_sessions)}
    pool = ServingSessionPool(
        models, num_slots=max(4, num_sessions), partials=partials,
    )
    sessions = {i: pool.open() for i in range(num_sessions)}
    chunk = int(0.1 * sr)

    # Warmup: drive one COMPLETE utterance through a scratch session so the
    # streaming step, finalize, and the finals decode program all compile
    # before the clock starts (otherwise the first config measured pays the
    # compiles and later configs in the same process look spuriously fast).
    scratch = pool.open()
    warm = np.concatenate([
        corpus.sentence_audio("375", 0),
        rng.normal(0, 20.0, int(0.4 * sr)).astype(np.float32),
    ])
    for off in range(0, len(warm), chunk):
        done = pool.feed({scratch: warm[off : off + chunk]})
        pool.partials([scratch])
    pool.close(scratch)

    def window():
        count = 0
        cursors = {i: 0 for i in range(num_sessions)}
        t0 = time.perf_counter()
        while any(cursors[i] < len(audio[i]) for i in range(num_sessions)):
            step = {}
            for i in range(num_sessions):
                if cursors[i] < len(audio[i]):
                    step[sessions[i]] = (
                        audio[i][cursors[i] : cursors[i] + chunk]
                    )
                    cursors[i] += chunk
            done = pool.feed(step)
            count += sum(len(v) for v in done.values())
            if poll_partials:
                pool.partials()
        return time.perf_counter() - t0, count

    dt, finals = window()
    if steady:
        for i in range(num_sessions):
            pool.close(sessions[i])
        sessions = {i: pool.open() for i in range(num_sessions)}
        dt, finals = window()
    audio_seconds = sum(len(a) for a in audio.values()) / sr
    # Aggregate throughput: total audio-seconds processed per wall-second.
    # A live microphone produces exactly 1 audio-second per second, so this
    # IS the number of concurrent real-time sessions one process sustains
    # (at this batching granularity). NOT multiplied by the session count —
    # an earlier revision double-counted and inflated the number ~16x.
    realtime = audio_seconds / dt
    return {
        "sessions": num_sessions,
        "partials": partials,
        "poll_partials": poll_partials,
        "audio_s": round(audio_seconds, 1),
        "wall_s": round(dt, 2),
        "finals": finals,
        "realtime_sessions": int(realtime),
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sessions", type=int, nargs="*", default=[16, 64])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="trained models to serve (default: boot models "
                        "trained here on the synthetic corpus)")
    p.add_argument("--steady", action="store_true",
                   help="report the second measurement window (first pays "
                        "one-time compiles of the finals buckets)")
    args = p.parse_args()
    best = None
    for n in args.sessions:
        for partials, poll in ((False, False), (True, True)):
            r = run(n, args.seconds, partials, poll, steady=args.steady,
                    checkpoint_dir=args.checkpoint_dir)
            print(json.dumps(r))
            if not partials and (
                best is None or r["realtime_sessions"] > best
            ):
                best = r["realtime_sessions"]
    print(json.dumps({
        "metric": "real-time serving sessions (audio->endpointed "
                  "transcripts, finals only)",
        "value": best,
        "unit": "sessions",
    }))


if __name__ == "__main__":
    main()
