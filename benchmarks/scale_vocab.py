#!/usr/bin/env python
"""Vocabulary-scale study: the FULL pipeline at 100+ words.

Everything else in this repo was validated at the reference's 11-word digit
task (58 composite states; reference ti_digits.py:13-26). This benchmark
proves the framework past it: a generated NUM_WORDS vocabulary over a shared
phone inventory (data/wordvocab.py) runs the complete loop —

  1. boot      silence-stripped batched isolated k-means (NUM_WORDS models
               + 3-state silence) — one vmapped program over all labels
  2. embedded  fused continuous training on multi-word sentences
               (tuple transcripts; slot tables at NUM_WORDS+1 labels)
  3. decode    composite decoding at S = 5*NUM_WORDS + 3 states on held-out
               speakers: exact-sequence accuracy GATE + throughput, with a
               beam-pruned decode A/B (ops/viterbi beam arg)
  4. serving   batched streaming pool at the same S (int32 backpointer
               ring — ring_dtype flips past 127 states): per-stream
               STREAMED == OFFLINE parity gate + real-time capacity

Each stage prints one JSON line; the last line is the bench-style summary.
Run on the GPU for timings; CPU works for the gates (slow).
"""
import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

FRAME_RATE = 100.0  # 16 kHz / 160-sample hop

GATE_TEST = 0.85  # north-star level (reference README.md:9)


def build_corpus(args):
    from cs304_tpu.data.wordvocab import make_word_corpus

    return make_word_corpus(
        args.num_words,
        hard=args.hard,
        num_train_speakers=args.train_speakers,
        num_test_speakers=args.test_speakers,
        takes_per_digit=args.takes,
    )


def make_transcripts(labels, count, lengths, seed, cover_all=True):
    """Distinct random transcripts; cover_all guarantees every label occurs.

    Uniform sampling under-covers: 60 transcripts x mean length 3 over 101
    labels leaves each label absent with p = (1-1/101)^180 ~ 0.17, i.e. ~17
    whole labels never seen by embedded training — the measured ~14 frozen
    labels of VERDICT r4 item #4. The coverage prefix chunks one shuffled
    pass over the vocabulary into transcripts first (every label appears at
    least once), then fills the remaining count uniformly as before."""
    rng = np.random.default_rng(seed)
    out = []
    seen = set()
    if cover_all:
        perm = [str(w) for w in rng.permutation(labels)]
        i = 0
        while i < len(perm) and len(out) < count:
            n = int(rng.choice(lengths))
            chunk = perm[i : i + n]
            i += n
            if len(chunk) < n:  # tail: fill up from the full vocabulary
                chunk = chunk + [
                    str(w)
                    for w in rng.choice(labels, size=n - len(chunk))
                ]
            tr = tuple(chunk)
            if tr not in seen:
                seen.add(tr)
                out.append(tr)
    while len(out) < count:
        n = int(rng.choice(lengths))
        tr = tuple(str(w) for w in rng.choice(labels, size=n))
        if tr not in seen:
            seen.add(tr)
            out.append(tr)
    return out


def boot_stage(corpus, mcfg):
    from cs304_tpu.audio.endpointing import SignalSeparation
    from cs304_tpu.models.train_kmeans import (
        SegmentalKMeansConfig,
        train_digit_models,
        train_word_hmm,
    )
    from cs304_tpu.ops.mfcc import mfcc_batch

    t0 = time.perf_counter()
    sep = SignalSeparation()
    feats = {
        l: mfcc_batch(sep.remove_empty_batch(corpus.train_dataset[l]),
                      cfg=mcfg)
        for l in corpus.labels
    }
    t_feat = time.perf_counter() - t0
    t0 = time.perf_counter()
    boot = train_digit_models(
        feats,
        SegmentalKMeansConfig(num_states=5, max_iterations=12,
                              length_multiple=32),
    )
    noises = [n for n in sep.get_all_noises() if len(n) >= 9 * sep.frame_size]
    boot["S"] = train_word_hmm(
        "S", mfcc_batch(noises, cfg=mcfg),
        SegmentalKMeansConfig(num_states=3, max_iterations=12,
                              length_multiple=32),
    ).model
    t_boot = time.perf_counter() - t0
    n_clips = sum(len(corpus.train_dataset[l]) for l in corpus.labels)
    print(json.dumps({
        "stage": "boot", "labels": len(boot), "clips": n_clips,
        "feature_s": round(t_feat, 1), "kmeans_s": round(t_boot, 1),
    }))
    return boot


def train_stage(corpus, boot, transcripts, mcfg, args):
    from cs304_tpu.models.train_continuous import (
        ContinuousTrainConfig,
        ContinuousTrainer,
    )
    from cs304_tpu.ops.mfcc import mfcc_batch

    speakers = range(args.train_speakers)
    labeled = {
        tr: mfcc_batch(
            [corpus.sentence_audio(tr, spk, jitter_seed=take)
             for spk in speakers for take in range(args.sentence_takes)],
            cfg=mcfg,
        )
        for tr in transcripts
    }
    n_utts = sum(len(v) for v in labeled.values())
    trainer = ContinuousTrainer(
        boot,
        ContinuousTrainConfig(max_iterations=args.train_iterations,
                              cov_reg=0.1),
    )
    t0 = time.perf_counter()
    iters = trainer.train(labeled)
    dt = time.perf_counter() - t0
    covered = len({w for tr in transcripts for w in tr})
    print(json.dumps({
        "stage": "embedded_training", "labels": len(boot),
        "transcripts": len(transcripts), "utterances": n_utts,
        "labels_in_transcripts": covered,
        "empty_slots": len(trainer.last_empty_slots),
        "frozen_labels": trainer.last_frozen_labels,
        "iterations": iters, "wall_s": round(dt, 1),
        "s_per_iteration": round(dt / max(iters, 1), 2),
    }))
    if trainer.last_frozen_labels:
        print(json.dumps({
            "warning": "whole labels kept boot params through embedded "
                       "training", "labels": trainer.last_frozen_labels,
        }))
    return trainer.models()


def decode_stage(models, corpus, eval_transcripts, mcfg, args):
    from cs304_tpu.models.decoder import ContinuousDecoder
    from cs304_tpu.ops.mfcc import mfcc_batch

    # The exact baseline tier: whitening is f32-exact but materializes a
    # (T, S, D) intermediate — past ~2500 states that no longer fits, so
    # --emissions-exact quad makes quad+HIGHEST the baseline (measured
    # agreement 1.0 vs whitening wherever both run; the 1000-word config).
    decoder = ContinuousDecoder(models, penalty=args.penalty,
                                emissions=args.emissions_exact)
    s_total = decoder.composite.num_states
    test_speakers = range(args.train_speakers,
                          args.train_speakers + args.test_speakers)
    truths, clips = [], []
    for tr in eval_transcripts:
        for spk in test_speakers:
            truths.append("".join(tr))
            clips.append(corpus.sentence_audio(tr, spk, jitter_seed=77 + 1000 * args.seed))
    feats = mfcc_batch(clips, cfg=mcfg)
    feats = [np.asarray(f) for f in feats]

    decoder.predict_batch(feats)  # compile warmup
    t0 = time.perf_counter()
    preds = decoder.predict_batch(feats)
    dt = time.perf_counter() - t0
    acc = float(np.mean([p == t for p, t in zip(preds, truths)]))

    pruned = ContinuousDecoder(models, penalty=args.penalty, beam=args.beam,
                               emissions=args.emissions_exact)
    pruned.predict_batch(feats)  # compile warmup
    t1 = time.perf_counter()
    preds_beam = pruned.predict_batch(feats)
    dt_beam = time.perf_counter() - t1
    acc_beam = float(np.mean([p == t for p, t in zip(preds_beam, truths)]))
    agree = float(np.mean([a == b for a, b in zip(preds, preds_beam)]))

    # Quad-form emission layout: the large-S lever (the whitening path's
    # (T, S, D) intermediate grows with S; the quad layout is one K=1521
    # matmul). Skipped when
    # quad already IS the baseline.
    if args.emissions_exact == "quad":
        dt_quad, agree_quad = dt, 1.0
    else:
        quad = ContinuousDecoder(models, penalty=args.penalty,
                                 emissions="quad")
        quad.predict_batch(feats)  # compile warmup
        t2 = time.perf_counter()
        preds_quad = quad.predict_batch(feats)
        dt_quad = time.perf_counter() - t2
        agree_quad = float(
            np.mean([a == b for a, b in zip(preds, preds_quad)])
        )

    # Emission precision tiers on the quad layout
    # (models/decoder.EMISSION_PRECISION): "high" is three bf16 passes,
    # "default" the backend's default f32 dot (TF32 on the GPU).
    prec_cols = {}
    for tier in ("high", "default"):
        fast = ContinuousDecoder(models, penalty=args.penalty,
                                 emissions="quad",
                                 emission_precision=tier)
        fast.predict_batch(feats)  # compile warmup
        t3 = time.perf_counter()
        preds_fast = fast.predict_batch(feats)
        dt_fast = time.perf_counter() - t3
        prec_cols[f"utt_per_s_quad_{tier}"] = round(len(feats) / dt_fast, 1)
        prec_cols[f"exact_seq_acc_test_quad_{tier}"] = round(float(
            np.mean([p == t for p, t in zip(preds_fast, truths)])), 4)
        prec_cols[f"quad_{tier}_agreement"] = round(float(
            np.mean([a == b for a, b in zip(preds, preds_fast)])), 4)

    print(json.dumps({
        "stage": "decode", "composite_states": s_total,
        "utterances": len(feats), "exact_seq_acc_test": round(acc, 4),
        "utt_per_s": round(len(feats) / dt, 1),
        "beam": args.beam, "exact_seq_acc_test_beam": round(acc_beam, 4),
        "utt_per_s_beam": round(len(feats) / dt_beam, 1),
        "beam_agreement": round(agree, 4),
        "utt_per_s_quad": round(len(feats) / dt_quad, 1),
        "quad_agreement": round(agree_quad, 4),
        **prec_cols,
    }))
    return decoder, feats, truths, acc, acc_beam


def serving_stage(models, feats, truths, args):
    """Batched streaming pool at full vocabulary scale: parity + capacity."""
    from cs304_tpu.models.decoder import ContinuousDecoder
    from cs304_tpu.ops.streaming_batch import (
        BatchedStreamingComposite,
        ring_dtype,
    )
    import jax.numpy as jnp

    decoder = ContinuousDecoder(models, penalty=args.penalty,
                                emissions=args.emissions_exact)
    s_total = decoder.composite.num_states
    if s_total > 127:
        assert ring_dtype(s_total) == jnp.int32, (
            "past 127 states the ring must be int32 (the reference's int8 "
            "tracer defect, hidden_markov_model.py:175)"
        )
    max_frames = -(-max(f.shape[0] for f in feats) // 512) * 512
    n_parity = min(len(feats), args.slots)
    pool = BatchedStreamingComposite(
        decoder.composite, num_slots=args.slots, chunk_size=args.chunk,
        max_frames=max_frames,
        # The streaming step's whitening layout also materializes a
        # (slots*chunk, S, D) intermediate; quad keeps the 1000-word pool
        # feasible (and matches the offline baseline tier).
        emissions=args.emissions_exact,
    )
    slots = [pool.start() for _ in range(n_parity)]
    fed = {s: 0 for s in slots}
    sample = feats[:n_parity]
    while any(fed[s] < sample[i].shape[0] for i, s in enumerate(slots)):
        feeds = {}
        for i, s in enumerate(slots):
            lo = fed[s]
            if lo < sample[i].shape[0]:
                hi = min(lo + args.chunk, sample[i].shape[0])
                feeds[s] = sample[i][lo:hi]
                fed[s] = hi
        pool.step(feeds)
    streamed = pool.finalize(slots)
    offline = decoder.predict_batch(sample)
    parity = [streamed[s][1] == offline[i] for i, s in enumerate(slots)]
    if not all(parity):
        for i, s in enumerate(slots):
            if not parity[i] and sum(
                not p for p in parity[: i + 1]
            ) <= 5:
                print(json.dumps({
                    "parity_diff": i, "frames": int(sample[i].shape[0]),
                    "streamed": streamed[s][1],
                    "streamed_score": round(float(streamed[s][0]), 2),
                    "offline": offline[i],
                }))
    assert all(parity), (
        f"streamed != offline for {parity.count(False)}/{n_parity} streams"
    )

    # Steady-state capacity: all slots fed a full chunk per step, chained.
    for s in slots:
        pool.release(s)
    slots = [pool.start() for _ in range(args.slots)]
    rng = np.random.default_rng(0)
    dim = decoder.composite.means.shape[-1]
    feed_sets = [
        {s: rng.normal(size=(args.chunk, dim)).astype(np.float32)
         for s in slots}
        for _ in range(3)
    ]
    pool.step(feed_sets[0])
    np.asarray(pool._alpha)
    for s in slots:
        pool.release(s)
    slots = [pool.start() for _ in range(args.slots)]
    steps = min(30, (max_frames // args.chunk) - 1)
    t0 = time.perf_counter()
    for i in range(steps):
        pool.step(feed_sets[i % 3])
    np.asarray(pool._alpha)
    dt = (time.perf_counter() - t0) / steps
    frames_per_sec = args.slots * args.chunk / dt
    capacity = int(frames_per_sec / FRAME_RATE)
    print(json.dumps({
        "stage": "serving", "composite_states": s_total,
        "ring_dtype": ring_dtype(s_total).__name__, "slots": args.slots, "chunk": args.chunk,
        "parity_streams": n_parity, "parity": "exact",
        "step_ms": round(dt * 1e3, 2),
        "realtime_streams": capacity,
    }))
    return capacity


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-words", type=int, default=100)
    ap.add_argument("--hard", action="store_true",
                    help="hardened degradations (SNR/channel/speaker spread)")
    ap.add_argument("--train-speakers", type=int, default=6)
    ap.add_argument("--test-speakers", type=int, default=2)
    ap.add_argument("--takes", type=int, default=3)
    ap.add_argument("--train-transcripts", type=int, default=60)
    ap.add_argument("--eval-transcripts", type=int, default=40)
    ap.add_argument("--sentence-takes", type=int, default=2)
    ap.add_argument("--train-iterations", type=int, default=4)
    ap.add_argument("--penalty", type=float, default=-100.0)
    # Default width: auto-scales with the composite state count. 150 was
    # measured loss-free at 20 words (S=103; beam=80 already lost ~8% of
    # transcripts there) and at 100 words (S=503), but a FIXED 150 measured
    # 0.775 vs 0.85 unpruned at 200 words (S=1003) — more words means more
    # near-max competing word hypotheses per frame, so the relative
    # threshold must widen with S. Measured at S=1003: 0.3*S -> agreement
    # 0.925, 0.5*S -> 0.975 (the last flips are exact near-ties). Widening
    # is monotone-safe (a larger threshold keeps a superset of hypotheses),
    # so auto can only move the A/B toward the exact decoder.
    ap.add_argument("--beam", type=float, default=None,
                    help="beam width; default auto: max(150, 0.5 * states)")
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--no-gates", action="store_true")
    ap.add_argument("--skip-serving", action="store_true")
    ap.add_argument("--emissions-exact", choices=("whiten", "quad"),
                    default="whiten",
                    help="emission layout of the EXACT baseline decoder "
                         "(and the serving pool): whitening is f32-exact "
                         "but its (T, S, D) intermediate stops fitting "
                         "past ~2500 states; quad+HIGHEST is the measured-"
                         "agreement-1.0 stand-in at 1000 words")
    ap.add_argument("--save-ckpt", default=None,
                    help="save the trained models to this directory after "
                         "embedded training (utils/checkpoint.py manifest "
                         "format), so serving/decode stages can be re-run "
                         "without the ~15-minute boot+train at 1000 words")
    ap.add_argument("--load-ckpt", default=None,
                    help="skip boot+train and load models from this "
                         "checkpoint directory (pair with the --seed/"
                         "--num-words of the run that saved it: the eval "
                         "transcripts are drawn from those)")
    ap.add_argument("--seed", type=int, default=0,
                    help="replication seed: offsets the train/eval "
                         "transcript draws and the eval jitter base, so "
                         "repeated gate runs are independent realizations "
                         "(the precision-tier A/B needs n >= 2)")
    args = ap.parse_args()

    from cs304_tpu.ops.mfcc import MFCCConfig

    mcfg = MFCCConfig()
    corpus = build_corpus(args)
    labels = corpus.labels
    if args.beam is None:
        args.beam = max(150.0, 0.5 * (5 * len(labels) + 3))
    print(json.dumps({
        "stage": "corpus", "num_words": len(labels),
        "hard": bool(args.hard),
        "composite_states": 5 * len(labels) + 3,
    }))

    if args.load_ckpt:
        from cs304_tpu.utils.checkpoint import load_models

        models = load_models(args.load_ckpt)
        print(json.dumps({"stage": "load_ckpt", "path": args.load_ckpt,
                          "labels": len(models)}))
    else:
        boot = boot_stage(corpus, mcfg)
        train_trs = make_transcripts(labels, args.train_transcripts,
                                     (2, 3, 4), seed=5 + 100 * args.seed)
        models = train_stage(corpus, boot, train_trs, mcfg, args)
        if args.save_ckpt:
            from cs304_tpu.utils.checkpoint import save_models

            save_models(models, args.save_ckpt, tier="words",
                        provenance={"script": "benchmarks/scale_vocab.py",
                                    "num_words": len(labels),
                                    "seed": args.seed})
            print(json.dumps({"stage": "save_ckpt",
                              "path": args.save_ckpt}))
    eval_trs = make_transcripts(labels, args.eval_transcripts,
                                (2, 3, 4), seed=6 + 100 * args.seed)
    decoder, feats, truths, acc, acc_beam = decode_stage(
        models, corpus, eval_trs, mcfg, args
    )
    capacity = None
    if not args.skip_serving:
        capacity = serving_stage(models, feats, truths, args)

    summary = {
        "metric": f"exact-sequence accuracy, {len(labels)}-word vocabulary, "
                  "held-out speakers",
        "value": round(acc, 4),
        "unit": "accuracy",
        "beam_acc": round(acc_beam, 4),
    }
    if capacity is not None:
        summary["realtime_streams"] = capacity
    print(json.dumps(summary))
    if not args.no_gates:
        assert acc >= GATE_TEST, (
            f"held-out accuracy {acc:.2%} < {GATE_TEST:.0%} at "
            f"{len(labels)} words"
        )
        # The beam A/B is gated RELATIVE to the exact decoder: on dense
        # vector hardware the prune saves no FLOPs — it is a search-semantics
        # lever, so the contract is "costs at most a few near-tie flips vs
        # exact", not an absolute accuracy floor (at S=1003 the auto width
        # measures agreement 0.975 with every flip an exact near-tie).
        assert acc_beam >= acc - 0.05, (
            f"beam-pruned accuracy {acc_beam:.2%} more than 5 points below "
            f"the exact decoder's {acc:.2%}"
        )
        print(json.dumps({"gates": "pass"}))


if __name__ == "__main__":
    main()
