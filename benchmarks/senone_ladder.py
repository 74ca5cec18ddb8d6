#!/usr/bin/env python
"""Senone-vs-tying ladder with statistical teeth (VERDICT r4 item #2).

Round 4's headline — senones 0.95 in-vocab vs 0.85-0.90 for generalized
(tied) triphones at larger parameter counts — was measured on 20 eval
utterances, where one utterance is 0.05 and the builder's own noise
estimate was +/-0.1. This driver re-runs the SAME anticipatory-corpus cell
(benchmarks/phone_tier.py, the r4 flagship config) across K replication
seeds in one process (the compile cache amortizes across seeds): each seed
redraws the training sentences, the evaluation sentences, and every speech
jitter realization, while the vocabulary, the lexicon, and the speaker
inventory stay fixed — K independent realizations of the same task.

It reports per-tier mean +/- stderr over seeds AND the PAIRED per-seed
margins (senone - tied, tied - untied, untied - mono), whose stderr is the
honest error bar for the headline claims, then gates the tier ORDERING

    senone >= tied >= untied-context >= monophone      (in-vocab, on means,
                                                        each step within
                                                        one paired stderr)

instead of any point estimate. JSON line per seed; final aggregate line.
"""
import argparse
import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from benchmarks.phone_tier import build_parser, run as run_cell  # noqa: E402

# The flagship phone-tier cell (anticipatory corpus, rich data) — the config
# behind README.md's senone result.
CELL = (
    "--num-words 20 --phones-per-word 2 3 --hard --anticipatory 0.45 "
    "--train-speakers 8 --takes 6 --train-sentences 30 "
    "--biphones --triphones --senones 4 --tie-triphones 4 --no-gates"
).split()

IN_VOCAB_TIERS = (
    "word_tier", "phone_tier", "biphone_tier", "triphone_tier",
    "tied_triphone_tier", "senone_tier",
)
# The ordered ladder the gate checks (in-vocab): coarse -> fine sharing.
ORDERING = ("phone_tier", "triphone_tier", "tied_triphone_tier",
            "senone_tier")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--eval-sentences", type=int, default=20,
                    help="per seed; utterances = 2 test speakers x this, "
                         "so 5 seeds x 20 = 200 eval utterances per cell")
    ap.add_argument("--out", default=None,
                    help="append per-seed + aggregate JSON lines here")
    ap.add_argument("--no-gates", action="store_true")
    args = ap.parse_args()

    cell_parser = build_parser()
    rows = []
    sink = open(args.out, "a") if args.out else None

    def record(obj):
        print(json.dumps(obj))
        if sink:
            sink.write(json.dumps(obj) + "\n")
            sink.flush()

    record({"stage": "ladder_config", "cell": " ".join(CELL),
            "seeds": args.seeds, "eval_sentences": args.eval_sentences})
    for seed in range(args.seeds):
        cell_args = cell_parser.parse_args(
            CELL + ["--seed", str(seed),
                    "--eval-sentences", str(args.eval_sentences)]
        )
        lines = run_cell(cell_args)
        by_stage = {ln.get("stage"): ln for ln in lines if "stage" in ln}
        row = {"stage": "seed_row", "seed": seed}
        for tier in IN_VOCAB_TIERS:
            row[f"{tier}_acc"] = by_stage["in_vocab"].get(f"{tier}_acc")
        oov = by_stage.get("oov", {})
        for key, val in oov.items():
            if "_oov_exact" in key:
                row[key] = val
        row["utterances"] = by_stage["in_vocab"]["utterances"]
        for key in ("senone_tier_params", "tied_triphone_tier_params",
                    "triphone_tier_params", "phone_tier_params",
                    "word_tier_params", "senones"):
            if key in by_stage["training"]:
                row[key] = by_stage["training"][key]
        rows.append(row)
        record(row)

    def agg(key):
        vals = np.array([r[key] for r in rows if r.get(key) is not None],
                        float)
        if not len(vals):
            return None
        return {
            "mean": round(float(vals.mean()), 4),
            "stderr": round(float(vals.std(ddof=1) / np.sqrt(len(vals)))
                            if len(vals) > 1 else 0.0, 4),
            "n_seeds": int(len(vals)),
        }

    def paired(key_a, key_b):
        d = np.array([r[key_a] - r[key_b] for r in rows
                      if r.get(key_a) is not None
                      and r.get(key_b) is not None], float)
        if not len(d):
            return None
        return {
            "mean": round(float(d.mean()), 4),
            "stderr": round(float(d.std(ddof=1) / np.sqrt(len(d)))
                            if len(d) > 1 else 0.0, 4),
        }

    summary = {"stage": "aggregate",
               "eval_utterances_total": int(sum(r["utterances"]
                                                for r in rows))}
    for tier in IN_VOCAB_TIERS:
        summary[f"{tier}_acc"] = agg(f"{tier}_acc")
    for key in ("senone_tier_oov_exact",  # backoff is the default policy
                "senone_tier_oov_exact_tree_synthesis",
                "tied_triphone_tier_oov_exact", "phone_tier_oov_exact",
                "triphone_tier_oov_exact", "biphone_tier_oov_exact"):
        if any(r.get(key) is not None for r in rows):
            summary[key] = agg(key)
    # Paired margins: the error bars the headline claims must clear.
    summary["margin_senone_minus_tied"] = paired(
        "senone_tier_acc", "tied_triphone_tier_acc")
    summary["margin_tied_minus_untied"] = paired(
        "tied_triphone_tier_acc", "triphone_tier_acc")
    summary["margin_untied_minus_mono"] = paired(
        "triphone_tier_acc", "phone_tier_acc")
    record(summary)

    m = summary["margin_senone_minus_tied"]
    verdict = {
        "stage": "headline_verdict",
        "claim": "senones beat whole-unit tying at equal-or-lower params",
        "margin": m["mean"], "stderr": m["stderr"],
        "exceeds_error_bar": bool(m["mean"] > m["stderr"]),
        "note": ("margin > 1 paired stderr" if m["mean"] > m["stderr"]
                 else "RETRACTED to parity-at-fewer-params: margin within "
                      "one paired stderr"),
    }
    record(verdict)

    if not args.no_gates:
        # Gate the ORDERING on means, each step allowed one paired stderr
        # of slack (ties are fine; an INVERSION beyond noise fails).
        means = {t: summary[f"{t}_acc"]["mean"] for t in ORDERING}
        slack = {
            ("phone_tier", "triphone_tier"):
                summary["margin_untied_minus_mono"]["stderr"],
            ("triphone_tier", "tied_triphone_tier"):
                summary["margin_tied_minus_untied"]["stderr"],
            ("tied_triphone_tier", "senone_tier"):
                summary["margin_senone_minus_tied"]["stderr"],
        }
        for (lo, hi), se in slack.items():
            assert means[hi] >= means[lo] - se, (
                f"ordering inversion beyond noise: {hi} mean {means[hi]} < "
                f"{lo} mean {means[lo]} - stderr {se}"
            )
        record({"gates": "pass",
                "ordering": " <= ".join(f"{t}:{means[t]}" for t in ORDERING)})
    if sink:
        sink.close()


if __name__ == "__main__":
    main()
