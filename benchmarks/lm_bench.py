#!/usr/bin/env python
"""Bigram-LM decode overhead: flat-penalty fast vs LM fast vs LM scan.

Times the composite trellis (emissions precomputed, so the delta isolates
the entry-update change) at serving batch size on the flagship 58-state
topology. The fast banded step's LM form replaces one shared best-exit
reduction with a (W, W) tropical matvec over per-word best exits —
O(S + W^2) per frame — so it should sit within a few percent of the flat
path, while the dense (S, S) scan pays the full quadratic step.

Prints one JSON line with utterances/sec for each variant and the device
it ran on. Not measured on the GPU yet.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

B, T = 1024, 160


def main() -> None:
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_params
    from cs304_tpu.ops.lm import train_word_bigram, word_pair_penalties
    from cs304_tpu.ops.viterbi import (
        viterbi_composite_batch,
        viterbi_composite_batch_fast,
    )

    comp = _flagship_params()
    rng = np.random.default_rng(0)
    log_b = jnp.asarray(
        rng.normal(size=(B, T, comp.num_states)).astype(np.float32) - 40.0
    )
    lengths = jnp.asarray(np.full(B, T, np.int32))
    log_a = jnp.asarray(comp.log_a)
    lower = jnp.asarray(comp.lower_of_state)
    is_entry = jnp.asarray(comp.is_entry)
    is_exit = jnp.asarray(comp.is_exit)
    bigram = train_word_bigram(
        ["12345", "54321", "9O2Z"], comp.labels, insert_silence=True
    )
    pair_w = jnp.asarray(word_pair_penalties(comp, bigram, 1.0))
    word_of = jnp.asarray(comp.word_of_state, dtype=jnp.int32)
    uppers = jnp.asarray(comp.uppers, dtype=jnp.int32)
    pair_s = jnp.asarray(
        np.asarray(pair_w)[np.asarray(comp.word_of_state)[:, None],
                           np.asarray(comp.word_of_state)[None, :]]
    )

    fast_flat = jax.jit(lambda b, l: viterbi_composite_batch_fast(
        b, log_a, lower, is_entry, is_exit, jnp.float32(comp.penalty), l))
    fast_lm = jax.jit(lambda b, l: viterbi_composite_batch_fast(
        b, log_a, lower, is_entry, is_exit, jnp.float32(comp.penalty), l,
        pair_penalty=pair_w, word_of_state=word_of, uppers=uppers))
    scan_lm = jax.jit(lambda b, l: viterbi_composite_batch(
        b, log_a, lower, is_entry, is_exit, pair_s, l))

    results = {}
    for name, fn in (("fast_flat", fast_flat), ("fast_lm", fast_lm),
                     ("scan_lm", scan_lm)):
        jax.block_until_ready(fn(log_b, lengths))  # compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(5):
                out = fn(log_b, lengths)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        results[f"{name}_utt_s"] = round(B * 5 / best, 1)

    results["lm_overhead_vs_flat"] = round(
        results["fast_flat_utt_s"] / results["fast_lm_utt_s"], 3
    )
    dev = jax.devices()[0]
    results["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}
    print(json.dumps(results))


if __name__ == "__main__":
    main()
