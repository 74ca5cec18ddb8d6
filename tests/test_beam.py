"""Beam pruning in the banded composite backend.

Classic per-frame relative pruning (the rule the reference applies to its
DTW trellis, dynamic_time_wrapping.py:89-95), added to the HMM decoder for
large-vocabulary search control. Verified three ways: beam=inf is EXACT
against the unpruned path, a finite beam matches an independent NumPy
oracle (tests/oracles.ref_viterbi_composite_beam), and at the decoder level
a generous beam reproduces the unpruned transcript on a 100-word composite.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from cs304_tpu.models.hmm import WordHMM, uniform_forward_log_a
from cs304_tpu.ops.viterbi import viterbi_composite_batch_fast

from oracles import ref_viterbi_composite_beam


def _random_composite(rng, n_words=(2, 6), states=(2, 6)):
    n = int(rng.integers(*n_words))
    state_counts = [int(rng.integers(*states)) for _ in range(n)]
    s_total = sum(state_counts)
    log_a = np.full((s_total, s_total), -np.inf, np.float32)
    lowers, uppers, base = [], [], 0
    for c in state_counts:
        block = np.zeros((c, c))
        for i in range(c):
            row = rng.random(c - i)
            block[i, i:] = row / max(row.sum(), 1e-9)
        with np.errstate(divide="ignore"):
            log_a[base : base + c, base : base + c] = np.log(block)
        lowers.append(base)
        uppers.append(base + c - 1)
        base += c
    lower_of = np.zeros(s_total, np.int32)
    for lo in lowers:
        lower_of[lo:] = lo
    entry = np.zeros(s_total, bool)
    entry[lowers] = True
    exit_ = np.zeros(s_total, bool)
    exit_[uppers] = True
    return s_total, log_a, lower_of, entry, exit_, lowers, uppers


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_beam_inf_is_exact(seed):
    rng = np.random.default_rng(seed)
    s, log_a, lower_of, entry, exit_, _, _ = _random_composite(rng)
    b, t = 4, 20
    log_b = (rng.normal(size=(b, t, s)) * 3).astype(np.float32)
    lengths = rng.integers(t // 2, t + 1, size=b).astype(np.int32)
    args = (jnp.asarray(log_b), jnp.asarray(log_a), jnp.asarray(lower_of),
            jnp.asarray(entry), jnp.asarray(exit_), -7.0,
            jnp.asarray(lengths))
    want_s, want_p = viterbi_composite_batch_fast(*args)
    for huge in (None, jnp.float32(1e9)):
        got_s, got_p = viterbi_composite_batch_fast(*args, beam=huge)
        np.testing.assert_array_equal(np.asarray(got_s), np.asarray(want_s))
        np.testing.assert_array_equal(np.asarray(got_p), np.asarray(want_p))


@pytest.mark.parametrize("seed", [21, 22, 23, 24])
@pytest.mark.parametrize("beam", [2.0, 6.0, 15.0])
def test_beam_matches_oracle(seed, beam):
    rng = np.random.default_rng(seed)
    s, log_a, lower_of, entry, exit_, lowers, uppers = _random_composite(rng)
    t = 18
    # f32-exact inputs with well-separated values so the f64 oracle and the
    # f32 kernel agree bit-for-bit on every comparison.
    log_b = np.round(rng.normal(size=(t, s)) * 4, 2).astype(np.float32)
    log_a = np.round(log_a, 2).astype(np.float32)
    want_score, want_path = ref_viterbi_composite_beam(
        log_b.astype(np.float64), log_a.astype(np.float64),
        lowers, uppers, -7.0, beam,
    )
    got_scores, got_paths = viterbi_composite_batch_fast(
        jnp.asarray(log_b[None]), jnp.asarray(log_a),
        jnp.asarray(lower_of), jnp.asarray(entry), jnp.asarray(exit_),
        -7.0, jnp.asarray([t], np.int32), beam=jnp.float32(beam),
    )
    assert np.asarray(got_scores)[0] == pytest.approx(want_score, abs=1e-3)
    np.testing.assert_array_equal(np.asarray(got_paths)[0], want_path)


def test_beam_tight_still_decodes():
    """Even an extreme beam keeps the per-frame max alive: scores stay
    finite and the path remains a valid state sequence."""
    rng = np.random.default_rng(5)
    s, log_a, lower_of, entry, exit_, _, _ = _random_composite(rng)
    t = 25
    log_b = (rng.normal(size=(1, t, s)) * 3).astype(np.float32)
    scores, paths = viterbi_composite_batch_fast(
        jnp.asarray(log_b), jnp.asarray(log_a), jnp.asarray(lower_of),
        jnp.asarray(entry), jnp.asarray(exit_), -7.0,
        jnp.asarray([t], np.int32), beam=jnp.float32(0.5),
    )
    assert np.isfinite(np.asarray(scores)[0])
    p = np.asarray(paths)[0]
    assert ((p >= 0) & (p < s)).all()


def test_decoder_beam_generous_matches_unpruned(rng):
    """100-word composite (s=503 with silence-free 5-state words): a generous
    beam decodes to the identical transcripts."""
    from cs304_tpu.data.wordvocab import word_labels
    from cs304_tpu.models.decoder import ContinuousDecoder
    from cs304_tpu.models.hmm import WordHMM

    labels = word_labels(100)
    models = {}
    for i, label in enumerate(labels):
        means = np.zeros((5, 3), np.float32)
        means[:, 0] = (i % 25) * 4.0
        means[:, 1] = (i // 25) * 4.0
        means[:, 2] = np.arange(5)
        models[label] = WordHMM(
            label=label, means=means,
            covariances=np.tile(np.eye(3, dtype=np.float32) * 0.25,
                                (5, 1, 1)),
            log_a=uniform_forward_log_a(5),
        )
    base = ContinuousDecoder(models, penalty=-8.0)
    pruned = ContinuousDecoder(models, penalty=-8.0, beam=60.0)
    assert base.composite.num_states == 500

    feats_list = []
    for w1, w2 in ((3, 77), (50, 12), (99, 0)):
        frames = []
        for w in (w1, w2):
            for st in range(5):
                for _ in range(3):
                    frames.append([(w % 25) * 4.0, (w // 25) * 4.0, st])
        feats_list.append(
            np.asarray(frames, np.float32)
            + rng.normal(0, 0.05, (len(frames), 3)).astype(np.float32)
        )
    want = base.predict_batch(feats_list)
    got = pruned.predict_batch(feats_list)
    assert want == got
    assert want[0] == labels[3] + labels[77]


def test_decoder_beam_validation():
    from cs304_tpu.models.decoder import ContinuousDecoder
    from cs304_tpu.models.hmm import WordHMM

    m = WordHMM(
        label="a", means=np.zeros((3, 2), np.float32),
        covariances=np.tile(np.eye(2, dtype=np.float32), (3, 1, 1)),
        log_a=uniform_forward_log_a(3),
    )
    with pytest.raises(ValueError):
        ContinuousDecoder({"a": m}, beam=-1.0)
    # Non-fast backends silently switch to fast (documented).
    d = ContinuousDecoder({"a": m}, backend="scanfree", beam=10.0)
    assert d.backend == "fast"


def test_decoder_beam_gmm(rng):
    """Beam threading through the GMM emission path (the wrapper that was
    missed on first wiring — regression guard)."""
    from cs304_tpu.models.decoder import ContinuousDecoder
    from cs304_tpu.models.gmm_hmm import GMMWordHMM

    models = {}
    for i, label in enumerate(("aa", "bb", "cc")):
        means = np.zeros((3, 2, 4), np.float32)  # (S, K, D)
        means[:, :, 0] = i * 5.0
        means[:, :, 1] = np.arange(3)[:, None]
        means[:, 1, 2] = 1.0
        models[label] = GMMWordHMM(
            label=label, means=means,
            covariances=np.tile(np.eye(4, dtype=np.float32) * 0.3,
                                (3, 2, 1, 1)),
            weights=np.full((3, 2), 0.5, np.float32),
            log_a=uniform_forward_log_a(3),
        )
    base = ContinuousDecoder(models, penalty=-5.0)
    pruned = ContinuousDecoder(models, penalty=-5.0, beam=80.0)
    frames = []
    for w in (2, 0):
        for st in range(3):
            for _ in range(3):
                frames.append([w * 5.0, st, 0.5, 0.0])
    feats = (np.asarray(frames, np.float32)
             + rng.normal(0, 0.05, (len(frames), 4)).astype(np.float32))
    assert base.predict_batch([feats]) == pruned.predict_batch([feats])
    assert pruned.predict(feats) == "ccaa"


def test_decoder_quad_emissions_agree(rng):
    """emissions='quad' (the K=1521 matmul layout) decodes the same
    transcripts as the parity whitening layout on separated models."""
    from cs304_tpu.data.wordvocab import word_labels
    from cs304_tpu.models.decoder import ContinuousDecoder
    from cs304_tpu.models.hmm import WordHMM

    labels = word_labels(40)
    models = {}
    for i, label in enumerate(labels):
        means = np.zeros((5, 3), np.float32)
        means[:, 0] = (i % 8) * 4.0
        means[:, 1] = (i // 8) * 4.0
        means[:, 2] = np.arange(5)
        models[label] = WordHMM(
            label=label, means=means,
            covariances=np.tile(np.eye(3, dtype=np.float32) * 0.25,
                                (5, 1, 1)),
            log_a=uniform_forward_log_a(5),
        )
    base = ContinuousDecoder(models, penalty=-8.0)
    quad = ContinuousDecoder(models, penalty=-8.0, emissions="quad")
    feats_list = []
    for w1, w2 in ((3, 37), (20, 12)):
        frames = []
        for w in (w1, w2):
            for st in range(5):
                for _ in range(3):
                    frames.append([(w % 8) * 4.0, (w // 8) * 4.0, st])
        feats_list.append(
            np.asarray(frames, np.float32)
            + rng.normal(0, 0.05, (len(frames), 3)).astype(np.float32)
        )
    assert base.predict_batch(feats_list) == quad.predict_batch(feats_list)
    s_b, _, _ = base.viterbi_batch(feats_list)
    s_q, _, _ = quad.viterbi_batch(feats_list)
    np.testing.assert_allclose(s_q, s_b, rtol=1e-4, atol=0.5)
    with pytest.raises(ValueError):
        ContinuousDecoder(models, emissions="nope")


def test_decoder_emission_precision_knob():
    """emission_precision='default' (single-pass bf16 emission matmuls)
    requires the quad layout; predictions agree with the f32-exact tier on
    well-separated models (near-tie flips are the documented trade)."""
    from cs304_tpu.models.decoder import ContinuousDecoder

    rng = np.random.default_rng(3)
    models = {}
    for lab in ("1", "2", "S"):
        s = 3 if lab == "S" else 5
        means = rng.normal(size=(s, 39)).astype(np.float32) * 6
        covs = np.tile(np.eye(39, dtype=np.float32), (s, 1, 1))
        models[lab] = WordHMM(label=lab, means=means, covariances=covs,
                              log_a=uniform_forward_log_a(s))
    with pytest.raises(ValueError):
        ContinuousDecoder(models, emission_precision="default")  # whiten
    with pytest.raises(ValueError):
        ContinuousDecoder(models, emissions="quad",
                          emission_precision="half")
    # Clips near the models (realistic regime), not i.i.d. noise.
    clips = []
    for lab in ("1", "2"):
        m = models[lab].means
        clips.append(np.concatenate([
            np.repeat(m, 8, axis=0)
            + rng.normal(0, 0.3, (m.shape[0] * 8, 39)).astype(np.float32)
        ]).astype(np.float32))
    exact = ContinuousDecoder(models, penalty=-50.0,
                              emissions="quad").predict_batch(clips)
    fast = ContinuousDecoder(
        models, penalty=-50.0, emissions="quad",
        emission_precision="default",
    ).predict_batch(clips)
    assert fast == exact == ["1", "2"]
