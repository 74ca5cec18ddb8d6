"""Parity tests for the scan-free trellis kernel (forward + backtrace).

The kernel must be BITWISE identical to ops.viterbi.viterbi_composite_batch_fast
(same candidate order, first-max tie-breaks, live masking, backtrace quirk).
Here that runs in the Pallas interpreter on small shapes; the `gpu` tests run
the compiled kernel on the card at real widths (chip_smoke.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cs304_tpu.models.hmm import WordHMM, stack_word_models, uniform_forward_log_a
from cs304_tpu.ops.pallas import trellis_scanfree
from cs304_tpu.ops.pallas.trellis_scanfree import (
    choose_tiles,
    viterbi_composite_batch_scanfree,
)
from cs304_tpu.ops.viterbi import viterbi_composite_batch_fast


def _composite(num_words, states_per_word, seed=0):
    rng = np.random.default_rng(seed)
    models = []
    for i in range(num_words):
        s = states_per_word[i % len(states_per_word)]
        means = rng.normal(size=(s, 4)).astype(np.float32)
        covs = np.tile(np.eye(4, dtype=np.float32), (s, 1, 1))
        models.append(WordHMM(label=str(i), means=means, covariances=covs,
                              log_a=uniform_forward_log_a(s)))
    return stack_word_models(models, penalty=-25.0)


def _args(comp, lengths):
    return (jnp.asarray(comp.log_a), jnp.asarray(comp.lower_of_state),
            jnp.asarray(comp.is_entry), jnp.asarray(comp.is_exit),
            jnp.float32(comp.penalty), jnp.asarray(lengths, jnp.int32))


def _assert_bitwise(log_b, args, quirk, interpret=True):
    ref_s, ref_p = viterbi_composite_batch_fast(
        log_b, *args, quirk_backtrace=quirk)
    got_s, got_p = viterbi_composite_batch_scanfree(
        log_b, *args, quirk_backtrace=quirk, interpret=interpret)
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(ref_s))
    np.testing.assert_array_equal(np.asarray(got_p), np.asarray(ref_p))


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("b,t,words,spw,lengths", [
    (16, 33, 3, (5,), "full"),          # one chunk narrower than a warp
    (8, 50, 12, (5, 5, 3), "ragged"),   # the flagship 58-state shape
    (3, 18, 250, (5, 5, 3), "ragged"),  # 1084 states -> two 1024-wide chunks
    (5, 2, 4, (5, 3), "ragged"),        # T=2: a single recursion step
    (6, 21, 6, (5, 3), "short"),        # lengths 0 and 1 mixed in
], ids=["s15", "s58", "multichunk", "t2", "short"])
def test_scanfree_matches_fast(b, t, words, spw, lengths, quirk):
    comp = _composite(words, spw)
    rng = np.random.default_rng(1)
    log_b = jnp.asarray(
        rng.normal(size=(b, t, comp.num_states)).astype(np.float32) * 3)
    if lengths == "full":
        lens = np.full(b, t)
    elif lengths == "short":
        lens = np.array([0, 1, 2, t, 3, 1])[:b]
    else:
        lens = rng.integers(1, t + 1, size=b)
    _assert_bitwise(log_b, _args(comp, lens), quirk)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scanfree_first_max_ties(seed):
    """Integer-valued emissions and uniform transitions make exact float
    ties everywhere: within the band, between exits, and exit vs self-loop."""
    comp = _composite(6, (3, 2))
    rng = np.random.default_rng(seed)
    log_b = jnp.asarray(
        rng.integers(-2, 1, size=(4, 24, comp.num_states)).astype(np.float32))
    lens = rng.integers(2, 25, size=4)
    log_a = np.where(np.isfinite(comp.log_a), -1.0, -np.inf).astype(np.float32)
    args = (jnp.asarray(log_a),) + _args(comp, lens)[1:4] + (
        jnp.float32(-1.0), jnp.asarray(lens, jnp.int32))
    _assert_bitwise(log_b, args, quirk=True)


@pytest.mark.parametrize("s,expected", [
    (1, (1, 1, 1)),
    (58, (64, 1, 1)),
    (503, (512, 1, 4)),
    (1024, (1024, 1, 8)),
    (1025, (1024, 2, 8)),
    (5003, (1024, 5, 8)),
])
def test_choose_tiles(s, expected):
    """Power-of-two state chunks of at most MAX_CHUNK, one warp per 128
    lanes of a chunk; the chunks cover every state."""
    chunk, n_chunks, num_warps = choose_tiles(s)
    assert (chunk, n_chunks, num_warps) == expected
    assert chunk * n_chunks >= s > chunk * (n_chunks - 1)


def test_pack_coefs_padding():
    """Padded states (beyond S up to the chunk multiple) can never be
    entered, never exit and never score; real states keep their band."""
    comp = _composite(3, (5, 3))
    s = comp.num_states
    coefs = np.asarray(trellis_scanfree._pack_coefs(
        *(jnp.asarray(a) for a in (comp.log_a, comp.lower_of_state,
                                   comp.is_entry, comp.is_exit)),
        jnp.float32(comp.penalty), 16))
    assert coefs.shape == (8, 16)
    pad = coefs[:, s:]
    for row in (trellis_scanfree._DIAG_NE, trellis_scanfree._SUB1,
                trellis_scanfree._SUB2, trellis_scanfree._DIAG_E):
        assert np.all(pad[row] == -np.inf)
    assert np.all(pad[trellis_scanfree._ENTRY] == 0)
    assert np.all(pad[trellis_scanfree._EXIT] == 0)
    np.testing.assert_array_equal(coefs[trellis_scanfree._ENTRY, :s],
                                  comp.is_entry.astype(np.float32))
    np.testing.assert_array_equal(coefs[trellis_scanfree._EXIT, :s],
                                  comp.is_exit.astype(np.float32))
    # Entry states take no in-word predecessor; the band stays inside words.
    assert np.all(coefs[trellis_scanfree._SUB1, :s][comp.is_entry] == -np.inf)
    assert np.all(coefs[trellis_scanfree._PEN] == np.float32(comp.penalty))


def test_scanfree_single_frame_takes_scan_path(monkeypatch):
    """T < 2 has no recursion: the static fallback never builds the kernel."""
    def boom(*a, **k):
        raise AssertionError("kernel built for a single-frame batch")

    monkeypatch.setattr(trellis_scanfree, "_scanfree_impl", boom)
    comp = _composite(2, (5,))
    log_b = jnp.asarray(np.random.default_rng(3).normal(
        size=(5, 1, comp.num_states)).astype(np.float32))
    args = _args(comp, np.array([1, 1, 0, 1, 1]))
    ref = viterbi_composite_batch_fast(log_b, *args)
    got = viterbi_composite_batch_scanfree(log_b, *args)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))


def test_scanfree_compiled_fails_off_gpu():
    """interpret=False means compiled for the GPU; on the CPU the call fails
    instead of falling back to the interpreter."""
    comp = _composite(2, (5,))
    log_b = jnp.zeros((2, 4, comp.num_states), jnp.float32)
    with pytest.raises(Exception):
        viterbi_composite_batch_scanfree(log_b, *_args(comp, [4, 4]))


@pytest.mark.parametrize("words", [12, 250])
def test_scanfree_lowers_for_cuda(words):
    """The Triton lowering rules accept the kernel (one and several chunks):
    a CUDA lowering of the jitted call holds the Triton custom call."""
    comp = _composite(words, (5, 5, 3))
    args = _args(comp, [7, 3])[:5]
    log_b = jax.ShapeDtypeStruct((2, 7, comp.num_states), jnp.float32)
    lengths = jax.ShapeDtypeStruct((2,), jnp.int32)
    fn = jax.jit(lambda lb, le: viterbi_composite_batch_scanfree(lb, *args, le))
    text = fn.trace(log_b, lengths).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


def _decoder_models(labels, seed):
    rng = np.random.default_rng(seed)
    models = {}
    for lab in labels:
        s = 3 if lab == "S" else 5
        means = rng.normal(size=(s, 39)).astype(np.float32) * 2
        covs = np.tile(np.eye(39, dtype=np.float32), (s, 1, 1))
        models[lab] = WordHMM(label=lab, means=means, covariances=covs,
                              log_a=uniform_forward_log_a(s))
    return models, rng


def test_decoder_scanfree_backend(interpret_kernel):
    """End-to-end through ContinuousDecoder(backend='scanfree')."""
    from cs304_tpu.models.decoder import ContinuousDecoder

    models, rng = _decoder_models(("1", "2", "S"), 4)
    clips = [rng.normal(size=(40, 39)).astype(np.float32) for _ in range(8)]
    ref = ContinuousDecoder(models, penalty=-50.0, backend="fast").predict_batch(clips)
    got = ContinuousDecoder(models, penalty=-50.0, backend="scanfree").predict_batch(clips)
    assert got == ref


@pytest.mark.parametrize("platform,expected", [
    ("gpu", "scanfree"), ("cpu", "fast"),
])
def test_decoder_auto_backend_resolves(monkeypatch, platform, expected):
    """backend='auto' resolves by platform through the one capability
    switch — and never reaches the kernel with an LM or a beam."""
    from cs304_tpu.models.decoder import ContinuousDecoder
    from cs304_tpu.ops.lm import train_word_bigram

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    models, _ = _decoder_models(("1", "2", "S"), 4)
    assert ContinuousDecoder(models).backend == expected
    assert ContinuousDecoder(models, beam=50.0).backend == "fast"
    lm = train_word_bigram([("1", "2"), ("2", "1")], ["1", "2", "S"])
    assert ContinuousDecoder(models, bigram=lm).backend == "fast"


def test_unknown_platform_is_an_error(monkeypatch):
    from cs304_tpu.ops.pallas import platform

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        platform()


def test_decoder_scanfree_quad_fused_route(interpret_kernel):
    """backend='scanfree' + emissions='quad' (XLA quad emissions fused into
    one program with the kernel) agrees with the quad + banded-fast decode."""
    from cs304_tpu.models.decoder import ContinuousDecoder

    models, rng = _decoder_models(("1", "2", "3", "S"), 7)
    clips = [rng.normal(size=(40, 39)).astype(np.float32) for _ in range(8)]
    ref = ContinuousDecoder(models, penalty=-50.0, backend="fast",
                            emissions="quad").predict_batch(clips)
    got = ContinuousDecoder(models, penalty=-50.0, backend="scanfree",
                            emissions="quad").predict_batch(clips)
    assert got == ref


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,words", [(512, 151, 11), (64, 151, 1000)],
                         ids=["s58", "s5003"])
def test_scanfree_compiled_matches_fast(gpu, b, t, words):
    """On the card, at real widths: the compiled kernel is bitwise the
    banded fast scan (58 states at B=512, 5003 states)."""
    comp = stack_word_models(
        [WordHMM(label=f"w{i:04d}", means=np.zeros((5, 4), np.float32),
                 covariances=np.tile(np.eye(4, dtype=np.float32), (5, 1, 1)),
                 log_a=uniform_forward_log_a(5)) for i in range(words)]
        + [WordHMM(label="S", means=np.zeros((3, 4), np.float32),
                   covariances=np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)),
                   log_a=uniform_forward_log_a(3))],
        penalty=-25.0,
    )
    rng = np.random.default_rng(0)
    log_b = jnp.asarray(
        rng.normal(size=(b, t, comp.num_states)).astype(np.float32) * 3)
    lens = rng.integers(2, t + 1, size=b)
    _assert_bitwise(log_b, _args(comp, lens), quirk=True, interpret=False)
