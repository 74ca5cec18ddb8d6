"""Device-side path -> word-sequence compaction.

The composite decoder's trellis produces a per-frame state path (T,); the
serving product is the word label sequence. The reference walks the path on
the host (ModelBoundary.get_labels, model_boundary.py:107-139); this package's
host mirror is CompositeHMM.path_to_labels (models/hmm.py:138-156). Both cost
a (B, T) int32 path readback per batch.

This module does the compaction ON DEVICE as a vectorized epilogue fused into
the decode program: emit flags (word change, or exit->entry re-entry of the
same word — the repeated-word rule), cumsum positions, and a bounded scatter
into a (max_words,) buffer. The host then reads back only (B, max_words)
word ids + counts (~20x smaller than the padded path) and maps ids to label
strings. Exact-parity with path_to_labels is asserted in tests/test_words.py
by fuzzing arbitrary state sequences.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["words_from_path", "words_from_paths"]


@partial(jax.jit, static_argnames=("max_words", "out_dtype"))
def words_from_path(
    path,
    length,
    word_of_state,
    lowers,
    uppers,
    silence_word,
    max_words: int = 32,
    out_dtype=jnp.int32,
):
    """Compact one state path into emitted word ids.

    path (T,) int32 composite-state indices (frames past ``length`` ignored);
    word_of_state (S,) state -> word index; lowers/uppers (W,) word entry/exit
    states; silence_word: word index to drop (pass -1 to keep silence, i.e.
    skip_silence=False). Returns (ids (max_words,) padded with -1, n) where n
    is the TRUE emitted count — n > max_words means the buffer truncated
    (callers pick max_words >= the longest legal transcript, so in practice
    the bound is never hit; it is detectable when it is).

    Mirrors CompositeHMM.path_to_labels (models/hmm.py:138-156), itself the
    reference's ModelBoundary.get_labels (model_boundary.py:107-139): a word
    is emitted at the first frame, at any frame whose state belongs to a
    different word than the previous frame, and at an exit->entry hop back
    into the SAME word (the repeated-word rule, model_boundary.py:131-135).
    Run-length compression is implicit: a frame whose state equals the
    previous frame's state is never a point.
    """
    # Gather/scatter-free: the compaction is compares + masked integer
    # one-hot reductions + a cumsum, all elementwise work that fuses.
    # (This form was chosen over per-element gathers and a position
    # scatter on a different accelerator; on the GPU the choice is not
    # measured yet.)
    path = path.astype(jnp.int32)
    t = path.shape[0]
    w_num = lowers.shape[0]
    idx = jnp.arange(t)
    prev = jnp.concatenate([path[:1], path[:-1]])
    # word_of_state is monotone over the stacked state space, so the gather
    # is a rank query: word[t] = #{w : lowers[w] <= path[t]} - 1.
    word = jnp.sum(
        path[:, None] >= lowers[None, :], axis=-1, dtype=jnp.int32
    ) - 1
    prev_word = jnp.sum(
        prev[:, None] >= lowers[None, :], axis=-1, dtype=jnp.int32
    ) - 1
    # uppers[word] / lowers[word] as (T, W) one-hot contractions — INTEGER
    # masked reductions, not f32 matmuls: a default-precision f32 dot is
    # TF32 on the GPU (exact only for integers <= 2048) and a bf16 pass
    # elsewhere (<= 256), while these values reach S ~ 5003 at a 1000-word
    # vocabulary. The integer reduce is exact at any vocabulary size and
    # costs the same O(T*W) pass.
    woh = word[:, None] == jnp.arange(w_num)[None, :]
    up_of = jnp.sum(jnp.where(woh, uppers.astype(jnp.int32)[None, :], 0),
                    axis=-1)
    lo_of = jnp.sum(jnp.where(woh, lowers.astype(jnp.int32)[None, :], 0),
                    axis=-1)
    new_point = (idx == 0) | (path != prev)
    reentry = (prev == up_of) & (path == lo_of)
    emit = new_point & (
        (idx == 0) | (word != prev_word) | reentry
    )
    emit = emit & (idx < length) & (word != silence_word)
    pos = jnp.cumsum(emit) - 1
    n = jnp.sum(emit).astype(jnp.int32)
    # Position scatter as a (max_words, T) one-hot contraction — integer
    # masked reduce for the same reason as above (word ids reach 1000).
    slotoh = (
        pos[:, None] == jnp.arange(max_words)[None, :]
    ) & emit[:, None]
    ids_i = jnp.sum(jnp.where(slotoh, word[:, None], 0), axis=0)
    ids = jnp.where(jnp.arange(max_words) < n, ids_i, -1).astype(out_dtype)
    return ids, n


@partial(jax.jit, static_argnames=("max_words", "out_dtype"))
def words_from_paths(
    paths,
    lengths,
    word_of_state,
    lowers,
    uppers,
    silence_word,
    max_words: int = 32,
    out_dtype=jnp.int32,
):
    """Batched ``words_from_path``: (B, T) paths + (B,) lengths ->
    ((B, max_words) ids, (B,) counts)."""
    return jax.vmap(
        lambda p, l: words_from_path(
            p, l, word_of_state, lowers, uppers, silence_word,
            max_words=max_words, out_dtype=out_dtype,
        )
    )(paths, lengths)


def ids_to_strings(ids, counts, labels) -> list:
    """Host epilogue: (B, W) ids + (B,) counts -> list of label strings.

    Truncation (counts[i] > W) surfaces as a ValueError rather than a
    silently shortened transcript.
    """
    import numpy as np

    ids = np.asarray(ids)
    counts = np.asarray(counts)
    w = ids.shape[1]
    out = []
    for row, n in zip(ids, counts):
        if n > w:
            raise ValueError(
                f"word buffer truncated: {n} words emitted, max_words={w}"
            )
        out.append("".join(labels[i] for i in row[: int(n)]))
    return out
