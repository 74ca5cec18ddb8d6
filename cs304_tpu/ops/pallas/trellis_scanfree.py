"""Scan-free composite Viterbi: forward trellis + backtrace in one GPU kernel.

ops.viterbi.viterbi_composite_batch_fast runs the recursion as two XLA scans
(~T forward and ~T backtrace steps). Each step is a few tiny fused kernels plus
while-loop control, and the work per step is only ~B*S*10 flops, so on a GPU
the recursion is bound by launches and latency. This kernel moves the whole
time loop inside one program (Pallas, Triton route):

- one program owns a tile of `tile_b` utterances for all T steps;
- alpha lives in a double-buffered scratch row per utterance, read back with
  offsets -1/-2 for the banded predecessors (Triton has no lane roll). Two
  -inf guard cells in front of state 0 keep every shifted read in bounds;
- states are processed in power-of-two chunks, so S=58 is one 64-wide chunk
  and S=5003 is five 1024-wide chunks; the best-exit pool (a max over ALL
  exits) is accumulated chunk by chunk while alpha is written, and feeds the
  next step;
- log_b is read and backpointers are written per step; the backtrace is an
  in-kernel loop of per-utterance gathers over those backpointers.

Semantics are bitwise those of viterbi_composite_batch_fast: the same f32
adds in the same order, the same candidate order and first-max ties, the same
live-step masking, the same termination and the same reference backtrace
quirk (applied after the kernel). tests/test_pallas_scanfree.py and
tests/test_tie_break.py assert this in interpret mode.

Reference hot loops being replaced: hidden_markov_model.py:481-581 (forward),
:573-581 (backtrace).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

NEG = np.float32(-np.inf)
# Two -inf cells before state 0 in each alpha scratch row: the j-1 and j-2
# predecessor reads of states 0 and 1 land there instead of out of bounds.
GUARD = 2
MAX_CHUNK = 1024
# Coefficient rows (see _pack_coefs).
_DIAG_NE, _SUB1, _SUB2, _DIAG_E, _ENTRY, _EXIT, _DIAG_INIT, _PEN = range(8)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def choose_tiles(s: int):
    """(chunk, n_chunks, num_warps) for an s-state trellis.

    chunk is the power-of-two state width a program processes at once (at
    most MAX_CHUNK), with one warp per 128 states of it (at most 8). One
    program owns one utterance: on an H100 at B=512, S=58 that measured
    faster than 2, 4 or 8 utterances per program (PERF.md)."""
    chunk = min(_next_pow2(s), MAX_CHUNK)
    return chunk, -(-s // chunk), max(1, min(8, chunk // 128))


def _pack_coefs(log_a, lower_of_state, is_entry, is_exit, penalty, s_pad: int):
    """The O(S) banded coefficients of viterbi_composite_batch_fast
    (viterbi.py), padded to s_pad states: padded states can never be
    entered, never exit and never score."""
    s = log_a.shape[0]
    to = jnp.arange(s)
    diag = jnp.diagonal(log_a)
    sub1 = jnp.where(
        (to >= 1) & (to - 1 >= lower_of_state) & ~is_entry,
        log_a[jnp.maximum(to - 1, 0), to], -jnp.inf,
    )
    sub2 = jnp.where(
        (to >= 2) & (to - 2 >= lower_of_state) & ~is_entry,
        log_a[jnp.maximum(to - 2, 0), to], -jnp.inf,
    )
    diag_ne = jnp.where(~is_entry, diag, -jnp.inf)
    diag_e = jnp.where(is_entry, diag, -jnp.inf)
    diag_init = jnp.where(jnp.isfinite(diag), diag, 0.0)

    def pad(v, fill):
        return jnp.full((s_pad,), fill, jnp.float32).at[:s].set(
            v.astype(jnp.float32)
        )

    return jnp.stack([
        pad(diag_ne, -jnp.inf),
        pad(sub1, -jnp.inf),
        pad(sub2, -jnp.inf),
        pad(diag_e, -jnp.inf),
        pad(is_entry.astype(jnp.float32), 0.0),
        pad(is_exit.astype(jnp.float32), 0.0),
        pad(diag_init, 0.0),
        jnp.full((s_pad,), penalty, jnp.float32),
    ])


def _trellis_kernel(coef_ref, len_ref, log_b_ref,
                    score_ref, path_ref, bp_ref, alpha_ref,
                    *, n_states, t_total, chunk, n_chunks, interpret):
    """One utterance per program. coef (8, S_pad), lengths (B,),
    log_b (B, T, S) -> scores (B,), paths (B, T) without the quirk, and two
    scratch outputs: backpointers (B, T, S_pad) and alpha
    (2, B, GUARD + S_pad). Values are (1, chunk) rows throughout."""
    b = pl.program_id(0)
    row = pl.ds(b, 1)
    lane = jnp.arange(chunk, dtype=jnp.int32)[None, :]
    length = len_ref[row]  # (1,)

    def sync():
        # Alpha and backpointers cross threads through memory; the
        # interpreter runs a program sequentially and needs no barrier.
        if not interpret:
            plt.debug_barrier()

    def coef(k, c0):
        return coef_ref[k, pl.ds(c0, chunk)][None, :]

    def log_b_at(t, c0):
        return plt.load(log_b_ref.at[row, t, pl.ds(c0, chunk)],
                        mask=c0 + lane < n_states, other=0.0)

    def exit_pool(vals, c0, carry):
        """Fold one chunk into the running (best exit, first argmax)."""
        best, idx = carry
        ex = jnp.where(coef(_EXIT, c0) > 0.0, vals, NEG)
        m = jnp.max(ex, axis=1)
        i = jnp.min(jnp.where(ex == m[:, None], c0 + lane, 2**30), axis=1)
        # Chunks ascend in state index: a later chunk wins only strictly.
        return jnp.where(m > best, m, best), jnp.where(m > best, i, idx)

    def chunk_loop(body, carry):
        if n_chunks == 1:
            return body(0, carry)
        return jax.lax.fori_loop(
            0, n_chunks, lambda c, cr: body(c * chunk, cr), carry
        )

    pool0 = (jnp.full((1,), NEG, jnp.float32), jnp.zeros((1,), jnp.int32))
    guard = jnp.full((1, GUARD), NEG, jnp.float32)
    alpha_ref[0, row, pl.ds(0, GUARD)] = guard
    alpha_ref[1, row, pl.ds(0, GUARD)] = guard

    def init_chunk(c0, pool):
        # alpha0 = entry ? log_b[0] + diag_init : -inf  (viterbi.py)
        a = jnp.where(coef(_ENTRY, c0) > 0.0,
                      log_b_at(0, c0) + coef(_DIAG_INIT, c0), NEG)
        alpha_ref[0, row, pl.ds(GUARD + c0, chunk)] = a
        return exit_pool(a, c0, pool)

    pool = chunk_loop(init_chunk, pool0)
    sync()

    def step(t, pool):
        src = jax.lax.rem(t - 1, 2)
        dst = 1 - src
        best, best_idx = pool

        def step_chunk(c0, new_pool):
            alpha = alpha_ref[src, row, pl.ds(GUARD + c0, chunk)]
            a1 = alpha_ref[src, row, pl.ds(GUARD + c0 - 1, chunk)]
            a2 = alpha_ref[src, row, pl.ds(GUARD + c0 - 2, chunk)]
            to = c0 + lane
            c0v = alpha + coef(_DIAG_NE, c0)
            c1 = a1 + coef(_SUB1, c0)
            c2 = a2 + coef(_SUB2, c0)
            # First-max tie-break over predecessor order (j-2, j-1, j).
            v12 = jnp.maximum(c1, c0v)
            val_ne = jnp.maximum(c2, v12)
            bp_ne = jnp.where(
                c2 >= v12, jnp.maximum(to - 2, 0),
                jnp.where(c1 >= c0v, jnp.maximum(to - 1, 0), to),
            )
            c_pen = best[:, None] + coef(_PEN, c0)
            c_self = alpha + coef(_DIAG_E, c0)
            # Exits beat the self-loop on ties (reference order).
            val_e = jnp.maximum(c_pen, c_self)
            bp_e = jnp.where(c_pen >= c_self, best_idx[:, None], to)
            entry = coef(_ENTRY, c0) > 0.0
            new_alpha = jnp.where(entry, val_e, val_ne) + log_b_at(t, c0)
            alpha_ref[dst, row, pl.ds(GUARD + c0, chunk)] = new_alpha
            bp_ref[row, t, pl.ds(c0, chunk)] = jnp.where(entry, bp_e, bp_ne)
            return exit_pool(new_alpha, c0, new_pool)

        new_pool = chunk_loop(step_chunk, pool0)
        sync()
        return new_pool

    # Steps t >= length are no-ops (viterbi.py's live mask), so the loop
    # stops at the utterance's own length.
    t_hi = jnp.minimum(jnp.max(length), t_total)
    best, state = jax.lax.fori_loop(1, t_hi, step, pool)
    score_ref[row] = best

    # Backtrace (viterbi.py:_backtrace): path[t] is the state before
    # stepping t; bp[t] is read only while t <= length - 1.
    def back(i, state):
        t = t_total - 1 - i
        path_ref[row, t] = state
        live = t <= length - 1
        nxt = plt.load(bp_ref.at[b, t, state], mask=live, other=0)
        return jnp.where(live, nxt, state)

    state = jax.lax.fori_loop(0, t_total - 1, back, state)
    path_ref[row, 0] = state


def viterbi_composite_batch_scanfree(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths,
    quirk_backtrace: bool = True, interpret: bool = False,
):
    """Drop-in replacement for viterbi_composite_batch_fast.

    log_b (B, T, S) f32, lengths (B,) i32 -> (scores (B,), paths (B, T) i32).
    interpret=True runs the kernel in the Pallas interpreter (tests only);
    otherwise it is compiled for the GPU, and elsewhere the call fails. A
    single-frame batch (T < 2) has no recursion and takes the scan path."""
    if log_b.shape[1] < 2:
        from ..viterbi import viterbi_composite_batch_fast

        return viterbi_composite_batch_fast(
            log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths,
            quirk_backtrace=quirk_backtrace,
        )
    return _scanfree_impl(
        log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths,
        quirk_backtrace, interpret,
    )


@partial(jax.jit, static_argnames=("quirk_backtrace", "interpret"))
def _scanfree_impl(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths,
    quirk_backtrace: bool, interpret: bool,
):
    b, t_total, s = log_b.shape
    chunk, n_chunks, num_warps = choose_tiles(s)
    s_pad = n_chunks * chunk
    coefs = _pack_coefs(
        jnp.asarray(log_a), jnp.asarray(lower_of_state),
        jnp.asarray(is_entry), jnp.asarray(is_exit), penalty, s_pad,
    )
    lengths = jnp.asarray(lengths, jnp.int32)
    kernel = partial(
        _trellis_kernel, n_states=s, t_total=t_total, chunk=chunk,
        n_chunks=n_chunks, interpret=interpret,
    )
    scores, paths, _bp, _alpha = pl.pallas_call(
        kernel,
        grid=(b,),
        out_shape=[
            jax.ShapeDtypeStruct((b,), jnp.float32),
            jax.ShapeDtypeStruct((b, t_total), jnp.int32),
            jax.ShapeDtypeStruct((b, t_total, s_pad), jnp.int32),
            jax.ShapeDtypeStruct((2, b, GUARD + s_pad), jnp.float32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="viterbi_scanfree",
    )(coefs, lengths, log_b.astype(jnp.float32))
    if quirk_backtrace:
        bidx = jnp.arange(b)
        last = jnp.maximum(lengths - 1, 0)
        second = jnp.maximum(lengths - 2, 0)
        paths = paths.at[bidx, last].set(paths[bidx, second])
    return scores, paths
