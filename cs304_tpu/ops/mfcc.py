"""Vectorized MFCC front-end, bit-comparable to the reference's librosa pipeline.

Reference pipeline (src/loe_speech_recognition/mfcc.py:24-44):
  melspectrogram(y, sr, n_mels=40, n_fft=320, hop=160, fmin=133.33, fmax=6855.4976)
  -> power_to_db(ref=max)            (amin=1e-10, top_db=80)
  -> mfcc(n_mfcc=13)                 (DCT-II, ortho, over the mel axis)
  -> delta / delta-delta             (Savitzky-Golay width=9, mode='interp')
  -> concat([normalize(mfcc), d1, d2])  (T, 39)

The reference's `normalize_mfccs` (mfcc.py:50-69) normalizes across the 13
coefficients *per frame* (axis=0 of the (13, T) array), despite its docstring
claiming per-coefficient-over-time; we replicate that exactly for parity
(SURVEY.md §7 "known defects").

Everything here is a static linear operator: framing decomposes into
gcd-sized signal blocks (a plain reshape at the flagship hop == n_fft/2; see
_power_spectrogram for the general strided-block form covering e.g. the
standard 25 ms/10 ms config), the real DFT is windowed (block, bins) matmuls,
the mel filterbank and DCT are matmuls, and the Savitzky-Golay deltas are a
small convolution plus two static edge matrices. All of it is dense linear
algebra that fuses under jit; the whole corpus runs as one vmapped batch instead of
the reference's per-clip Python loop (mfcc.py:71-84).

Padded-batch correctness: per-utterance reductions (the db reference max, the
top_db clamp, the 'interp' right edge of the deltas) are masked/dynamically
sliced by the true frame count, so padding never perturbs features.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


# ----------------------------------------------------------------------------
# Static constants (host-side NumPy, computed once at import)
# ----------------------------------------------------------------------------

def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(f, 1e-20) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = m >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


def mel_filterbank(
    sr: float, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-style mel filterbank, identical to librosa.filters.mel(htk=False,
    norm='slaney'). Returns (n_mels, 1 + n_fft // 2)."""
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def dct_ortho_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in), matching scipy.fft.dct(norm='ortho')."""
    n = np.arange(n_in)
    k = np.arange(n_out)[:, None]
    m = np.cos(np.pi * k * (2 * n[None, :] + 1) / (2 * n_in))
    m *= np.sqrt(2.0 / n_in)
    m[0] *= np.sqrt(0.5)
    return m.astype(np.float32)


def _savgol_operators(width: int, polyorder: int, deriv: int):
    """Savitzky-Golay operators matching scipy.signal.savgol_filter(mode='interp').

    Returns (interior (width,), edge_left (half, width), edge_right (half, width)).
    interior is applied as a correlation centered on each frame; edge_left maps
    the first `width` samples to outputs 0..half-1; edge_right maps the last
    `width` samples to outputs -half..-1.
    """
    half = width // 2
    x = np.arange(width, dtype=np.float64)
    vand = np.vander(x, polyorder + 1, increasing=True)  # (width, p+1)
    pinv = np.linalg.pinv(vand)  # (p+1, width): data -> poly coeffs

    def deriv_eval_row(t: float) -> np.ndarray:
        row = np.zeros(polyorder + 1)
        for j in range(deriv, polyorder + 1):
            fac = 1.0
            for r in range(deriv):
                fac *= j - r
            row[j] = fac * t ** (j - deriv)
        return row

    interior = deriv_eval_row(half) @ pinv  # (width,)
    edge_left = np.stack([deriv_eval_row(t) @ pinv for t in range(half)])
    edge_right = np.stack(
        [deriv_eval_row(t) @ pinv for t in range(half + 1, width)]
    )
    return (
        interior.astype(np.float32),
        edge_left.astype(np.float32),
        edge_right.astype(np.float32),
    )


@dataclass(frozen=True)
class MFCCConfig:
    """Front-end hyperparameters (defaults = the reference's, mfcc.py:31-43)."""

    sample_rate: float = 16000.0
    n_fft: int = 320
    hop_length: int = 160
    n_mels: int = 40
    n_mfcc: int = 13
    fmin: float = 133.33
    fmax: float = 6855.4976
    amin: float = 1e-10
    top_db: float = 80.0
    delta_width: int = 9
    normalize_eps: float = 1e-8
    # Spectrogram backend: "matmul" (explicit f32-HIGHEST DFT matmuls,
    # default) or "fft" (XLA real FFT). The matmul default was chosen on a
    # different accelerator, where it beat the FFT end to end; on the GPU the
    # choice is not measured yet. Both match librosa within fp32 tolerance.
    spectrogram: str = "matmul"
    # Matmul precision: "highest" (true f32, bit-comparable features,
    # default) or "high" (three bf16 passes with f32 accumulation, named
    # explicitly because Precision.HIGH is TF32 on the GPU; max feature
    # delta measured 0.033 — fine for accuracy, not for bitwise parity).
    precision: str = "highest"
    # Feature normalization: "per_frame" replicates the reference's quirky
    # across-coefficients-per-frame normalization of the statics (mfcc.py:62-66
    # — deltas left raw); "cmn" subtracts the per-utterance mean of all 39 dims
    # over time (masked to real frames); "cmvn" additionally divides by the
    # per-dim std. A linear channel adds a near-constant per-coefficient offset
    # in the cepstral domain, so CMN cancels coloration that the per-frame form
    # cannot — while keeping the level/dynamics cues the silence model needs.
    # Full CMVN whitens those cues away and measurably collapses embedded
    # training on the hardened corpus (54% vs 93%); see
    # benchmarks/accuracy_bench.py --normalization.
    normalization: str = "per_frame"

    @property
    def feature_dim(self) -> int:
        return 3 * self.n_mfcc

    def num_frames(self, num_samples: int) -> int:
        """Centered STFT frame count: 1 + len // hop (librosa center=True)."""
        return 1 + num_samples // self.hop_length


def _constants(cfg: MFCCConfig):
    n_bins = 1 + cfg.n_fft // 2
    n = np.arange(cfg.n_fft)
    # Periodic Hann window (scipy.signal.get_window('hann', fftbins=True)).
    hann = (0.5 - 0.5 * np.cos(2 * np.pi * n / cfg.n_fft)).astype(np.float32)
    k = np.arange(n_bins)
    ang = 2 * np.pi * np.outer(n, k) / cfg.n_fft
    dft_cos = (np.cos(ang) * hann[:, None]).astype(np.float32)  # window folded in
    dft_sin = (-np.sin(ang) * hann[:, None]).astype(np.float32)
    mel_fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    dct_m = dct_ortho_matrix(cfg.n_mfcc, cfg.n_mels)
    d1 = _savgol_operators(cfg.delta_width, 1, 1)
    d2 = _savgol_operators(cfg.delta_width, 2, 2)
    return hann, dft_cos, dft_sin, mel_fb, dct_m, d1, d2


_CONST_CACHE: dict = {}


def _cached_constants(cfg: MFCCConfig):
    # Cache host NumPy arrays only: they embed as XLA constants at trace time.
    # (Caching jnp arrays created inside a trace would leak tracers.)
    if cfg not in _CONST_CACHE:
        _CONST_CACHE[cfg] = _constants(cfg)
    return _CONST_CACHE[cfg]


def _precision(cfg: MFCCConfig):
    return (
        jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3 if cfg.precision == "high"
        else jax.lax.Precision.HIGHEST
    )


def _framing_blocks(cfg: MFCCConfig) -> int:
    """Block size g for matmul framing: the largest unit that tiles both the
    hop grid and the center pad, so frame t = g-blocks [t*hop/g, ... +n_fft/g).
    g == hop iff hop*2 == n_fft (the flagship reshape path)."""
    import math

    return math.gcd(math.gcd(cfg.n_fft, cfg.hop_length), cfg.n_fft // 2)


def _gather_frames(signal: jax.Array, cfg: MFCCConfig, t_frames: int):
    """General centered framing: (L,) -> (t_frames, n_fft), zero pad_mode.

    Gather-based fallback for configs whose (n_fft, hop) share no useful
    block structure (e.g. odd sizes); the block paths below never call this
    for the flagship or the standard 25 ms/10 ms configs."""
    pad = cfg.n_fft // 2
    padded = jnp.pad(signal, (pad, cfg.n_fft))
    idx = (
        cfg.hop_length * np.arange(t_frames)[:, None]
        + np.arange(cfg.n_fft)[None, :]
    )
    return padded[idx]


def _power_spectrogram(signal: jax.Array, cfg: MFCCConfig, dft_cos, dft_sin):
    """(L,) -> (T, n_bins) power spectrogram, centered, zero pad_mode.

    Framing never materializes (T, n_fft) windows on the fast paths: the
    center-padded signal is split into g-sample blocks (g = gcd of n_fft,
    hop, and the n_fft//2 center pad), frame t is blocks
    [t*(hop/g) .. t*(hop/g) + n_fft/g), and each block position hits its own
    (g, bins) slice of the DFT matrix — so the DFT is n_fft/g strided-slice
    matmuls summed, paying each input sample once per covering frame. With
    the flagship hop == n_fft/2 this degenerates to the 2-block reshape
    trick; the standard 25 ms/10 ms config (n_fft=400, hop=160) gets g=40.
    """
    hop = cfg.hop_length
    length = signal.shape[0]
    t_frames = 1 + length // hop
    g = _framing_blocks(cfg)
    prec = _precision(cfg)
    if cfg.spectrogram == "fft":
        hann, *_ = _cached_constants(cfg)
        if hop * 2 == cfg.n_fft:
            pad_tail = hop + (-(length + 2 * hop) % hop) + hop
            padded = jnp.pad(signal, (hop, pad_tail))
            blocks = padded.reshape(-1, hop)
            frames = jnp.concatenate(
                [blocks[:-1], blocks[1:]], axis=1
            )[:t_frames]
        else:
            frames = _gather_frames(signal, cfg, t_frames)
        spec = jnp.fft.rfft(frames * hann[None, :], axis=-1)
        return jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    # "matmul": explicit DFT at cfg.precision (HIGHEST = f32-exact default;
    # reduced-precision dots at lower settings cost bit-comparability).
    if hop * 2 == cfg.n_fft:
        # Flagship path: frame t = blocks[t] ++ blocks[t+1], each block hits
        # each half of the DFT matrix exactly once — half the matmul FLOPs of
        # the naive (T, n_fft) x (n_fft, bins) product. Summation order
        # differs from the single-dot form only in the final f32 add of two
        # exact halves (<1e-6 relative), within every parity tolerance.
        pad_tail = hop + (-(length + 2 * hop) % hop) + hop
        padded = jnp.pad(signal, (hop, pad_tail))
        blocks = padded.reshape(-1, hop)
        n_blocks_used = t_frames + 1  # frame t needs blocks t and t+1
        blk = blocks[:n_blocks_used]
        re_lo = jnp.dot(blk, dft_cos[:hop], precision=prec)
        re_hi = jnp.dot(blk, dft_cos[hop:], precision=prec)
        im_lo = jnp.dot(blk, dft_sin[:hop], precision=prec)
        im_hi = jnp.dot(blk, dft_sin[hop:], precision=prec)
        re = re_lo[:-1] + re_hi[1:]
        im = im_lo[:-1] + im_hi[1:]
        return re * re + im * im
    if g >= 16:
        # General block path: parts = n_fft/g strided-slice matmuls.
        stride = hop // g
        parts = cfg.n_fft // g
        pad_left = cfg.n_fft // 2  # a multiple of g by construction
        n_blocks = (t_frames - 1) * stride + parts
        pad_right = max(0, n_blocks * g - pad_left - length)
        padded = jnp.pad(signal, (pad_left, pad_right))[: n_blocks * g]
        blocks = padded.reshape(n_blocks, g)
        re = im = 0.0
        for b in range(parts):
            part = blocks[b : b + (t_frames - 1) * stride + 1 : stride]
            re = re + jnp.dot(
                part, dft_cos[b * g : (b + 1) * g], precision=prec
            )
            im = im + jnp.dot(
                part, dft_sin[b * g : (b + 1) * g], precision=prec
            )
        return re * re + im * im
    frames = _gather_frames(signal, cfg, t_frames)
    re = jnp.dot(frames, dft_cos, precision=prec)
    im = jnp.dot(frames, dft_sin, precision=prec)
    return re * re + im * im


def _power_to_db(mel_power: jax.Array, frame_mask: jax.Array, cfg: MFCCConfig):
    """librosa.power_to_db(ref=np.max) with the per-utterance max masked to
    real frames. mel_power: (T, n_mels); frame_mask: (T,) bool."""
    log10 = jnp.log(10.0)
    log_spec = 10.0 * jnp.log(jnp.maximum(cfg.amin, mel_power)) / log10
    masked = jnp.where(frame_mask[:, None], mel_power, 0.0)
    ref = jnp.max(masked)
    log_spec = log_spec - 10.0 * jnp.log(jnp.maximum(cfg.amin, ref)) / log10
    peak = jnp.max(jnp.where(frame_mask[:, None], log_spec, -jnp.inf))
    return jnp.maximum(log_spec, peak - cfg.top_db)


def _savgol_interp(x: jax.Array, n_frames: jax.Array, ops, width: int,
                   precision=None):
    """Savitzky-Golay filter along axis 0 with scipy's mode='interp' edges.

    x: (T, C) padded; n_frames: true frame count (traced). The right edge is a
    dynamic slice of the last `width` real frames.
    """
    del precision  # kept for API compat; everything below is exact f32 VPU
    interior, edge_left, edge_right = ops
    half = width // 2
    t_total, c = x.shape
    # Interior: correlation along time as `width` scalar-weighted shifted
    # adds: elementwise work that fuses at full f32, with no precision knob.
    # (This form was chosen over a conv or a K=9 einsum on a different
    # accelerator; on the GPU the choice is not measured yet.)
    xp = jnp.pad(x, ((half, half), (0, 0)))
    y = sum(float(interior[k]) * xp[k:k + t_total] for k in range(width))

    # Left edge: static rows, same scalar-weighted form.
    left = jnp.stack([
        sum(float(edge_left[r, k]) * x[k] for k in range(width))
        for r in range(half)
    ])
    y = y.at[:half].set(left)

    # Right edge, gather-free (per-batch dynamic_slice + gather cost 3.5 ms
    # at B=1024): S_r[j] = sum_k er[r,k] x[j+k] is computed for every j as
    # shifted adds; the single needed j0 = n_frames - width is picked out
    # with a masked reduction, and scattered to row n_frames - half + r with
    # a masked select. All full-array VPU ops, bitwise equal to the dot form.
    xr = jnp.pad(x, ((0, width), (0, 0)))
    row_idx = jnp.arange(t_total)[:, None]
    j0 = jnp.clip(n_frames - width, 0)
    at_j0 = (row_idx == j0)
    out = y
    for r in range(half):
        s_r = sum(float(edge_right[r, k]) * xr[k:k + t_total]
                  for k in range(width))  # (T, C)
        val = jnp.sum(jnp.where(at_j0, s_r, 0.0), axis=0, keepdims=True)
        out = jnp.where(row_idx == (n_frames - half + r), val, out)
    return out


def _normalize_per_frame(mfcc: jax.Array, cfg: MFCCConfig) -> jax.Array:
    """The reference's quirky normalization: mean/std across the coefficient
    axis for each frame (mfcc.py:62-66 operates on axis=0 of (13, T))."""
    mean = jnp.mean(mfcc, axis=-1, keepdims=True)
    std = jnp.std(mfcc, axis=-1, keepdims=True)
    return (mfcc - mean) / (std + cfg.normalize_eps)


@partial(jax.jit, static_argnames=("cfg",))
def mfcc_features(
    signal: jax.Array, num_samples=None, cfg: MFCCConfig = MFCCConfig()
):
    """(L,) float32 signal -> ((T, 39) features, T_valid).

    T = cfg.num_frames(L) is static; rows >= T_valid are padding when
    num_samples < L. Matches MFCC(signal, sr).feature_vector.T of the reference.
    """
    hann, dft_cos, dft_sin, mel_fb, dct_m, d1, d2 = _cached_constants(cfg)
    signal = jnp.asarray(signal, jnp.float32)
    if num_samples is None:
        num_samples = signal.shape[0]
    num_samples = jnp.asarray(num_samples, jnp.int32)
    n_frames = 1 + num_samples // cfg.hop_length
    # Zero the padding tail: the final centered frames overlap samples past
    # num_samples, which must read as silence exactly like librosa's own pad.
    signal = jnp.where(jnp.arange(signal.shape[0]) < num_samples, signal, 0.0)

    power = _power_spectrogram(signal, cfg, dft_cos, dft_sin)  # (T, bins)
    t_total = power.shape[0]
    frame_mask = jnp.arange(t_total) < n_frames

    prec = _precision(cfg)
    mel_power = jnp.dot(power, mel_fb.T, precision=prec)
    log_mel = _power_to_db(mel_power, frame_mask, cfg)
    mfcc = jnp.dot(log_mel, dct_m.T, precision=prec)

    delta1 = _savgol_interp(mfcc, n_frames, d1, cfg.delta_width, prec)
    delta2 = _savgol_interp(mfcc, n_frames, d2, cfg.delta_width, prec)
    if cfg.normalization in ("cmn", "cmvn"):
        raw = jnp.concatenate([mfcc, delta1, delta2], axis=-1)
        mask = frame_mask[:, None]
        count = jnp.maximum(n_frames.astype(jnp.float32), 1.0)
        mean = jnp.sum(jnp.where(mask, raw, 0.0), axis=0) / count
        feats = raw - mean
        if cfg.normalization == "cmvn":
            var = jnp.sum(jnp.where(mask, feats ** 2, 0.0), axis=0) / count
            feats = feats / (jnp.sqrt(var) + cfg.normalize_eps)
    else:
        feats = jnp.concatenate(
            [_normalize_per_frame(mfcc, cfg), delta1, delta2], axis=-1
        )
    feats = jnp.where(frame_mask[:, None], feats, 0.0)
    return feats, n_frames


@partial(jax.jit, static_argnames=("cfg",))
def mfcc_features_batch(
    signals: jax.Array, num_samples: jax.Array, cfg: MFCCConfig = MFCCConfig()
):
    """(B, L) padded signals + (B,) true lengths -> ((B, T, 39), (B,) frame counts)."""
    return jax.vmap(lambda s, n: mfcc_features(s, n, cfg))(signals, num_samples)


def mfcc_batch(signals, sample_rate: float = 16000.0, cfg: MFCCConfig | None = None,
               bucket: bool = True):
    """Host convenience mirroring MFCC.batch (reference mfcc.py:71-84).

    Takes a list of 1-D float arrays, returns a list of (T_i, 39) float32
    arrays. Pads to the max length, runs one vmapped device batch, slices back.

    bucket=True (default) rounds the padded length up to a 64-frame sample
    multiple and the batch size up to a power of two, so corpus-prep loops
    that call this per label (100+ distinct (B, L) shapes) hit a handful of
    compiled programs instead of risking one compile per distinct shape.
    Padding is semantically free: per-clip
    outputs are pinned padding-invariant
    (tests/test_mfcc.py::test_mfcc_padding_invariance).
    """
    if cfg is None:
        cfg = MFCCConfig(sample_rate=sample_rate)
    if not signals:
        raise ValueError("mfcc_batch: empty clip list (all clips filtered out?)")
    lengths = np.array([len(s) for s in signals], np.int32)
    # scipy/librosa raise when the Savitzky-Golay window exceeds the signal;
    # the jitted kernel would silently read zero padding instead. Reject here
    # (the only host entry point with concrete lengths).
    min_frames = 1 + int(lengths.min()) // cfg.hop_length
    if min_frames < cfg.delta_width:
        raise ValueError(
            f"clip with {min_frames} frames is shorter than delta_width="
            f"{cfg.delta_width}; librosa's delta filter rejects such inputs"
        )
    n = len(signals)
    l_max = int(lengths.max())
    b_rows = n
    if bucket:
        step = 64 * cfg.hop_length
        l_max = -(-l_max // step) * step
        b_rows = 1 << max(n - 1, 0).bit_length()
    batch = np.zeros((b_rows, l_max), np.float32)
    for i, s in enumerate(signals):
        batch[i, : len(s)] = np.asarray(s, np.float32)
    # Padded rows carry full length (valid frames over zeros, discarded) so
    # the kernel sees no zero-length edge case.
    lengths_pad = np.full(b_rows, l_max, np.int32)
    lengths_pad[:n] = lengths
    feats, n_frames = mfcc_features_batch(
        jnp.asarray(batch), jnp.asarray(lengths_pad), cfg
    )
    feats = np.asarray(feats)
    n_frames = np.asarray(n_frames)
    return [feats[i, : n_frames[i]] for i in range(n)]
