"""Acoustic frontend: framing -> STFT -> log-Mel -> CMVN -> SpecAugment.

Reference-side realization: offline Kaldi/librosa feature precompute
(C/C++-backed FFT) plus Python CMVN/SpecAugment [SURVEY.md §2.1 #4-#7,
INFERRED-med]. New-repo realization [BASELINE.json:L5,L8]: the whole
pipeline is an on-device jittable function of composed jnp ops (XLA
fuses the elementwise chain into the matmuls), numerically pinned
against scipy in tests.

Design choice: the STFT is realized as a *framed matmul against DFT
cosine/sine basis matrices* rather than an FFT — at win=400/n_fft=512
the dense DFT matmul fuses trivially with the mel-filterbank matmul
[SURVEY.md §7 hard part 3].
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.config import FrontendConfig


def num_frames(num_samples, win_length: int, hop_length: int):
    """Frame count under 'valid' framing (no centering). Works on ints and
    arrays. feat_len = 1 + floor((n - win) / hop), min 0."""
    if isinstance(num_samples, (int, np.integer)):
        return max(0, 1 + (int(num_samples) - win_length) // hop_length)
    n = (num_samples - win_length) // hop_length + 1
    return jnp.maximum(n, 0)


# ---------------------------------------------------------------------------
# Constant matrices (built once per config on host, closed over at trace time)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def dft_basis(win_length: int, n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis restricted to the first ``win_length`` rows (the
    remaining n_fft - win rows multiply zero-padding). Returns (cos, sin)
    with shape [win_length, n_fft//2 + 1], float32."""
    n_freq = n_fft // 2 + 1
    n = np.arange(win_length)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (matches scipy.signal 'hann', sym=False)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    n_mels: int, n_fft: int, sample_rate: int, fmin: float, fmax: float
) -> np.ndarray:
    """HTK-style triangular mel filterbank, shape [n_freq, n_mels]."""
    n_freq = n_fft // 2 + 1
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bin_hz = np.arange(n_freq) * (sample_rate / n_fft)
    fb = np.zeros((n_freq, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_hz - lo) / max(ctr - lo, 1e-9)
        down = (hi - bin_hz) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


# ---------------------------------------------------------------------------
# Pipeline stages (jnp)
# ---------------------------------------------------------------------------


def frame_signal(audio: jnp.ndarray, win_length: int, hop_length: int) -> jnp.ndarray:
    """[B, S] -> [B, F, win] overlapping frames via a static gather."""
    S = audio.shape[-1]
    F = num_frames(S, win_length, hop_length)
    idx = np.arange(F)[:, None] * hop_length + np.arange(win_length)[None, :]
    return audio[..., idx]


def log_mel_spectrogram(audio: jnp.ndarray, cfg: FrontendConfig) -> jnp.ndarray:
    """[B, S] -> [B, F, n_mels] log-mel features (no CMVN/SpecAugment).

    The windowed STFT is computed WITHOUT materializing overlapping
    frames (an explicit [B, F, win] gather, 2.5x the audio's bytes).
    Instead the audio is reshaped into hop-sized rows and the DFT basis
    (Hann window folded in) is applied as one matmul per hop-aligned
    window segment — same math, pure reshapes/slices + matmuls.
    """
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2.0
    cos_b, sin_b = dft_basis(cfg.win_length, cfg.n_fft)
    win = hann_window(cfg.win_length)
    mel = mel_filterbank(cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.fmin, float(fmax))

    B, S = audio.shape
    hop, winlen = cfg.hop_length, cfg.win_length
    F = num_frames(S, winlen, hop)
    basis = np.concatenate(
        [cos_b * win[:, None], sin_b * win[:, None]], axis=1
    )  # [W, 2*n_freq]
    n_hops = -(-winlen // hop)
    SP = (F + n_hops) * hop
    padded = jnp.pad(audio, ((0, 0), (0, max(0, SP - S))))
    rows = padded.reshape(B, -1, hop)
    # STFT as hop-segment matmuls; power spectrum; mel; log.
    # HIGHEST precision: log-domain features amplify reduced-precision
    # cancellation noise near the power floor (default float32 matmul
    # precision on the GPU is TF32).
    hp = jax.lax.Precision.HIGHEST
    out = None
    off = 0
    for k in range(n_hops):
        take = min(hop, winlen - off)
        piece = jnp.einsum(
            "bfh,hk->bfk", rows[:, k:k + F, :take],
            jnp.asarray(basis[off:off + take]), precision=hp)
        out = piece if out is None else out + piece
        off += take
    n_freq = cos_b.shape[1]
    power = out[..., :n_freq] ** 2 + out[..., n_freq:] ** 2  # [B,F,n_freq]
    melspec = jnp.einsum("bfk,km->bfm", power, jnp.asarray(mel), precision=hp)
    return jnp.log(jnp.maximum(melspec, cfg.log_floor))


def apply_cmvn(
    feats: jnp.ndarray,
    feat_len: jnp.ndarray,
    mode: str,
    stats: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
) -> jnp.ndarray:
    """Cepstral mean/variance normalization [SURVEY.md §2.1 #6].

    "utterance": per-utterance stats over valid frames (length-masked).
    "global": externally computed (mean, std) arrays of shape [n_mels],
    produced by ``compute_global_cmvn`` and stored beside checkpoints.
    """
    if mode == "none":
        return feats
    if mode == "global":
        assert stats is not None, "global CMVN requires stats"
        mean, std = stats
        return (feats - mean) / jnp.maximum(std, 1e-5)
    # per-utterance
    F = feats.shape[1]
    mask = (jnp.arange(F)[None, :] < feat_len[:, None]).astype(feats.dtype)
    denom = jnp.maximum(mask.sum(axis=1, keepdims=True), 1.0)[..., None]
    mean = (feats * mask[..., None]).sum(axis=1, keepdims=True) / denom
    var = ((feats - mean) ** 2 * mask[..., None]).sum(axis=1, keepdims=True) / denom
    return (feats - mean) / jnp.sqrt(var + 1e-10)


def compute_global_cmvn(feats: jnp.ndarray, feat_len: jnp.ndarray):
    """One-shot jitted pass producing global (mean, std) over a corpus batch."""
    F = feats.shape[1]
    mask = (jnp.arange(F)[None, :] < feat_len[:, None]).astype(feats.dtype)
    denom = jnp.maximum((mask.sum()), 1.0)
    mean = (feats * mask[..., None]).sum(axis=(0, 1)) / denom
    var = ((feats - mean) ** 2 * mask[..., None]).sum(axis=(0, 1)) / denom
    return mean, jnp.sqrt(var + 1e-10)


def spec_augment(
    feats: jnp.ndarray,
    feat_len: jnp.ndarray,
    rng: jax.Array,
    n_freq_masks: int,
    freq_width: int,
    n_time_masks: int,
    time_width: int,
) -> jnp.ndarray:
    """SpecAugment time/frequency masking [SURVEY.md §2.1 #7]. Masked cells
    are zeroed (post-CMVN zero == feature mean). All shapes static; mask
    geometry sampled per utterance from ``rng``."""
    B, F, M = feats.shape
    keys = jax.random.split(rng, 4)
    fidx = jnp.arange(M)[None, None, :]  # [1,1,M]
    tidx = jnp.arange(F)[None, None, :]  # [1,1,F]

    if n_freq_masks > 0 and freq_width > 0:
        w = jax.random.randint(keys[0], (B, n_freq_masks, 1), 0, freq_width + 1)
        start = jax.random.randint(keys[1], (B, n_freq_masks, 1), 0, jnp.maximum(M - w + 1, 1))
        hit = (fidx >= start) & (fidx < start + w)  # [B,nm,M]
        fmask = ~jnp.any(hit, axis=1)  # [B,M]
        feats = feats * fmask[:, None, :].astype(feats.dtype)

    if n_time_masks > 0 and time_width > 0:
        # Cap each time mask at both time_width and len/5 (adaptive).
        max_w = jnp.minimum(time_width, jnp.maximum(feat_len[:, None, None] // 5, 1))
        w = jax.random.randint(keys[2], (B, n_time_masks, 1), 0, time_width + 1)
        w = jnp.minimum(w, max_w)
        span = jnp.maximum(feat_len[:, None, None] - w + 1, 1)
        start = jax.random.randint(keys[3], (B, n_time_masks, 1), 0, F) % span
        hit = (tidx >= start) & (tidx < start + w)
        tmask = ~jnp.any(hit, axis=1)  # [B,F]
        feats = feats * tmask[:, :, None].astype(feats.dtype)
    return feats


def add_deltas(feats: jnp.ndarray, feat_len: jnp.ndarray, order: int,
               window: int = 2) -> jnp.ndarray:
    """Append Kaldi-style regression deltas: [B,F,M] -> [B,F,M*(1+order)].

    d_t = sum_{n=1..N} n * (x_{t+n} - x_{t-n}) / (2 * sum n^2), with
    indices clamped per utterance to its valid range (edge replication —
    Kaldi's add-deltas semantics). Frames past ``feat_len`` stay zero.
    The per-row clamp is a [B,F,1] take_along_axis gather, which XLA
    lowers to a time-axis gather; deltas are an opt-in stage
    (frontend.deltas) so the cost is only paid when configured.
    """
    if order <= 0:
        return feats
    F = feats.shape[1]
    denom = 2.0 * sum(n * n for n in range(1, window + 1))
    t = jnp.arange(F)[None, :]  # [1,F]
    hi = jnp.maximum(feat_len[:, None] - 1, 0)  # [B,1]
    blocks = [feats]
    cur = feats
    for _ in range(order):
        acc = jnp.zeros_like(cur)
        for n in range(1, window + 1):
            ip = jnp.clip(t + n, 0, hi)[..., None]  # [B,F,1]
            im = jnp.clip(t - n, 0, hi)[..., None]
            acc = acc + n * (jnp.take_along_axis(cur, ip, axis=1)
                             - jnp.take_along_axis(cur, im, axis=1))
        cur = acc / denom
        blocks.append(cur)
    out = jnp.concatenate(blocks, axis=-1)
    valid = (t < feat_len[:, None])[..., None]
    return jnp.where(valid, out, 0.0)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def compute_features(
    cfg: FrontendConfig,
    audio: jnp.ndarray,
    audio_len: jnp.ndarray,
    *,
    train: bool = False,
    rng: Optional[jax.Array] = None,
    cmvn_stats=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Composed-jnp frontend: [B,S] audio -> ([B,F,n_mels], feat_len).

    Frames past ``feat_len`` are zeroed so downstream consumers may rely
    on deterministic padding.
    """
    feats = log_mel_spectrogram(audio, cfg)
    feat_len = num_frames(audio_len, cfg.win_length, cfg.hop_length).astype(jnp.int32)
    feats = apply_cmvn(feats, feat_len, cfg.cmvn, cmvn_stats)
    if train and (cfg.specaug_freq_masks > 0 or cfg.specaug_time_masks > 0):
        assert rng is not None, "SpecAugment requires a PRNG key in train mode"
        feats = spec_augment(
            feats,
            feat_len,
            rng,
            cfg.specaug_freq_masks,
            cfg.specaug_freq_width,
            cfg.specaug_time_masks,
            cfg.specaug_time_width,
        )
    F = feats.shape[1]
    valid = (jnp.arange(F)[None, :] < feat_len[:, None])[..., None]
    feats = jnp.where(valid, feats, 0.0)
    return feats, feat_len


def frontend_apply(cfg: FrontendConfig, audio, audio_len, *, train=False, rng=None,
                   cmvn_stats=None):
    """The frontend every entry point calls: [B,S] audio (float32, or
    int16 PCM) -> ([B,F,D], feat_len), with deltas appended when
    ``cfg.deltas`` > 0."""
    if audio.dtype == jnp.int16:
        # PCM16 device-transfer mode [data.transfer_dtype=int16]: the
        # loader shipped raw 16-bit samples; reconstruct the float32
        # waveform on device. * 2^-15 is an exact power-of-two scale, so
        # for 16-bit sources this is bitwise-identical to shipping the
        # decoder's own f32 (= s/32768). Done here because every entry
        # point (train/eval/decode/CMVN) funnels through frontend_apply.
        audio = audio.astype(jnp.float32) * jnp.float32(2.0 ** -15)
    feats, feat_len = compute_features(
        cfg, audio, audio_len, train=train, rng=rng, cmvn_stats=cmvn_stats
    )
    if cfg.deltas > 0:
        # Deltas of the CMVN-normalized (and, in train mode,
        # SpecAugmented) statics.
        feats = add_deltas(feats, feat_len, cfg.deltas, cfg.delta_window)
    return feats, feat_len
