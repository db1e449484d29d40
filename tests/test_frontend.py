"""Frontend numerics pinned against scipy [SURVEY.md §4 "Unit: frontend"]."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

from gluon_e2e_asr.config import FrontendConfig
from gluon_e2e_asr.frontend.features import (
    apply_cmvn,
    compute_features,
    dft_basis,
    frame_signal,
    hann_window,
    log_mel_spectrogram,
    mel_filterbank,
    num_frames,
    spec_augment,
)


def _tone_batch(B=2, S=4000, sr=16000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(S) / sr
    audio = np.stack(
        [np.sin(2 * np.pi * (300 + 200 * b) * t).astype(np.float32) for b in range(B)]
    )
    audio += 0.01 * rng.randn(B, S).astype(np.float32)
    lens = np.array([S, S - 777], np.int32)[:B]
    return audio, lens


def test_num_frames():
    assert num_frames(400, 400, 160) == 1
    assert num_frames(560, 400, 160) == 2
    assert num_frames(399, 400, 160) == 0
    lens = jnp.array([400, 560, 399, 0])
    np.testing.assert_array_equal(
        np.asarray(num_frames(lens, 400, 160)), [1, 2, 0, 0]
    )


def test_framing_matches_manual():
    audio, _ = _tone_batch()
    frames = np.asarray(frame_signal(jnp.asarray(audio), 400, 160))
    F = frames.shape[1]
    for f in range(F):
        np.testing.assert_array_equal(
            frames[:, f], audio[:, f * 160 : f * 160 + 400]
        )


def test_power_spectrum_matches_scipy():
    """DFT-matmul STFT == scipy.signal.stft (boundary-free, same window)."""
    cfg = FrontendConfig()
    audio, _ = _tone_batch(B=1)
    frames = np.asarray(frame_signal(jnp.asarray(audio), cfg.win_length, cfg.hop_length))
    win = hann_window(cfg.win_length)
    cos_b, sin_b = dft_basis(cfg.win_length, cfg.n_fft)
    fw = frames[0] * win
    re = fw @ cos_b
    im = fw @ sin_b
    power = re**2 + im**2

    f, t, Z = scipy.signal.stft(
        audio[0],
        fs=cfg.sample_rate,
        window=scipy.signal.get_window("hann", cfg.win_length, fftbins=True),
        nperseg=cfg.win_length,
        noverlap=cfg.win_length - cfg.hop_length,
        nfft=cfg.n_fft,
        boundary=None,
        padded=False,
        return_onesided=True,
    )
    # scipy scales by 1/win.sum(); undo.
    Z = Z * win.sum()
    power_ref = (np.abs(Z) ** 2).T  # [frames, freq]
    n = min(len(power), len(power_ref))
    np.testing.assert_allclose(power[:n], power_ref[:n], rtol=1e-3, atol=1e-2)


def test_mel_filterbank_shape_and_coverage():
    fb = mel_filterbank(80, 512, 16000, 0.0, 8000.0)
    assert fb.shape == (257, 80)
    assert (fb >= 0).all()
    # every filter has some support
    assert (fb.sum(axis=0) > 0).all()


def test_log_mel_finite_and_floor():
    cfg = FrontendConfig()
    audio = np.zeros((1, 4000), np.float32)
    feats = np.asarray(log_mel_spectrogram(jnp.asarray(audio), cfg))
    assert np.isfinite(feats).all()
    np.testing.assert_allclose(feats, np.log(cfg.log_floor), rtol=1e-5)


def test_utterance_cmvn():
    cfg = FrontendConfig(cmvn="utterance", specaug_freq_masks=0, specaug_time_masks=0)
    audio, lens = _tone_batch()
    feats, feat_len = compute_features(cfg, jnp.asarray(audio), jnp.asarray(lens))
    feats = np.asarray(feats)
    for b in range(feats.shape[0]):
        n = int(feat_len[b])
        valid = feats[b, :n]
        np.testing.assert_allclose(valid.mean(axis=0), 0.0, atol=1e-3)
        np.testing.assert_allclose(valid.std(axis=0), 1.0, atol=3e-3)
        # padding region zeroed
        np.testing.assert_array_equal(feats[b, n:], 0.0)


def test_spec_augment_masks():
    rng = jax.random.PRNGKey(0)
    feats = jnp.ones((4, 100, 80))
    feat_len = jnp.full((4,), 100, jnp.int32)
    out = np.asarray(
        spec_augment(feats, feat_len, rng, n_freq_masks=2, freq_width=10,
                     n_time_masks=2, time_width=20)
    )
    assert out.shape == (4, 100, 80)
    assert ((out == 0) | (out == 1)).all()
    assert (out == 0).any()  # some masking happened
    # masking is axis-aligned: a zeroed (t,f) cell implies full row or col
    zero_frac = (out == 0).mean()
    assert zero_frac < 0.8


def test_specaugment_off_in_eval():
    cfg = FrontendConfig()
    audio, lens = _tone_batch()
    f1, _ = compute_features(cfg, jnp.asarray(audio), jnp.asarray(lens), train=False)
    f2, _ = compute_features(cfg, jnp.asarray(audio), jnp.asarray(lens), train=False)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))


def test_jit_compatible():
    cfg = FrontendConfig()
    audio, lens = _tone_batch()
    fn = jax.jit(lambda a, l: compute_features(cfg, a, l))
    feats, feat_len = fn(jnp.asarray(audio), jnp.asarray(lens))
    assert np.isfinite(np.asarray(feats)).all()
