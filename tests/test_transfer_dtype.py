"""PCM16 device-transfer mode (data.transfer_dtype=int16).

Audio is 16-bit on disk; int16 mode ships those samples verbatim and the
frontend reconstructs f32 on device (* 2^-15) — bitwise-identical to the
float32 pipeline for 16-bit sources, at half the host->device bytes
(the 100 h rehearsal's float32 audio is ~29 GB per epoch).
"""

import numpy as np
import pytest

from gluon_e2e_asr.config import Config, DataConfig, FrontendConfig
from gluon_e2e_asr.data.loader import DataLoader, _quantize_i16
from gluon_e2e_asr.data.manifest import Utterance
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.utils import native


@pytest.fixture(scope="module")
def lib_ok():
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    return True


def _flac_corpus(tmp_path, n=5, rate=16000, seconds=1.2, seed=0):
    """n PCM16 FLAC files + their Utterances (native encoder)."""
    rng = np.random.RandomState(seed)
    utts = []
    for i in range(n):
        pcm = (np.clip(rng.randn(int(rate * seconds)) * 0.2, -1, 1)
               * 32767.0).astype(np.int16)
        p = str(tmp_path / f"u{i}.flac")
        native.encode_flac(p, pcm, rate)
        utts.append(Utterance(f"u{i}", "hello world", seconds,
                              audio_path=p))
    return utts


def _loaders(utts, transfer_dtype, speed_perturb=(), seed=7):
    specs = make_bucket_specs((2.0,), 16000, len(utts), 64, 160, False)
    sampler = BucketSampler(utts, specs, 16000, seed=0, shuffle=False)
    return DataLoader(utts, sampler, CharTokenizer(), 16000,
                      speed_perturb=speed_perturb, perturb_seed=seed,
                      transfer_dtype=transfer_dtype)


def test_i16_batch_is_exact_roundtrip_of_f32(tmp_path, lib_ok):
    """For 16-bit sources the int16 batch reconstructs the float32 batch
    BITWISE: f32 = s/32768 and the i16 packer stores round(f32*32768)=s."""
    utts = _flac_corpus(tmp_path)
    bf = next(_loaders(utts, "float32").epoch(0))
    bi = next(_loaders(utts, "int16").epoch(0))
    assert bi.audio.dtype == np.int16
    np.testing.assert_array_equal(bi.audio_len, bf.audio_len)
    rec = bi.audio.astype(np.float32) * np.float32(2.0 ** -15)
    np.testing.assert_array_equal(rec, bf.audio)


def test_frontend_reconstructs_f32_bitwise(tmp_path, lib_ok):
    """frontend_apply on the int16 batch == on the f32 batch, bitwise
    (the on-device * 2^-15 is an exact power-of-two scale)."""
    import jax.numpy as jnp

    from gluon_e2e_asr.frontend.features import frontend_apply

    utts = _flac_corpus(tmp_path)
    bf = next(_loaders(utts, "float32").epoch(0))
    bi = next(_loaders(utts, "int16").epoch(0))
    cfg = FrontendConfig()
    ff, lf = frontend_apply(cfg, jnp.asarray(bf.audio),
                            jnp.asarray(bf.audio_len))
    fi, li = frontend_apply(cfg, jnp.asarray(bi.audio),
                            jnp.asarray(bi.audio_len))
    np.testing.assert_array_equal(np.asarray(lf), np.asarray(li))
    np.testing.assert_array_equal(np.asarray(ff), np.asarray(fi))


def test_speed_perturb_i16_requantizes_with_bounded_error(tmp_path, lib_ok):
    """Perturbed rows re-quantize (never C-truncate): int16 rows track
    the f32 rows within 1 LSB (interp of quantized + rounding)."""
    utts = _flac_corpus(tmp_path)
    sp = (0.9, 1.0, 1.1)
    bf = next(_loaders(utts, "float32", speed_perturb=sp).epoch(3))
    bi = next(_loaders(utts, "int16", speed_perturb=sp).epoch(3))
    np.testing.assert_array_equal(bi.audio_len, bf.audio_len)
    rec = bi.audio.astype(np.float64) / 32768.0
    assert np.abs(rec - bf.audio.astype(np.float64)).max() <= 1.5 / 32768.0


def test_quantize_rounds_and_clips():
    x = np.array([0.0, 1.0, -1.0, 0.4999 / 32768, 0.5001 / 32768],
                 np.float32)
    q = _quantize_i16(x)
    assert q.dtype == np.int16
    assert q[0] == 0 and q[1] == 32767 and q[2] == -32768
    assert q[3] == 0 and q[4] == 1


def test_transfer_dtype_validated(tmp_path, lib_ok):
    utts = _flac_corpus(tmp_path, n=2)
    with pytest.raises(ValueError, match="transfer_dtype"):
        _loaders(utts, "int8")


def test_trainer_int16_end_to_end(tmp_path):
    """One epoch on the synthetic fixture with transfer_dtype=int16:
    the full train step + greedy dev eval run on int16 batches."""
    from gluon_e2e_asr.config import LossConfig, ModelConfig, TrainConfig
    from gluon_e2e_asr.training.trainer import Trainer

    import os

    cfg = Config(
        data=DataConfig(dataset="synthetic", synth_num_train=8,
                        synth_num_dev=4, synth_min_tokens=3,
                        synth_max_tokens=6, batch_size=8,
                        bucket_bounds_sec=(1.5,), transfer_dtype="int16"),
        model=ModelConfig(enc_hidden=32, enc_layers=1, enc_subsample=(2,)),
        loss=LossConfig(mtl_alpha=1.0),
        train=TrainConfig(num_epochs=1,
                          ckpt_dir=os.path.join(str(tmp_path), "ckpts"),
                          metrics_path=os.path.join(str(tmp_path),
                                                    "metrics.jsonl")),
    )
    t = Trainer(cfg, workdir=str(tmp_path))
    final = t.train()
    assert np.isfinite(final["dev_wer"])


def test_compute_cmvn_dtype_invariant(tmp_path, lib_ok, monkeypatch):
    """tools/compute_cmvn.py must produce IDENTICAL stats under
    transfer_dtype float32 and int16.

    Regression for the round-5 ls100 restart failure: the tool calls
    log_mel_spectrogram directly (bypassing frontend_apply's PCM16
    dequant), so an int16 loader fed it +-32767-scale samples and every
    log-mel mean inflated by log(2^30) ~= 20.8 — stats that silently
    UN-normalized training (valid-frame features at mean -17.9) and kept
    CTC from converging for two epochs of training.
    """
    import importlib.util
    import os

    import json

    spec = importlib.util.spec_from_file_location(
        "compute_cmvn_tool",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "compute_cmvn.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    utts = _flac_corpus(tmp_path, n=4)
    monkeypatch.setattr(mod, "build_datasets", lambda cfg: (utts, []))

    stats = {}
    for td in ("float32", "int16"):
        cfg_path = str(tmp_path / f"cmvn_{td}.yaml")
        with open(cfg_path, "w") as f:
            json.dump({"name": f"cmvn_{td}",
                       "data": {"transfer_dtype": td,
                                "batch_size": 4,
                                "bucket_bounds_sec": [2.0]}}, f)
        out = str(tmp_path / f"cmvn_{td}.npz")
        mod.main(["--config", cfg_path, "--output", out])
        stats[td] = np.load(out)
    np.testing.assert_array_equal(stats["float32"]["mean"],
                                  stats["int16"]["mean"])
    np.testing.assert_array_equal(stats["float32"]["std"],
                                  stats["int16"]["std"])
    # and the stats are sane for dequantized audio (log-mel of unit-scale
    # waveforms is O(-30..10), nowhere near the +18.7 inflated regime)
    assert float(stats["int16"]["mean"].mean()) < 10.0
