"""Analytic FLOP accounting (utils/flops.py).

Pins the encoder count against the roofline formulae
(input proj 2*B*T*D*8H + recurrence 2 dirs * T * 2*B*H*4H) at the exact
flagship bench shapes, and the MFU arithmetic on a round number.
"""

import math

from gluon_e2e_asr.config import Config
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.frontend.features import num_frames
from gluon_e2e_asr.utils.flops import (
    bench_mfu,
    peak_tflops,
    train_step_flops,
)


def _flagship():
    return Config()  # defaults == flagship model (320x3 BiLSTM + LAS)


def test_encoder_count_matches_roofline_formulae():
    cfg = _flagship()
    B, samples, L = 96, int(12.8 * 16000), 96
    V = CharTokenizer().vocab_size
    fl = train_step_flops(cfg, V, B, samples, L)

    # Hand-roll the encoder formulae at these shapes.
    T = num_frames(samples, cfg.frontend.win_length, cfg.frontend.hop_length)
    D, H = cfg.frontend.n_mels, cfg.model.enc_hidden
    expect = 0.0
    for f in cfg.model.enc_subsample:
        T = math.ceil(T / f)
        D = D * f
        expect += 2 * B * T * D * 8 * H
        expect += 2 * T * 2 * B * H * 4 * H
        D = 2 * H
    assert fl["breakdown"]["encoder"] == expect
    # Encoder dominates the step's matmul FLOPs.
    assert fl["breakdown"]["encoder"] > 0.7 * fl["fwd"]
    assert fl["train"] == 3.0 * fl["fwd"]


def test_all_terms_positive_and_scale_with_batch():
    cfg = _flagship()
    V = CharTokenizer().vocab_size
    a = train_step_flops(cfg, V, 16, 16000 * 4, 32)
    b = train_step_flops(cfg, V, 32, 16000 * 4, 32)
    for k, v in a["breakdown"].items():
        assert v > 0, k
        assert b["breakdown"][k] == 2 * v, k  # every term is linear in B


def test_vgg_front_adds_conv_flops():
    cfg = _flagship()
    V = CharTokenizer().vocab_size
    base = train_step_flops(cfg, V, 8, 16000 * 2, 16)
    cfg.model.enc_type = "vggblstm"
    cfg.model.enc_subsample = (1, 1, 1)
    vgg = train_step_flops(cfg, V, 8, 16000 * 2, 16)
    assert vgg["breakdown"]["frontend"] > base["breakdown"]["frontend"]


H100 = "NVIDIA H100 80GB HBM3"


def test_mfu_arithmetic():
    cfg = _flagship()
    cfg.model.compute_dtype = "bfloat16"
    V = CharTokenizer().vocab_size
    B, samples, L = 96, int(12.8 * 16000), 96
    fl = train_step_flops(cfg, V, B, samples, L)
    util = bench_mfu(1000.0, cfg, V, B, samples, L, H100)
    expect_tps = 1000.0 * (fl["train"] / B) / 1e12
    assert abs(util["tflops_per_sec"] - expect_tps) < 1e-9
    assert util["peak_tflops"] == peak_tflops(H100, "bfloat16")[0] == 989.0
    assert abs(util["mfu"] - expect_tps / 989.0) < 1e-12


def test_peak_override_env():
    """The peak comes from the device_kind table alone: an unknown device
    raises instead of falling back to some default rate, and a float32
    run divides by the TF32 rate its default-precision matmuls run at."""
    import pytest

    with pytest.raises(KeyError, match="no peak rate"):
        peak_tflops("cpu", "bfloat16")
    with pytest.raises(KeyError):
        bench_mfu(1.0, _flagship(), 32, 2, 16000, 8, "Some Other Accelerator")
    peak, basis = peak_tflops(H100, "float32")
    assert peak == 495.0 and basis.startswith("tf32")
    with pytest.raises(ValueError):
        peak_tflops(H100, "float16")
