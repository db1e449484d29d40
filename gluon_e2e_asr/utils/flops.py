"""Analytic model-FLOP accounting for the train step.

The benchmark reports achieved TFLOP/s and MFU. The count is analytic:
it mirrors the exact matmul shapes the model builds (frontend/features.py
DFT+mel chain, models/encoder.py pyramidal BiLSTM, models/decoder.py LAS
step) from the config, under the MFU convention (matmul multiply-adds
x 2; elementwise work, softmax and the CTC alpha-beta recursion are
excluded).

Training FLOPs use the standard fwd + backward ~= 3x forward-matmul
estimate (each matmul's backward is two matmuls of the same size).
"""

from __future__ import annotations

from typing import Dict, Tuple

from gluon_e2e_asr.config import Config
from gluon_e2e_asr.frontend.features import num_frames

# Dense peak matmul rates in TFLOP/s, keyed by ``jax.Device.device_kind``
# (NVIDIA H100 SXM data sheet, without sparsity, at the 700 W limit).
# "float32" is the rate outside the tensor cores, which only matmuls at
# precision "highest" are held to; "tf32" is what JAX's default matmul
# precision gives float32 matmuls on this card.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.0, "tf32": 495.0,
                              "float32": 67.0},
}


def peak_tflops(device_kind: str, compute_dtype: str) -> Tuple[float, str]:
    """(peak TFLOP/s, which rate it is) for a run whose matmuls use
    ``compute_dtype``. A float32 run at the default matmul precision runs
    its matmuls as TF32, so it divides by the TF32 rate. A device not in
    the table raises: there is no default peak."""
    if device_kind not in PEAK_TFLOPS:
        raise KeyError(
            f"no peak rate on record for device_kind {device_kind!r}; "
            f"known: {sorted(PEAK_TFLOPS)}")
    rates = PEAK_TFLOPS[device_kind]
    if str(compute_dtype) == "bfloat16":
        return rates["bfloat16"], "bfloat16"
    if str(compute_dtype) == "float32":
        return rates["tf32"], "tf32 (default float32 matmul precision)"
    raise ValueError(f"no peak rate for compute_dtype {compute_dtype!r}")


def train_step_flops(
    config: Config,
    vocab_size: int,
    batch_size: int,
    audio_samples: int,
    max_labels: int,
) -> Dict[str, float]:
    """Exact matmul-FLOP count of one train step at the given shapes.

    Returns {"fwd": F, "train": 3F, "breakdown": {...}} in FLOPs
    (multiply-add = 2). Shapes mirror the padded bucket the step runs
    on (padding FLOPs are real FLOPs — the step computes them).
    """
    fc, mc = config.frontend, config.model
    B, L = batch_size, max_labels
    V = vocab_size

    # --- frontend ----------------------------------------------------------
    F = int(num_frames(audio_samples, fc.win_length, fc.hop_length))
    bins = fc.n_fft // 2 + 1
    dft = 2.0 * B * F * fc.win_length * (2 * bins)  # combined cos|sin basis
    mel = 2.0 * B * F * bins * fc.n_mels
    frontend = dft + mel
    D = fc.n_mels * (1 + int(getattr(fc, "deltas", 0)))

    # --- encoder: pyramidal BiLSTM stack (models/encoder.py) -------------
    T = F
    H = mc.enc_hidden
    subs = tuple(mc.enc_subsample) + (1,) * max(
        0, mc.enc_layers - len(mc.enc_subsample)
    )
    if mc.enc_type == "vggblstm":
        # Two (conv x2 + pool) stages: 3x3 convs at compute_dtype.
        C_in = int(mc.vgg_in_channels)
        Freq = D // C_in
        conv = 0.0
        t, f = T, Freq
        for ch in mc.vgg_channels:
            conv += 2.0 * B * t * f * 9 * C_in * ch      # conv 1
            conv += 2.0 * B * t * f * 9 * ch * ch        # conv 2
            t, f, C_in = (t + 1) // 2, (f + 1) // 2, int(ch)
        frontend += conv
        T, D = t, f * C_in
    encoder = 0.0
    for layer in range(mc.enc_layers):
        f = int(subs[layer])
        T = (T + f - 1) // f
        D = D * f
        encoder += 2.0 * B * T * D * (8 * H)          # in-proj, both dirs
        encoder += 2 * T * (2.0 * B * H * (4 * H))    # recurrence, 2 dirs
        D = 2 * H

    # --- CTC head ---------------------------------------------------------
    T_enc, enc_dim = T, 2 * H
    ctc_head = 2.0 * B * T_enc * enc_dim * V

    # --- LAS decoder, teacher-forced over L steps (models/decoder.py) ----
    Hd, A, E = mc.dec_hidden, mc.att_dim, mc.dec_embed
    dec = 2.0 * B * T_enc * enc_dim * A               # key precompute
    per_step = 2.0 * B * (E + enc_dim) * (4 * Hd)     # cell0 input proj
    per_step += 2.0 * B * Hd * (4 * Hd)               # cell0 recurrence
    for _ in range(mc.dec_layers - 1):
        per_step += 2.0 * B * Hd * (4 * Hd) * 2       # deeper cells
    per_step += 2.0 * B * Hd * A                      # query projection
    if mc.att_type == "dot":
        per_step += 2.0 * B * T_enc * A               # q . k scores
    else:
        per_step += 2.0 * B * T_enc * A               # energy v-dot
        if mc.att_type == "loc":
            per_step += 2.0 * B * T_enc * mc.loc_conv_width \
                * mc.loc_conv_channels
            per_step += 2.0 * B * T_enc * mc.loc_conv_channels * A
    per_step += 2.0 * B * T_enc * enc_dim             # context sum
    per_step += 2.0 * B * (Hd + enc_dim) * V          # output projection
    dec += L * per_step

    fwd = frontend + encoder + ctc_head + dec
    return {
        "fwd": fwd,
        "train": 3.0 * fwd,
        "breakdown": {
            "frontend": frontend,
            "encoder": encoder,
            "ctc_head": ctc_head,
            "decoder": dec,
        },
    }


def bench_mfu(utt_per_sec: float, config: Config, vocab_size: int,
              batch_size: int, audio_samples: int, max_labels: int,
              device_kind: str) -> Dict[str, float]:
    """Achieved TFLOP/s + MFU (per chip) for a measured train throughput
    per chip."""
    fl = train_step_flops(config, vocab_size, batch_size,
                          audio_samples, max_labels)
    flops_per_utt = fl["train"] / batch_size
    tps = utt_per_sec * flops_per_utt / 1e12
    peak, basis = peak_tflops(device_kind, config.model.compute_dtype)
    return {
        "model_tflops_per_step": fl["train"] / 1e12,
        "tflops_per_sec": tps,
        "mfu": tps / peak,
        "peak_tflops": peak,
        "peak_basis": basis,
    }
