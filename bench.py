"""Benchmark: training throughput (utt/s per chip) on the flagship hybrid
CTC/attention model at B=96 x 12.8 s, bf16 matmuls.

Prints ONE JSON line naming the device it ran on (platform, device_kind,
device count, power limit):
  {"metric": ..., "value": N, "unit": "utt/s/chip", "vs_baseline": N, ...}

``vs_baseline`` compares against a CPU-JAX stand-in for the reference's
MXNet-CPU throughput: no published number exists ([BASELINE.json:L13]
"published": {}), so the stand-in is this repo's own CPU-JAX throughput
on identical shapes, measured with ``python bench.py --cpu-baseline``.

The measurement needs a GPU: on any other platform it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from gluon_e2e_asr.utils.platform import configure_from_env

# CPU-JAX utt/sec on the same batch shapes and model config as the
# benchmark below, keyed by (batch, att_type), measured with
# python bench.py --cpu-baseline --batch N --att A (see BASELINE.md).
# fp32 on CPU (bf16 has no CPU advantage; conservative for the ratio).
CPU_BASELINE_UTT_PER_SEC = {
    (16, "loc"): 0.433,  # measured 2026-08-16
    (64, "loc"): 0.302,  # measured 2026-08-17
    (96, "loc"): 0.668,  # measured 2026-08-17
    (96, "dot"): 0.378,  # measured 2026-08-17 (idle box; the faster of
                         # two runs — higher baseline = conservative ratio)
}

# LibriSpeech-100h-like shapes: ~12.8 s utterances, char targets ~7/s.
# Batch 96 + bf16 matmuls is the flagship throughput point carried over
# from earlier rounds (state/accumulation stay f32); it has not been
# re-sized for an 80 GB card.
BATCH = 96
SECONDS = 12.8
MAX_LABELS = 96
WARMUP_STEPS = 3
MEASURE_STEPS = 10
CPU_WARMUP_STEPS = 1
CPU_MEASURE_STEPS = 3


def build(dp: bool, batch_size: int = BATCH,
          compute_dtype: str = "float32", att_type: str = "loc"):
    from __graft_entry__ import _flagship_config, _synth_batch
    from gluon_e2e_asr.data.tokenizer import CharTokenizer
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.training.train_step import (
        create_train_state, make_optimizer, make_train_step,
    )

    config = _flagship_config(tiny=False)
    config.model.compute_dtype = compute_dtype
    config.model.att_type = att_type
    tok = CharTokenizer()
    model = build_model(config, tok.vocab_size, tok.sos_id, tok.eos_id)
    tx = make_optimizer(config)
    batch = _synth_batch(batch_size, SECONDS, MAX_LABELS)
    state = create_train_state(config, model, tx, batch)
    step = make_train_step(model, config, tx, mesh=None)
    return state, step, batch


def measure(state, step, batch, warmup=WARMUP_STEPS,
            steps=MEASURE_STEPS, repeats=1):
    """Return per-pass utt/s readings (len == repeats); each pass ends in
    ``block_until_ready`` on the final state."""
    import jax
    import jax.numpy as jnp

    bsz = batch["audio"].shape[0]
    dev_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(warmup):
        state, metrics = step(state, dev_batch)
    jax.block_until_ready(state)
    readings = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step(state, dev_batch)
        jax.block_until_ready(state)
        dt = time.perf_counter() - t0
        readings.append(bsz * steps / dt)
    assert np.isfinite(float(metrics["loss"]))
    return readings


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu-baseline", action="store_true",
                   help="measure the CPU-JAX stand-in baseline instead")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--att", default="dot", choices=["loc", "add", "dot"])
    p.add_argument("--repeats", type=int, default=3,
                   help="measurement passes (median reported)")
    args = p.parse_args()
    configure_from_env()

    if args.cpu_baseline:
        import jax

        jax.config.update("jax_platforms", "cpu")
        # Same att_type as the device run so the ratio compares like
        # models (fp32: the honest CPU realization).
        state, step, batch = build(dp=False, batch_size=args.batch,
                                   att_type=args.att)
        ups = measure(state, step, batch, warmup=CPU_WARMUP_STEPS,
                      steps=CPU_MEASURE_STEPS)[0]
        print(f"CPU-JAX baseline (batch {args.batch}, att {args.att}): "
              f"{ups:.3f} utt/s", file=sys.stderr)
        print(json.dumps({
            "metric": "train_throughput_cpu_baseline",
            "value": round(ups, 3),
            "unit": "utt/s",
            "vs_baseline": 1.0,
        }))
        return

    from gluon_e2e_asr.utils.platform import device_report

    device = device_report()
    if device["platform"] != "gpu":
        sys.exit(f"bench: needs a GPU, found platform {device['platform']!r}")
    state, step, batch = build(dp=False, batch_size=args.batch,
                               compute_dtype=args.dtype, att_type=args.att)
    readings = measure(state, step, batch, repeats=max(args.repeats, 1))
    per_chip = float(np.median(readings))
    spread_pct = 100.0 * (max(readings) - min(readings)) / per_chip
    print(f"device={device} utt/s/chip={per_chip:.2f} "
          f"(readings={[round(r, 1) for r in readings]})", file=sys.stderr)
    from __graft_entry__ import _flagship_config
    from gluon_e2e_asr.data.tokenizer import CharTokenizer
    from gluon_e2e_asr.utils.flops import bench_mfu

    cfg = _flagship_config(tiny=False)
    cfg.model.compute_dtype = args.dtype
    cfg.model.att_type = args.att
    util = bench_mfu(per_chip, cfg, CharTokenizer().vocab_size,
                     args.batch, int(SECONDS * 16000), MAX_LABELS,
                     device["device_kind"])
    # Nearest measured (batch, att) if this exact point wasn't benchmarked
    # on CPU (per-utt CPU throughput is batch- and attention-sensitive).
    base_key = min(
        CPU_BASELINE_UTT_PER_SEC,
        key=lambda k: (k[1] != args.att, abs(k[0] - args.batch)),
    )
    print(json.dumps({
        "metric": "train_throughput_utt_per_sec_per_chip",
        "value": round(per_chip, 3),
        "unit": "utt/s/chip",
        "vs_baseline": round(
            per_chip / CPU_BASELINE_UTT_PER_SEC[base_key], 2),
        "baseline": f"cpu-jax-standin-batch{base_key[0]}-{base_key[1]}",
        "device": device,
        "repeats": len(readings),
        "readings": [round(r, 3) for r in readings],
        "median": round(per_chip, 3),
        "spread_pct": round(spread_pct, 2),
        "tflops_per_sec": round(util["tflops_per_sec"], 2),
        "mfu": round(util["mfu"], 4),
        "peak_tflops": util["peak_tflops"],
        "peak_basis": util["peak_basis"],
        "model_tflops_per_step": round(util["model_tflops_per_step"], 3),
    }))


if __name__ == "__main__":
    main()
