#!/usr/bin/env python
"""Smoke test of the recognizer on one GPU, through the entry points users call.

    python chip_smoke.py               # one card: phases (a)-(e)
    python chip_smoke.py --four-cards  # four cards: the data-parallel path only

Everything runs in this one JAX process; ``nvidia-smi`` runs as a child
process that stays off JAX. Any platform other than ``gpu`` fails, and
so does any phase: nothing catches a phase's failure and carries on.

Phases (one card):
  (a) the device: nvidia-smi name and power limit, JAX version,
      device_kind, device count;
  (b) ``train.main`` on configs/flagship_bf16.yaml (3x320 pyramidal
      BiLSTM, 320-wide LAS decoder with location attention, bf16
      matmuls, batch 96) for 20 steps on synthetic data from the seed:
      the loss must be finite; prints the steady step time and the peak
      device memory;
  (c) one train step at the benchmark shape (B=96 x 12.8 s, bf16):
      ``compiled.memory_analysis()``, the step time, and the time XLA's
      plain path takes for each piece that once had a hand-written
      kernel (BiLSTM layer, teacher-forced decoder, CTC, frontend);
  (d) ``decode.main --method beam`` on the checkpoint from (b), then
      ``transcribe.main`` on two synthetic .npy clips;
  (e) the golden checkpoint in tests/goldens decoded greedy and beam at
      float32 "highest" matmul precision, diffed against the blessed
      records with tools/fidelity_diff.py.

``--four-cards`` runs ``__graft_entry__.dryrun_multichip(4)`` at the
flagship widths: shard_map against pjit loss parity with augmentation
off, 2-micro-batch accumulation, and DP beam decode against
single-device decode.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from gluon_e2e_asr.utils.platform import (  # noqa: E402
    configure_from_env,
    gpu_name_and_power_limit,
)

FLAGSHIP = os.path.join(REPO, "configs", "flagship_bf16.yaml")
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
# One bucket shape and an epoch of exactly 20 batches of 96: the 20 steps
# compile one program, end on the epoch's dev eval (beam search) and
# leave a best.msgpack behind.
TRAIN_OVERRIDES = [
    "data.synth_num_train=1920", "data.synth_num_dev=96",
    "data.bucket_bounds_sec=[4.0]", "train.num_epochs=1",
    "train.log_every_steps=5",
]
# Golden beam scores are sums of tens of float32 log-probs. At "highest"
# matmul precision the card differs from the CPU that blessed them only
# in summation order (~1e-6 relative per term), so the CPU gate's 1e-4
# absolute tolerance holds with a margin of about ten.
GOLDEN_SCORE_TOL = 1e-4
# Benchmark shape of phase (c) and bench.py.
BENCH_B, BENCH_SECONDS, BENCH_LABELS = 96, 12.8, 96


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args, repeats: int = 5) -> float:
    """Median seconds of ``fn(*args)`` after one warm-up call, each call
    ending in ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def peak_bytes_in_use():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


# ----------------------------------------------------------------------
# (a) the device
# ----------------------------------------------------------------------

def phase_device(expect_platform: str = "gpu") -> dict:
    import jax

    devices = jax.devices()
    dev = {"platform": devices[0].platform, "kind": devices[0].device_kind,
           "count": len(devices)}
    card = gpu_name_and_power_limit()
    log(f"(a) nvidia-smi: {card}")
    log(f"(a) jax {jax.__version__}; device_kind={dev['kind']!r}; "
        f"platform={dev['platform']}; devices={dev['count']}")
    if dev["platform"] != expect_platform:
        raise SystemExit(
            f"chip_smoke: needs platform {expect_platform!r}, JAX found "
            f"{dev['platform']!r}")
    return {"device": dev, "card": card}


# ----------------------------------------------------------------------
# (b) training through train.main
# ----------------------------------------------------------------------

def phase_train(workdir: str, config_path: str, overrides, steps: int,
                card: str) -> dict:
    from gluon_e2e_asr import train as train_cli

    args = ["--config", config_path, "--workdir", workdir,
            "--max-steps", str(steps)]
    for o in overrides:
        args += ["--set", o]
    t0 = time.perf_counter()
    train_cli.main(args)
    wall = time.perf_counter() - t0
    from gluon_e2e_asr.config import apply_overrides, load_config

    cfg = apply_overrides(load_config(config_path), list(overrides))
    with open(os.path.join(workdir, cfg.train.metrics_path)) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    train = [r for r in recs if r.get("event") == "train"]
    if not train or train[-1]["step"] != steps:
        raise AssertionError(f"training stopped early: {train[-1:]}")
    losses = [r["loss"] for r in train]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    # The first logging window holds the compile; the rest are steady.
    steady = [cfg.data.batch_size / r["utt_per_sec_per_chip"]
              for r in train[1:]]
    step_s = statistics.median(steady) if steady else float("nan")
    ckpts = sorted(glob.glob(os.path.join(
        workdir, cfg.train.ckpt_dir, "ckpt_*.msgpack")))
    if not ckpts:
        raise AssertionError("training left no checkpoint")
    out = {"losses": losses, "step_s": step_s, "wall_s": wall,
           "peak_bytes_in_use": peak_bytes_in_use(), "ckpt": ckpts[-1]}
    log(f"(b) train.main {os.path.basename(config_path)}: {steps} steps in "
        f"{wall:.1f} s wall (compile included); loss per logged window "
        f"{losses}; steady step {step_s * 1e3:.1f} ms; peak_bytes_in_use "
        f"{out['peak_bytes_in_use']} [{card}]")
    return out


# ----------------------------------------------------------------------
# (c) the benchmark-shape step and the plain paths
# ----------------------------------------------------------------------

def phase_step_memory(card: str, batch: int = BENCH_B,
                      seconds: float = BENCH_SECONDS,
                      max_labels: int = BENCH_LABELS, tiny: bool = False,
                      steps: int = 3) -> dict:
    """One flagship train step at the benchmark shape: memory analysis of
    the compiled program, then the step time."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_config, _synth_batch
    from gluon_e2e_asr.data.tokenizer import CharTokenizer
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.training.train_step import (
        create_train_state, make_optimizer, make_train_step,
    )

    config = _flagship_config(tiny=tiny)
    config.model.compute_dtype = "bfloat16"
    tok = CharTokenizer()
    model = build_model(config, tok.vocab_size, tok.sos_id, tok.eos_id)
    tx = make_optimizer(config)
    host_batch = _synth_batch(batch, seconds, max_labels)
    state = create_train_state(config, model, tx, host_batch)
    dev_batch = {k: jnp.asarray(v) for k, v in host_batch.items()}
    step = make_train_step(model, config, tx)
    compiled = step.lower(state, dev_batch).compile()
    mem = compiled.memory_analysis()
    log(f"(c) train step B={batch} x {seconds} s bf16 loc, "
        f"memory_analysis: {mem}")
    for _ in range(2):  # warm-up (the step donates its state)
        state, metrics = compiled(state, dev_batch)
    jax.block_until_ready(state)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = compiled(state, dev_batch)
        jax.block_until_ready(state)
        times.append(time.perf_counter() - t0)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss at the benchmark shape: {loss}")
    step_s = statistics.median(times)
    log(f"(c) train step B={batch} x {seconds} s bf16 loc: "
        f"{step_s * 1e3:.2f} ms median of {steps} "
        f"({batch / step_s:.1f} utt/s), loss {loss:.4f} [{card}]")
    return {"step_s": step_s, "loss": loss,
            "temp_bytes": getattr(mem, "temp_size_in_bytes", None)}


def phase_plain_paths(card: str, B: int = BENCH_B, T_enc: int = 1280,
                      H: int = 320, D: int = 80, L: int = 96, T_dec: int = 320,
                      V: int = 32, seconds: float = BENCH_SECONDS,
                      repeats: int = 5) -> dict:
    """XLA's time for the plain path of each piece that once had a
    hand-written kernel, at the shapes the kernel served: forward and
    backward where the training step takes both."""
    import jax
    import jax.numpy as jnp

    from gluon_e2e_asr.config import FrontendConfig, ModelConfig
    from gluon_e2e_asr.frontend.features import frontend_apply
    from gluon_e2e_asr.models.decoder import AttentionDecoder
    from gluon_e2e_asr.models.lstm import bilstm_scan
    from gluon_e2e_asr.ops.ctc import ctc_loss

    rng = np.random.RandomState(0)
    bf16 = jnp.bfloat16
    out = {}

    # BiLSTM layer: input projection + the two-direction scan, fwd+bwd.
    x = jnp.asarray(rng.randn(B, T_enc, D), jnp.float32)
    lens = jnp.asarray(rng.randint(T_enc // 2, T_enc + 1, B), jnp.int32)
    w_in = jnp.asarray(rng.randn(D, 8 * H) * D ** -0.5, jnp.float32)
    w_f = jnp.asarray(rng.randn(H, 4 * H) * H ** -0.5, jnp.float32)
    w_b = jnp.asarray(rng.randn(H, 4 * H) * H ** -0.5, jnp.float32)

    def lstm_loss(w_in, w_f, w_b, x):
        xg = jnp.dot(x.astype(bf16), w_in.astype(bf16),
                     preferred_element_type=jnp.float32).astype(bf16)
        xf, xb = jnp.split(xg, 2, axis=-1)
        return jnp.sum(bilstm_scan(xf, xb, lens, w_f, w_b,
                                   compute_dtype=bf16) ** 2)

    f = jax.jit(jax.value_and_grad(lstm_loss, argnums=(0, 1, 2, 3)))
    out["bilstm_layer"] = timed(f, w_in, w_f, w_b, x, repeats=repeats)
    log(f"(c) plain BiLSTM layer fwd+bwd, scan, B={B} T={T_enc} H={H} "
        f"D={D} bf16: {out['bilstm_layer'] * 1e3:.2f} ms [{card}]")

    # Teacher-forced decoder, fwd+bwd, loc and dot attention.
    enc = jnp.asarray(rng.randn(B, T_dec, 2 * H) * 0.5, jnp.float32)
    enc_len = jnp.asarray(rng.randint(T_dec // 2, T_dec + 1, B), jnp.int32)
    toks = jnp.asarray(rng.randint(4, V, (B, L)), jnp.int32)
    for att in ("loc", "dot"):
        cfg = ModelConfig(att_type=att, enc_hidden=H, dec_hidden=H,
                          att_dim=H, compute_dtype="bfloat16")
        dec = AttentionDecoder(cfg, V)
        p = dec.init(jax.random.PRNGKey(0))["params"]

        def dec_loss(p, enc, _dec=dec):
            return jnp.sum(_dec(p, enc, enc_len, toks) ** 2)

        g = jax.jit(jax.value_and_grad(dec_loss, argnums=(0, 1)))
        out[f"decoder_{att}"] = timed(g, p, enc, repeats=repeats)
        log(f"(c) plain teacher-forced decoder fwd+bwd, scan, {att} "
            f"attention, B={B} L={L} T={T_dec}: "
            f"{out[f'decoder_{att}'] * 1e3:.2f} ms [{card}]")

    # CTC loss and its gradient (custom VJP).
    logits = jnp.asarray(rng.randn(B, T_dec, V), jnp.float32)
    labels = jnp.asarray(rng.randint(1, V, (B, L)), jnp.int32)
    label_len = jnp.asarray(rng.randint(L // 2, L + 1, B), jnp.int32)
    c = jax.jit(jax.value_and_grad(
        lambda lg: jnp.sum(ctc_loss(lg, enc_len, labels, label_len))))
    out["ctc"] = timed(c, logits, repeats=repeats)
    log(f"(c) plain CTC loss+grad, scan, B={B} T={T_dec} S={2 * L + 1} "
        f"V={V}: {out['ctc'] * 1e3:.2f} ms [{card}]")

    # Frontend (inference path: DFT matmuls, mel, log, CMVN).
    n = int(seconds * 16000)
    audio = jnp.asarray(rng.randn(B, n) * 0.1, jnp.float32)
    audio_len = jnp.full((B,), n, jnp.int32)
    fe = jax.jit(lambda a, al: frontend_apply(FrontendConfig(), a, al))
    out["frontend"] = timed(fe, audio, audio_len, repeats=repeats)
    log(f"(c) plain frontend, jnp, B={B} x {seconds} s: "
        f"{out['frontend'] * 1e3:.2f} ms [{card}]")
    return out


# ----------------------------------------------------------------------
# (d) decode and transcribe
# ----------------------------------------------------------------------

def phase_decode(workdir: str, config_path: str, overrides, ckpt: str,
                 n_utts: int, card: str) -> dict:
    from gluon_e2e_asr import decode as decode_cli
    from gluon_e2e_asr import transcribe as transcribe_cli
    from gluon_e2e_asr.data.manifest import (
        build_synthetic_manifest, load_audio,
    )

    sets = sum((["--set", o] for o in overrides), [])
    out_path = os.path.join(workdir, "decode_beam.jsonl")
    t0 = time.perf_counter()
    res = decode_cli.main(["--config", config_path, "--ckpt", ckpt,
                           "--method", "beam", "--max-utts", str(n_utts),
                           "--output", out_path] + sets)
    wall = time.perf_counter() - t0
    with open(out_path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    if res["num_utts"] != n_utts or len(recs) != n_utts:
        raise AssertionError(f"decoded {res['num_utts']} of {n_utts}")
    if not all(np.isfinite(r["score"]) for r in recs):
        raise AssertionError("non-finite beam score")
    log(f"(d) decode.main --method beam: {n_utts} utts in {wall:.1f} s wall "
        f"(compile included), wer {res['wer']}, cer {res['cer']}, p50 "
        f"batch-amortized latency {res['p50_latency_s']} s [{card}]")

    clips = []
    for i, utt in enumerate(build_synthetic_manifest(2, seed=99,
                                                     prefix="clip")):
        path = os.path.join(workdir, f"clip{i}.npy")
        np.save(path, load_audio(utt))
        clips.append(path)
    hyps = transcribe_cli.main(["--config", config_path, "--ckpt", ckpt]
                               + sets + clips)
    if len(hyps) != len(clips):
        raise AssertionError(f"transcribe returned {hyps}")
    log(f"(d) transcribe.main on {len(clips)} .npy clips: {hyps}")
    return {"decode": res, "transcribe": hyps}


# ----------------------------------------------------------------------
# (e) golden decode
# ----------------------------------------------------------------------

def phase_golden(workdir: str, score_tol: float = GOLDEN_SCORE_TOL) -> dict:
    import jax

    from gluon_e2e_asr import decode as decode_cli

    spec = importlib.util.spec_from_file_location(
        "fidelity_diff", os.path.join(REPO, "tools", "fidelity_diff.py"))
    fidelity_diff = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fidelity_diff)
    out = {}
    for method in ("greedy", "beam"):
        path = os.path.join(workdir, f"golden_{method}.jsonl")
        with jax.default_matmul_precision("highest"):
            decode_cli.main([
                "--config", os.path.join(GOLDEN_DIR, "tiny_golden.yaml"),
                "--ckpt", os.path.join(GOLDEN_DIR, "tiny_golden.msgpack"),
                "--method", method, "--output", path])
        gold = os.path.join(GOLDEN_DIR, f"golden_{method}.jsonl")
        rc = fidelity_diff.main([gold, path, "--score-tol", str(score_tol)])
        g, c = fidelity_diff.load(gold), fidelity_diff.load(path)
        diff = max(abs(g[u].get("score", 0.0) - c[u].get("score", 0.0))
                   for u in g)
        out[method] = {"rc": rc, "max_score_diff": diff}
        log(f"(e) golden {method}: fidelity_diff rc={rc}, {len(g)} utts, "
            f"max |score diff| {diff:.3g} (tol {score_tol:g})")
        if rc != 0:
            raise AssertionError(f"golden {method} decode diverged")
    return out


# ----------------------------------------------------------------------

def run_one_card(workdir: str, card: str, train_steps: int = 20,
                 decode_utts: int = 48) -> dict:
    train = phase_train(workdir, FLAGSHIP, TRAIN_OVERRIDES, train_steps,
                        card)
    step = phase_step_memory(card)
    plain = phase_plain_paths(card)
    dec = phase_decode(workdir, FLAGSHIP, TRAIN_OVERRIDES, train["ckpt"],
                       decode_utts, card)
    golden = phase_golden(workdir)
    return {"train": train, "step": step, "plain": plain, "decode": dec,
            "golden": golden}


def run_four_cards(card: str) -> dict:
    from __graft_entry__ import dryrun_multichip

    t0 = time.perf_counter()
    report = dryrun_multichip(4, tiny=False, rows_per_device=8, seconds=4.0,
                              max_labels=40)
    log(f"(dp) dryrun_multichip(4) at flagship widths: {report} in "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the data-parallel path on 4 cards")
    args = p.parse_args(argv)
    configure_from_env()
    info = phase_device("gpu")
    if args.four_cards:
        if info["device"]["count"] < 4:
            raise SystemExit(
                f"--four-cards needs 4 devices, found {info['device']['count']}")
        run_four_cards(info["card"])
    else:
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            run_one_card(workdir, info["card"])
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    log(f"card: {info['card']}")
    print(json.dumps({"ok": True, "device": info["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
