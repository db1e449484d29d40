"""Integration tests: overfit, train->ckpt->resume determinism, CLI
[SURVEY.md §4 "Integration" tiers]. Sized to run on CPU in minutes."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.config import Config, DataConfig, LossConfig, ModelConfig, TrainConfig
from gluon_e2e_asr.training.trainer import Trainer


def tiny_config(workdir: str, mtl_alpha=1.0, epochs=350, **kw) -> Config:
    cfg = Config(
        data=DataConfig(
            dataset="synthetic",
            synth_num_train=8,
            synth_num_dev=8,
            synth_min_tokens=3,
            synth_max_tokens=6,
            batch_size=8,
            bucket_bounds_sec=(1.5,),
            shuffle=True,
        ),
        model=ModelConfig(
            enc_hidden=96,
            enc_layers=2,
            enc_subsample=(1, 2),
            dec_hidden=96,
            dec_embed=64,
            att_dim=64,
            att_type="add",
        ),
        loss=LossConfig(mtl_alpha=mtl_alpha, label_smoothing=0.05,
                        scheduled_sampling=0.0),
        train=TrainConfig(
            seed=0,
            num_epochs=epochs,
            learning_rate=3e-3,
            warmup_steps=20,
            grad_clip_norm=5.0,
            ckpt_dir=os.path.join(workdir, "ckpts"),
            metrics_path=os.path.join(workdir, "metrics.jsonl"),
            log_every_steps=10,
            **kw,
        ),
    )
    # Synthetic dev == train for the overfit check.
    return cfg


@pytest.mark.slow
def test_overfit_ctc(tmp_path):
    """BiLSTM+CTC overfits 8 synthetic utterances -> exact greedy
    transcripts [SURVEY.md §4 'Integration: overfit']."""
    cfg = tiny_config(str(tmp_path))
    cfg.data.synth_num_dev = 0  # unused; we eval on train below
    trainer = Trainer(cfg, workdir=str(tmp_path))
    # Eval on the training utterances (overfit target).
    trainer.dev_utts = trainer.train_utts
    trainer.dev_sampler = trainer.sampler
    trainer.dev_loader = trainer.loader
    final = trainer.train()
    assert final["dev_cer"] <= 0.05, final
    assert final["dev_wer"] <= 0.25, final


@pytest.mark.slow
def test_ckpt_resume_bitwise(tmp_path):
    """Resume from checkpoint reproduces params bitwise
    [SURVEY.md §4 'Integration: e2e']."""
    w1 = tmp_path / "a"
    w1.mkdir()
    cfg = tiny_config(str(w1), epochs=2)
    t1 = Trainer(cfg, workdir=str(w1))
    t1.train()
    params_after_2 = jax.device_get(t1.state.params)

    # Same config, 1 epoch, checkpoint, then resume for the 2nd epoch.
    w2 = tmp_path / "b"
    w2.mkdir()
    cfg_a = tiny_config(str(w2), epochs=1)
    t2 = Trainer(cfg_a, workdir=str(w2))
    t2.train()
    cfg_b = tiny_config(str(w2), epochs=2)
    t3 = Trainer(cfg_b, workdir=str(w2))
    t3.maybe_resume()
    assert int(t3.state.step) == int(t2.state.step)
    t3.train()
    params_resumed = jax.device_get(t3.state.params)

    flat1 = jax.tree_util.tree_leaves(params_after_2)
    flat2 = jax.tree_util.tree_leaves(params_resumed)
    for a, b in zip(flat1, flat2):
        np.testing.assert_array_equal(a, b)


def test_metrics_io_economics_fields(tmp_path):
    """The metrics JSONL carries the at-scale IO economics records the
    100 h rehearsal reads: manifest-walk time, checkpoint-save time,
    per-epoch bucket padding waste [VERDICT.md round-3 item 2]."""
    cfg = tiny_config(str(tmp_path), epochs=1)
    trainer = Trainer(cfg, workdir=str(tmp_path))
    trainer.train()
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    by_event = {}
    for r in recs:
        by_event.setdefault(r["event"], []).append(r)
    ds = by_event["datasets"][0]
    assert ds["manifest_walk_s"] >= 0 and ds["train_utts"] == 8
    ck = by_event["ckpt_io"]
    assert ck and all(c["save_s"] > 0 for c in ck)
    ep = by_event["epoch"][-1]
    assert 0.0 <= ep["pad_waste"] < 1.0


@pytest.mark.slow
def test_train_decode_cli(tmp_path):
    """The public train/decode CLI end to end [BASELINE.json:L5]."""
    import json

    workdir = str(tmp_path)
    cfg_path = os.path.join(workdir, "cfg.yaml")
    raw = {
        "name": "cli_test",
        "data": {
            "dataset": "synthetic",
            "synth_num_train": 8,
            "synth_num_dev": 4,
            "synth_max_tokens": 6,
            "batch_size": 8,
            "bucket_bounds_sec": [1.5],
        },
        "model": {
            "enc_hidden": 32,
            "enc_layers": 1,
            "enc_subsample": [2],
        },
        "loss": {"mtl_alpha": 1.0},
        "train": {
            "num_epochs": 1,
            "ckpt_dir": os.path.join(workdir, "ckpts"),
            "metrics_path": os.path.join(workdir, "metrics.jsonl"),
        },
        "decode": {
            "method": "greedy",
            "output_path": os.path.join(workdir, "decode.jsonl"),
        },
    }
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "gluon_e2e_asr.train", "--config", cfg_path],
        capture_output=True, text=True, cwd=repo, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    ckpts = os.listdir(os.path.join(workdir, "ckpts"))
    assert any(c.startswith("ckpt_") for c in ckpts)
    best = os.path.join(workdir, "ckpts", "best.msgpack")
    assert os.path.exists(best)

    r = subprocess.run(
        [sys.executable, "-m", "gluon_e2e_asr.decode", "--config",
         cfg_path, "--ckpt", best],
        capture_output=True, text=True, cwd=repo, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["event"] == "decode_done"
    assert result["num_utts"] == 4
    # per-utterance fidelity records [SURVEY.md §2.1 #22]
    with open(os.path.join(workdir, "decode.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    assert len(recs) == 4
    assert all("hyp" in rec and "utt_id" in rec for rec in recs)
