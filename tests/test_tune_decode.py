"""Decode-knob grid search tool (tools/tune_decode.py): grid parsing,
the deterministic utt-id hash split, and an end-to-end sweep on a tiny
trained model."""

import json
import sys

import pytest

sys.path.insert(0, "tools")

from tune_decode import _parse_grid, in_holdout  # noqa: E402

from gluon_e2e_asr.config import (
    Config,
    DataConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)


def test_parse_grid_types():
    g = _parse_grid(["ctc_weight=0.0,0.3", "beam_size=4,8",
                     "length_norm=true,false"])
    assert g["ctc_weight"] == [0.0, 0.3]
    assert g["beam_size"] == [4, 8]
    assert g["length_norm"] == [True, False]
    with pytest.raises(SystemExit):
        _parse_grid(["oops"])


def test_holdout_split_deterministic_and_balanced():
    ids = [f"dev-{i:05d}" for i in range(1000)]
    marks = [in_holdout(u, 0.5) for u in ids]
    assert marks == [in_holdout(u, 0.5) for u in ids]  # stable
    frac = sum(marks) / len(marks)
    assert 0.4 < frac < 0.6  # hash split is roughly balanced at scale
    assert not any(in_holdout(u, 0.0) for u in ids)
    assert all(in_holdout(u, 1.0) for u in ids)


@pytest.mark.slow
def test_sweep_end_to_end(tmp_path):
    """Train a tiny joint model, sweep 2 combos, check the summary picks
    the tune-best and reports its holdout number (not the grid-best)."""
    from gluon_e2e_asr.training.trainer import Trainer
    from tune_decode import main as tune_main

    cfg = Config(
        data=DataConfig(dataset="synthetic", synth_num_train=32,
                        synth_num_dev=16, synth_max_tokens=5, batch_size=8,
                        bucket_bounds_sec=(2.0,)),
        model=ModelConfig(enc_hidden=24, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=24, dec_embed=12, att_dim=12,
                          att_type="dot"),
        loss=LossConfig(mtl_alpha=0.3),
        train=TrainConfig(num_epochs=3, ckpt_dir=str(tmp_path / "ck"),
                          metrics_path=str(tmp_path / "m.jsonl")),
    )
    from dataclasses import asdict

    # JSON is valid YAML, and json.dump coerces the config's tuples to
    # lists (yaml.safe_dump refuses tuples).
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        json.dump(asdict(cfg), f)
    t = Trainer(cfg, workdir=str(tmp_path))
    t.train()

    out = str(tmp_path / "sweep.jsonl")
    summary = tune_main([
        "--config", cfg_path,
        "--ckpt", str(tmp_path / "ck" / "best.msgpack"),
        "--grid", "ctc_weight=0.0,0.3",
        "--output", out,
    ])
    rows = [json.loads(l) for l in open(out)]
    combos = [r for r in rows if "combo" in r]
    assert len(combos) == 2
    assert all(r["tune_n"] + r["holdout_n"] == 16 for r in combos)
    best = min(combos, key=lambda r: r["tune_wer"])
    assert summary["best_by_tune"] == best["combo"]
    assert summary["holdout_wer_of_best"] == best["holdout_wer"]
