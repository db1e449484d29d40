"""Checkpoint retention policies (training/checkpoint.py::_prune)
[VERDICT.md round-2 item 7]: keep_policy="best" keeps the K
lowest-dev-WER snapshots (+ the newest for resume, + the best symlink
target); "last" keeps the K most recent as before.
"""

import os

import numpy as np
import pytest

from gluon_e2e_asr.config import (
    Config,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.training.checkpoint import save_checkpoint
from gluon_e2e_asr.training.train_step import (
    create_train_state,
    make_optimizer,
)


def _batch(B=2, S=4000, L=4, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "audio": rng.randn(B, S).astype(np.float32) * 0.1,
        "audio_len": np.array([S] * B, np.int32),
        "labels": rng.randint(4, 10, (B, L)).astype(np.int32),
        "label_len": np.array([L] * B, np.int32),
    }


@pytest.fixture(scope="module")
def tiny_state():
    cfg = Config(
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=16, dec_embed=8, att_dim=8),
        loss=LossConfig(mtl_alpha=0.5),
        train=TrainConfig(seed=0),
    )
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    return create_train_state(cfg, model, make_optimizer(cfg), _batch())


def _ckpts(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".msgpack")
                  and not f.startswith("best"))


def test_keep_best_retains_lowest_wer_plus_newest(tmp_path, tiny_state):
    d = str(tmp_path / "ck")
    wers = {10: 0.50, 20: 0.20, 30: 0.40, 40: 0.25, 50: 0.45}
    for step, w in sorted(wers.items()):
        save_checkpoint(d, tiny_state.replace(step=step),
                        {"dev_wer": w}, keep=2, keep_policy="best",
                        is_best=(w == min(v for s, v in wers.items()
                                          if s <= step)))
    # Best-2 by WER = steps 20 (0.20), 40 (0.25); newest = 50.
    assert _ckpts(d) == ["ckpt_20.msgpack", "ckpt_40.msgpack",
                         "ckpt_50.msgpack"]
    # best symlink points at the lowest-WER snapshot and survives.
    assert os.readlink(os.path.join(d, "best.msgpack")) == "ckpt_20.msgpack"


def test_keep_best_treats_missing_dev_wer_as_worst(tmp_path, tiny_state):
    d = str(tmp_path / "ck")
    save_checkpoint(d, tiny_state.replace(step=1), {"dev_wer": 0.3},
                    keep=1, keep_policy="best")
    # Mid-epoch save: no dev_wer in meta.
    save_checkpoint(d, tiny_state.replace(step=2), {},
                    keep=1, keep_policy="best")
    save_checkpoint(d, tiny_state.replace(step=3), {"dev_wer": 0.4},
                    keep=1, keep_policy="best")
    # keep=1 best (step 1) + newest (step 3); the metaless step 2 dies.
    assert _ckpts(d) == ["ckpt_1.msgpack", "ckpt_3.msgpack"]


def test_keep_last_unchanged(tmp_path, tiny_state):
    d = str(tmp_path / "ck")
    for step in (1, 2, 3, 4):
        save_checkpoint(d, tiny_state.replace(step=step),
                        {"dev_wer": 0.1 * step}, keep=2, keep_policy="last")
    assert _ckpts(d) == ["ckpt_3.msgpack", "ckpt_4.msgpack"]


def test_unknown_policy_raises(tmp_path, tiny_state):
    with pytest.raises(ValueError, match="keep_policy"):
        save_checkpoint(str(tmp_path / "ck"), tiny_state.replace(step=1),
                        {}, keep=1, keep_policy="bogus")
