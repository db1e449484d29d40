"""Checkpoint parameter averaging (tools/average_ckpts.py): float
leaves are averaged, non-float state comes from the newest snapshot,
and the result restores through the normal checkpoint path."""

import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, "tools")

from average_ckpts import (  # noqa: E402
    average_checkpoints,
    ordered_last_ckpts,
)

from gluon_e2e_asr.config import (
    Config,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.training.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
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


def test_average_restores_as_param_mean(tmp_path):
    cfg = Config(
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=16, dec_embed=8, att_dim=8),
        loss=LossConfig(mtl_alpha=0.5),
        train=TrainConfig(seed=0),
    )
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    state = create_train_state(cfg, model, make_optimizer(cfg), _batch())
    ckpt_dir = str(tmp_path / "ck")

    s1 = state.replace(step=10)
    save_checkpoint(ckpt_dir, s1, {"note": "first"})
    s2 = state.replace(
        step=20,
        params=jax.tree_util.tree_map(lambda x: x + 2.0, state.params),
    )
    save_checkpoint(ckpt_dir, s2, {"note": "second"})

    paths = ordered_last_ckpts(ckpt_dir, 2)
    assert [p.endswith(f"ckpt_{s}.msgpack") for p, s in zip(paths, (10, 20))]
    out = str(tmp_path / "avg.msgpack")
    meta = average_checkpoints(paths, out)
    assert meta["averaged_from"] == ["ckpt_10.msgpack", "ckpt_20.msgpack"]

    restored, _, meta2 = restore_checkpoint(out, state)
    assert int(restored.step) == 20  # non-param state from the newest
    want = jax.tree_util.tree_map(lambda x: x + 1.0, state.params)
    for a, b in zip(
        jax.tree_util.tree_leaves(restored.params),
        jax.tree_util.tree_leaves(want),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    assert meta2["averaged_from"] == ["ckpt_10.msgpack", "ckpt_20.msgpack"]


def test_average_requires_two(tmp_path):
    with pytest.raises(ValueError):
        average_checkpoints(["only_one.msgpack"], str(tmp_path / "o.msgpack"))


def test_ordered_best_ckpts_selects_by_sidecar_wer(tmp_path):
    import json
    import os

    from average_ckpts import ordered_best_ckpts

    d = str(tmp_path / "bk")
    os.makedirs(d)
    for step, w in [(10, 0.5), (20, 0.2), (30, None), (40, 0.3), (50, 0.25)]:
        open(f"{d}/ckpt_{step}.msgpack", "wb").write(b"x")
        meta = {"step": step}
        if w is not None:
            meta["dev_wer"] = w
        json.dump(meta, open(f"{d}/ckpt_{step}.msgpack.json", "w"))
    got = [os.path.basename(p) for p in ordered_best_ckpts(d, 3)]
    # Three lowest WERs (20/50/40), returned oldest-first; the metaless
    # mid-epoch ckpt_30 is excluded.
    assert got == ["ckpt_20.msgpack", "ckpt_40.msgpack", "ckpt_50.msgpack"]
