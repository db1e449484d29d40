"""Fault-injection / crash-only recovery [SURVEY.md §5 'Failure
detection']: training interrupted mid-epoch and resumed from its last
checkpoint must reproduce the uninterrupted run bit-for-bit (params,
PRNG stream, and batch order all restored)."""

import os

import jax
import numpy as np

from gluon_e2e_asr.config import Config, DataConfig, LossConfig, ModelConfig, TrainConfig
from gluon_e2e_asr.training.trainer import Trainer
import pytest


def _cfg(workdir, max_steps=-1, ckpt_every=0):
    return Config(
        data=DataConfig(
            dataset="synthetic", synth_num_train=32, synth_num_dev=8,
            synth_max_tokens=5, batch_size=8, bucket_bounds_sec=(1.5,),
        ),
        model=ModelConfig(enc_hidden=32, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=32, dec_embed=16, att_dim=16,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.5, scheduled_sampling=0.0),
        train=TrainConfig(
            seed=3, num_epochs=2, learning_rate=1e-3, warmup_steps=4,
            max_steps=max_steps, ckpt_every_steps=ckpt_every,
            ckpt_dir=os.path.join(workdir, "ckpts"),
            metrics_path=os.path.join(workdir, "metrics.jsonl"),
            log_every_steps=100,
        ),
    )


def _params(t):
    return jax.tree_util.tree_leaves(jax.device_get(t.state.params))


@pytest.mark.slow
def test_midepoch_crash_resume_reproduces_run(tmp_path):
    # Uninterrupted reference run: 2 epochs x 4 batches = 8 steps.
    w_ref = tmp_path / "ref"
    w_ref.mkdir()
    t_ref = Trainer(_cfg(str(w_ref)), workdir=str(w_ref))
    t_ref.train()
    assert int(t_ref.state.step) == 8

    # "Crash" mid-epoch-1 at step 6 (2 batches into epoch 1).
    w = tmp_path / "crash"
    w.mkdir()
    t1 = Trainer(_cfg(str(w), max_steps=6), workdir=str(w))
    t1.train()
    assert int(t1.state.step) == 6

    # Recover: fresh process, resume from the mid-epoch checkpoint.
    t2 = Trainer(_cfg(str(w)), workdir=str(w))
    t2.maybe_resume()
    assert int(t2.state.step) == 6
    assert t2.epoch0 == 1
    assert t2.skip_batches == 2
    t2.train()
    assert int(t2.state.step) == 8

    for a, b in zip(_params(t_ref), _params(t2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_periodic_ckpt_resume(tmp_path):
    w = tmp_path / "p"
    w.mkdir()
    cfg = _cfg(str(w), ckpt_every=3)
    t1 = Trainer(cfg, workdir=str(w))
    t1.train()
    # periodic + epoch checkpoints exist, best symlink exists
    names = os.listdir(os.path.join(str(w), "ckpts"))
    assert "best.msgpack" in names
    assert any(n.startswith("ckpt_") for n in names)
