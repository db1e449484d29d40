"""Gradient accumulation (train.accum_grad_steps) correctness
[SURVEY.md §2.1 #14; the reference family's accum_grad knob].

The contract: N accumulated micro-batches take the SAME optimizer update
as one combined batch (num_real-weighted grad mean), exact up to float
summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.config import (
    Config,
    DataConfig,
    FrontendConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.manifest import build_synthetic_manifest
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.training.train_step import (
    accumulate_grads,
    create_train_state,
    make_apply_step,
    make_grad_step,
    make_optimizer,
    make_train_step,
)


def _setup(batch=8):
    # Deterministic: no SpecAugment / dropout / scheduled sampling, so the
    # per-micro-batch PRNG advance cannot change the math.
    cfg = Config(
        data=DataConfig(dataset="synthetic", synth_num_train=batch,
                        synth_max_tokens=5, batch_size=batch,
                        bucket_bounds_sec=(1.5,)),
        frontend=FrontendConfig(specaug_freq_masks=0, specaug_time_masks=0),
        model=ModelConfig(enc_hidden=32, enc_layers=2, enc_subsample=(1, 2),
                          dec_hidden=32, dec_embed=16, att_dim=16,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.3),
        train=TrainConfig(seed=0),
    )
    tok = CharTokenizer()
    utts = build_synthetic_manifest(batch, seed=0, max_tokens=5)
    specs = make_bucket_specs(cfg.data.bucket_bounds_sec, 16000, batch, 16)
    sampler = BucketSampler(utts, specs, 16000, seed=0, shuffle=False)
    loader = DataLoader(utts, sampler, tok)
    b = next(iter(loader.epoch(0)))
    full = {
        "audio": b.audio, "audio_len": b.audio_len,
        "labels": b.labels, "label_len": b.label_len,
    }
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    tx = make_optimizer(cfg)
    state = create_train_state(cfg, model, tx, full)
    return cfg, model, tx, state, full


def _halves(full):
    a = {k: v[:4] for k, v in full.items()}
    b = {k: v[4:] for k, v in full.items()}
    return a, b


def test_accum_two_micro_batches_match_one_big_batch():
    cfg, model, tx, state, full = _setup()
    big_step = make_train_step(model, cfg, tx, mesh=None)
    # Fresh identical state for the accumulated path (donated buffers).
    cfg2, model2, tx2, state2, full2 = _setup()
    grad_step = make_grad_step(model2, cfg2, mesh=None)
    apply_step = make_apply_step(tx2)

    s_big, m_big = big_step(state, {k: jnp.asarray(v)
                                    for k, v in full.items()})

    m1, m2 = _halves(full2)
    state2, g1, met1 = grad_step(state2, {k: jnp.asarray(v)
                                          for k, v in m1.items()})
    state2, g2, met2 = grad_step(state2, {k: jnp.asarray(v)
                                          for k, v in m2.items()})
    acc = accumulate_grads(g1, g2)
    total_n = met1["num_real"] + met2["num_real"]
    s_acc, grad_norm = apply_step(state2, acc, total_n)

    assert int(total_n) == full["audio"].shape[0]
    np.testing.assert_allclose(float(grad_norm),
                               float(m_big["grad_norm"]), rtol=1e-4)
    # Weighted micro losses recombine to the big-batch loss.
    recombined = (float(met1["loss"]) * float(met1["num_real"])
                  + float(met2["loss"]) * float(met2["num_real"])) / float(
                      total_n)
    np.testing.assert_allclose(recombined, float(m_big["loss"]), rtol=1e-5)
    # Identical optimizer update.
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(s_big.params)),
                    jax.tree_util.tree_leaves(jax.device_get(s_acc.params))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert int(s_acc.step) == int(s_big.step) == 1


@pytest.mark.slow
def test_accum_trainer_counts_optimizer_steps(tmp_path):
    """5 batches/epoch at accum=2 -> 3 optimizer steps (2 full groups +
    the remainder flush); resume bookkeeping counts optimizer steps."""
    from gluon_e2e_asr.training.trainer import Trainer

    cfg = Config(
        data=DataConfig(dataset="synthetic", synth_num_train=10,
                        synth_max_tokens=5, batch_size=2,
                        bucket_bounds_sec=(1.5,), prefetch_depth=0),
        frontend=FrontendConfig(specaug_freq_masks=0, specaug_time_masks=0),
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=16, dec_embed=8, att_dim=8,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.3),
        train=TrainConfig(seed=0, num_epochs=1, warmup_steps=2,
                          accum_grad_steps=2, log_every_steps=1,
                          ckpt_dir="ck"),
    )
    tr = Trainer(cfg, workdir=str(tmp_path))
    tr.train()
    assert int(tr.state.step) == 3
    assert tr._micro == 0 and tr._acc is None  # no group left open


@pytest.mark.slow
def test_early_stop_patience(tmp_path, monkeypatch):
    """train.early_stop_patience halts after N stale epochs; the best
    checkpoint tracking is unaffected (scripted dev WERs)."""
    from gluon_e2e_asr.training.trainer import Trainer

    cfg = Config(
        data=DataConfig(dataset="synthetic", synth_num_train=4,
                        synth_max_tokens=5, batch_size=4,
                        bucket_bounds_sec=(1.5,), prefetch_depth=0),
        frontend=FrontendConfig(specaug_freq_masks=0, specaug_time_masks=0),
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=16, dec_embed=8, att_dim=8,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.3),
        train=TrainConfig(seed=0, num_epochs=10, warmup_steps=2,
                          early_stop_patience=2, ckpt_dir="ck"),
    )
    tr = Trainer(cfg, workdir=str(tmp_path))
    # improves at epochs 0 and 1, stale from epoch 2 on -> stop after
    # epoch 3 (two stale epochs: 2 and 3).
    script = iter([0.9, 0.5, 0.5, 0.6, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4])
    monkeypatch.setattr(
        tr, "evaluate",
        lambda: {"dev_wer": next(script), "dev_cer": 0.0})
    final = tr.train()
    assert final["epoch"] == 3
    assert tr.best_wer == 0.5


@pytest.mark.slow
def test_accum_grad_step_dp_matches_single_device():
    from gluon_e2e_asr.parallel.mesh import make_mesh, shard_batch_arrays

    cfg, model, tx, state, full = _setup()
    cfg.train.dp = True
    grad_1d = make_grad_step(model, cfg, mesh=None)
    mesh = make_mesh()
    grad_dp = make_grad_step(model, cfg, mesh=mesh)

    cfg2, model2, tx2, state2, full2 = _setup()
    _, g1, m1 = grad_1d(state, {k: jnp.asarray(v) for k, v in full.items()})
    _, gd, md = grad_dp(state2, shard_batch_arrays(mesh, full2))
    assert int(m1["num_real"]) == int(md["num_real"])
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(g1)),
                    jax.tree_util.tree_leaves(jax.device_get(gd))):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
