"""Adadelta optimizer + criterion-based eps annealing (the reference
family's classic RNN-ASR recipe) [SURVEY.md §2.1 #14; config.py
TrainConfig.optimizer/eps_decay/plateau_restore_best]."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gluon_e2e_asr.config import (
    Config, DataConfig, LossConfig, ModelConfig, TrainConfig,
)
from gluon_e2e_asr.training.train_step import decay_opt_eps


def _adadelta_cfg(**kw):
    kw.setdefault("adadelta_eps", 1e-8)
    return Config(train=TrainConfig(
        optimizer="adadelta", learning_rate=1.0, warmup_steps=0, **kw))


def test_adadelta_optimizes_quadratic():
    from gluon_e2e_asr.training.train_step import make_optimizer

    # eps=1e-2 for the unit test: adadelta's first steps scale like
    # sqrt(eps), so the production 1e-8 needs thousands of iterations to
    # ramp (which is exactly why the family anneals eps DOWN on plateaus).
    tx = make_optimizer(_adadelta_cfg(adadelta_eps=1e-2))
    params = {"w": jnp.asarray([3.0, -2.0])}
    state = tx.init(params)

    def loss(p):
        return jnp.sum(p["w"] ** 2)

    l0 = float(loss(params))
    for _ in range(300):
        g = jax.grad(loss)(params)
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    assert float(loss(params)) < 0.1 * l0


def test_decay_opt_eps_scales_injected_eps():
    from gluon_e2e_asr.training.train_step import make_optimizer

    tx = make_optimizer(_adadelta_cfg())
    params = {"w": jnp.ones((3,))}
    state = tx.init(params)
    new_state, old, new = decay_opt_eps(state, 0.01)
    assert old == pytest.approx(1e-8)
    assert new == pytest.approx(1e-10)
    # the annealed state still updates, with a smaller first step
    g = {"w": jnp.ones((3,))}
    u0, _ = tx.update(g, state, params)
    u1, _ = tx.update(g, new_state, params)
    assert float(jnp.abs(u1["w"]).max()) < float(jnp.abs(u0["w"]).max())


def test_decay_opt_eps_floors_at_f32_tiny():
    """Repeated annealing must never underflow eps to exactly 0 (a
    measured mid-training NaN source — BASELINE.md round-2 soaks)."""
    from gluon_e2e_asr.training.train_step import make_optimizer

    tx = make_optimizer(_adadelta_cfg())
    state = tx.init({"w": jnp.ones((2,))})
    last = None
    for _ in range(30):  # 1e-8 * 0.01^30 would underflow f32 by far
        state, _, last = decay_opt_eps(state, 0.01)
    assert last == pytest.approx(float(np.finfo(np.float32).tiny))
    assert last > 0.0


def test_plateau_anneal_patience_gating():
    """eps_decay_patience=N anneals only at the end of each full window
    of consecutive no-best epochs."""
    from types import SimpleNamespace

    from gluon_e2e_asr.training.trainer import Trainer
    from gluon_e2e_asr.training.train_step import make_optimizer

    cfg = _adadelta_cfg(eps_decay=0.01, eps_decay_patience=3)
    tx = make_optimizer(cfg)
    events = []
    fake = SimpleNamespace(
        config=cfg,
        workdir="/nonexistent",
        state=SimpleNamespace(opt_state=tx.init({"w": jnp.ones((2,))})),
        logger=SimpleNamespace(log=events.append),
    )
    fake.state.replace = lambda **kw: SimpleNamespace(
        opt_state=kw.get("opt_state", fake.state.opt_state),
        replace=fake.state.replace)
    for stale in (1, 2, 3, 4, 5, 6):
        fake._stale_epochs = stale
        Trainer._plateau_anneal(fake, epoch=stale)
    decays = [e for e in events if e.get("event") == "eps_decay"]
    assert [e["epoch"] for e in decays] == [3, 6]


def test_decay_opt_eps_noop_for_adam():
    from gluon_e2e_asr.training.train_step import make_optimizer

    tx = make_optimizer(Config(train=TrainConfig(optimizer="adam")))
    state = tx.init({"w": jnp.ones((2,))})
    same, old, new = decay_opt_eps(state, 0.01)
    assert old is None and new is None
    assert jax.tree_util.tree_structure(same) == (
        jax.tree_util.tree_structure(state))


def test_annealed_eps_survives_serialization():
    from gluon_e2e_asr.training.train_step import make_optimizer
    from gluon_e2e_asr.utils import serialization as ser

    tx = make_optimizer(_adadelta_cfg())
    state = tx.init({"w": jnp.ones((2,))})
    new_state, _, _ = decay_opt_eps(state, 0.01)
    blob = ser.msgpack_serialize(ser.to_state_dict(new_state))
    back = ser.from_state_dict(new_state, ser.msgpack_restore(blob))

    def find_eps(s):
        if hasattr(s, "hyperparams"):
            return float(jnp.asarray(s.hyperparams["eps"]))
        if isinstance(s, tuple):
            for x in s:
                r = find_eps(x)
                if r is not None:
                    return r
        return None

    assert find_eps(back) == pytest.approx(1e-10)


def test_adadelta_dp_shard_map_step_runs():
    """Injected-hyperparams optimizer state composes with the shard_map
    DP step (replicated opt state incl. the eps scalar) on the 8-device
    virtual mesh, and decay_opt_eps keeps the state usable between
    steps."""
    from gluon_e2e_asr.data.tokenizer import CharTokenizer
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.parallel.mesh import (
        make_mesh, shard_batch_arrays,
    )
    from gluon_e2e_asr.training.train_step import (
        create_train_state, make_optimizer, make_train_step,
    )

    cfg = Config(
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=16, dec_embed=8, att_dim=8,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.5),
        train=TrainConfig(seed=0, dp=True, optimizer="adadelta",
                          learning_rate=1.0, warmup_steps=0),
    )
    rng = np.random.RandomState(3)
    B = 8
    batch = {
        "audio": rng.randn(B, 8000).astype(np.float32) * 0.1,
        "audio_len": np.full((B,), 8000, np.int32),
        "labels": rng.randint(4, 10, (B, 5)).astype(np.int32),
        "label_len": np.full((B,), 5, np.int32),
    }
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    tx = make_optimizer(cfg)
    state = create_train_state(cfg, model, tx, batch)
    mesh = make_mesh()
    step = make_train_step(model, cfg, tx, mesh=mesh)
    state, metrics = step(state, shard_batch_arrays(mesh, batch))
    assert np.isfinite(float(metrics["loss"]))
    new_opt, old, new = decay_opt_eps(state.opt_state, 0.01)
    assert old is not None and new == pytest.approx(old * 0.01)
    state = state.replace(opt_state=new_opt)
    state, metrics = step(state, shard_batch_arrays(mesh, batch))
    assert np.isfinite(float(metrics["loss"]))


def test_params_only_restore_across_optimizers(tmp_path):
    """Inference-side restore must not depend on the training-time
    optimizer: a checkpoint saved from an adadelta run (4-element
    inject-wrapped opt_state) restores into an adam template with
    params_only=True (the decode/transcribe mode). Regression for the
    measured decode failure: 'size of the list and the state dict do
    not match, got 3 and 4 at path ./opt_state/1'."""
    from gluon_e2e_asr.training.checkpoint import (
        restore_checkpoint, save_checkpoint,
    )
    from gluon_e2e_asr.training.train_step import (
        TrainState, make_optimizer,
    )

    params = {"w": jnp.arange(4.0)}
    tx_ad = make_optimizer(_adadelta_cfg())
    state = TrainState(step=jnp.asarray(7, jnp.int32), params=params,
                       opt_state=tx_ad.init(params),
                       rng=jax.random.PRNGKey(0))
    path = save_checkpoint(str(tmp_path), state, {})
    tx_adam = make_optimizer(Config(train=TrainConfig(optimizer="adam")))
    template = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx_adam.init(params),
                          rng=jax.random.PRNGKey(1))
    # full restore fails across optimizer families...
    with pytest.raises(Exception):
        restore_checkpoint(path, template)
    # ...params_only succeeds and carries params + step
    got, _, _ = restore_checkpoint(path, template, params_only=True)
    np.testing.assert_array_equal(np.asarray(got.params["w"]),
                                  np.arange(4.0))
    assert int(got.step) == 7


@pytest.mark.slow
def test_trainer_plateau_anneal_and_restore(tmp_path):
    """A run whose dev WER plateaus emits eps_decay events, restores the
    best params, and checkpoints the annealed eps for resume."""
    from gluon_e2e_asr.training.trainer import Trainer

    cfg = Config(
        data=DataConfig(synth_num_train=8, synth_num_dev=4, batch_size=4,
                        bucket_bounds_sec=(2.0, 4.0)),
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=16, dec_embed=8, att_dim=8,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.5),
        train=TrainConfig(
            seed=0, num_epochs=4, optimizer="adadelta", learning_rate=1.0,
            warmup_steps=0, eps_decay=0.01, plateau_restore_best=True,
            ckpt_dir="ck", log_every_steps=1000,
        ),
    )
    t = Trainer(cfg, workdir=str(tmp_path))
    t.train()
    events = [json.loads(line)
              for line in open(tmp_path / "metrics.jsonl")]
    decays = [e for e in events if e.get("event") == "eps_decay"]
    bests = sum(1 for e in events
                if e.get("event") == "epoch") - len(decays)
    # 4 epochs at this scale cannot improve dev WER every time; at least
    # one plateau epoch must have annealed (and logged the old/new eps).
    assert decays, "expected at least one plateau epoch in 4 tiny epochs"
    assert decays[0]["eps_new"] == pytest.approx(
        decays[0]["eps_old"] * 0.01)
    assert decays[0]["restored_best"] in (True, False)
    assert bests >= 1  # epoch 0 is always a best
    # the checkpointed opt state carries the annealed eps
    from gluon_e2e_asr.training.checkpoint import (
        latest_checkpoint, restore_checkpoint,
    )

    path = latest_checkpoint(str(tmp_path / "ck"))
    state, _, _ = restore_checkpoint(path, t.state)

    def find_eps(s):
        if hasattr(s, "hyperparams"):
            return float(jnp.asarray(s.hyperparams["eps"]))
        if isinstance(s, tuple):
            for x in s:
                r = find_eps(x)
                if r is not None:
                    return r
        return None

    expect = 1e-8 * (0.01 ** len(decays))
    assert find_eps(state.opt_state) == pytest.approx(expect, rel=1e-3)
