"""Training-engine option coverage: remat, bf16 compute, profiling trace,
optimizer variants [SURVEY.md §5]."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.config import Config, DataConfig, LossConfig, ModelConfig, TrainConfig
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.training.train_step import (
    compute_loss,
    create_train_state,
    make_optimizer,
    make_train_step,
)


def _batch(B=2, S=8000, L=6, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "audio": rng.randn(B, S).astype(np.float32) * 0.1,
        "audio_len": np.array([S] * B, np.int32),
        "labels": rng.randint(4, 10, (B, L)).astype(np.int32),
        "label_len": np.array([L] * B, np.int32),
    }


def _cfg(**model_kw):
    return Config(
        model=ModelConfig(enc_hidden=24, enc_layers=2, enc_subsample=(1, 2),
                          dec_hidden=24, dec_embed=12, att_dim=12,
                          att_type="add", **model_kw),
        loss=LossConfig(mtl_alpha=0.5),
        train=TrainConfig(seed=0),
    )


@pytest.mark.slow
def test_remat_matches_no_remat():
    """Rematerialized encoder produces identical loss and gradients."""
    batch = _batch()
    tok = CharTokenizer()
    rng = jax.random.PRNGKey(1)
    grads = {}
    for remat in (False, True):
        cfg = _cfg(remat=remat)
        model = build_model(cfg, tok.vocab_size)
        state = create_train_state(cfg, model, make_optimizer(cfg), batch)
        g = jax.grad(
            lambda p: compute_loss(
                p, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
                model=model, config=cfg, train=True,
            )[0]
        )(state.params)
        grads[remat] = jax.tree_util.tree_leaves(jax.device_get(g))
    for a, b in zip(grads[False], grads[True]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_bfloat16_compute_dtype_trains():
    """compute_dtype=bfloat16 runs and yields finite loss close to the
    fp32 loss."""
    batch = _batch()
    tok = CharTokenizer()
    losses = {}
    for dt in ("float32", "bfloat16"):
        cfg = _cfg(compute_dtype=dt)
        model = build_model(cfg, tok.vocab_size)
        tx = make_optimizer(cfg)
        state = create_train_state(cfg, model, tx, batch)
        step = make_train_step(model, cfg, tx)
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses[dt] = float(metrics["loss"])
        assert np.isfinite(losses[dt])
    assert abs(losses["bfloat16"] - losses["float32"]) < 0.2, losses


@pytest.mark.slow
def test_profiler_trace_writes_files(tmp_path):
    """jax.profiler trace gating [SURVEY.md §5 tracing]."""
    from gluon_e2e_asr.training.trainer import Trainer

    cfg = Config(
        data=DataConfig(dataset="synthetic", synth_num_train=8,
                        synth_num_dev=4, synth_max_tokens=4, batch_size=8,
                        bucket_bounds_sec=(1.5,)),
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,)),
        loss=LossConfig(mtl_alpha=1.0),
        train=TrainConfig(
            num_epochs=4, ckpt_dir=str(tmp_path / "ck"),
            metrics_path=str(tmp_path / "m.jsonl"),
            profile_dir=str(tmp_path / "prof"),
            profile_start_step=1, profile_num_steps=2,
        ),
    )
    t = Trainer(cfg, workdir=str(tmp_path))
    t.train()
    traces = glob.glob(str(tmp_path / "prof" / "**" / "*"), recursive=True)
    assert traces, "no trace files written"


@pytest.mark.slow
def test_sgd_optimizer():
    batch = _batch()
    tok = CharTokenizer()
    cfg = _cfg()
    cfg.train.optimizer = "sgd"
    model = build_model(cfg, tok.vocab_size)
    tx = make_optimizer(cfg)
    state = create_train_state(cfg, model, tx, batch)
    step = make_train_step(model, cfg, tx)
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    assert np.isfinite(float(metrics["loss"]))


def test_cli_set_overrides():
    """--set dotted overrides parse with yaml scalar rules and reject
    unknown keys (same strictness as the loader)."""
    import pytest

    from gluon_e2e_asr.config import Config, apply_overrides

    c = Config()
    apply_overrides(c, ["model.att_type=dot", "data.batch_size=96",
                        "train.dp=true", "loss.mtl_alpha=0.5",
                        "data.bucket_bounds_sec=[1.0, 3.5]"])
    assert c.model.att_type == "dot"
    assert c.data.batch_size == 96
    assert c.train.dp is True
    assert abs(c.loss.mtl_alpha - 0.5) < 1e-9
    assert c.data.bucket_bounds_sec == (1.0, 3.5)
    with pytest.raises(KeyError):
        apply_overrides(c, ["model.no_such_key=1"])
    with pytest.raises(ValueError):
        apply_overrides(c, ["model.att_type"])


@pytest.mark.slow
def test_scheduled_sampling_ramp():
    """The sampling-ratio ramp [SURVEY.md §2.1 #12]: with a warmup, the
    effective scheduled-sampling probability is 0 at step 0 (loss equals
    the no-sampling loss exactly) and ramps linearly to the target, where
    it changes the drawn coins (loss differs)."""
    batch = _batch(seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tok = CharTokenizer()
    rng = jax.random.PRNGKey(7)

    cfg_off = _cfg()
    cfg_off.loss = LossConfig(mtl_alpha=0.5, scheduled_sampling=0.0)
    cfg_ramp = _cfg()
    cfg_ramp.loss = LossConfig(
        mtl_alpha=0.5, scheduled_sampling=1.0,
        scheduled_sampling_warmup_steps=100)

    model = build_model(cfg_off, tok.vocab_size)
    state = create_train_state(cfg_off, model, make_optimizer(cfg_off), batch)

    def loss_at(cfg, step):
        val, _ = jax.jit(
            lambda p, s: compute_loss(
                p, jbatch, rng, model=model, config=cfg, train=True,
                step=s)
        )(state.params, jnp.asarray(step, jnp.int32))
        return float(val)

    base = loss_at(cfg_off, 0)
    # Step 0 of the ramp: effective prob 0 -> all coins 0 -> identical loss.
    assert loss_at(cfg_ramp, 0) == pytest.approx(base, abs=1e-6)
    # Fully ramped: prob 1.0 -> coins all 1 (except forced step 0) -> the
    # decoder consumes its own argmax, so the loss must differ.
    assert abs(loss_at(cfg_ramp, 100) - base) > 1e-4
    # The ramp is monotone in expectation; spot-check the traced prob path
    # compiles once and serves multiple steps (same jitted callable).
    f = jax.jit(lambda p, s: compute_loss(
        p, jbatch, rng, model=model, config=cfg_ramp, train=True, step=s)[0])
    l50 = float(f(state.params, jnp.asarray(50, jnp.int32)))
    l100 = float(f(state.params, jnp.asarray(100, jnp.int32)))
    assert np.isfinite(l50) and np.isfinite(l100)
