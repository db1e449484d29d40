"""Data-parallel correctness on a fake 8-device CPU mesh
[SURVEY.md §4 'Distributed: DP'; BASELINE.json:L10].

psum-equivalence: gradients computed with the batch sharded over the
``data`` mesh axis must equal single-device gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.config import Config, DataConfig, LossConfig, ModelConfig, TrainConfig
from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.manifest import build_synthetic_manifest
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated_sharding,
    shard_batch_arrays,
)
from gluon_e2e_asr.training.train_step import (
    compute_loss,
    create_train_state,
    make_optimizer,
    make_train_step,
)


def _setup(dp_batch=8, deterministic=False):
    from gluon_e2e_asr.config import FrontendConfig

    # deterministic=True removes every stochastic draw (SpecAugment; the
    # config already has no dropout / scheduled sampling) so tests that
    # compare DP mechanisms with DIFFERENT per-shard PRNG disciplines
    # (shard_map folds in axis_index) still expect identical math.
    frontend = (FrontendConfig(specaug_freq_masks=0, specaug_time_masks=0)
                if deterministic else FrontendConfig())
    cfg = Config(
        data=DataConfig(dataset="synthetic", synth_num_train=dp_batch,
                        synth_max_tokens=5, batch_size=dp_batch,
                        bucket_bounds_sec=(1.5,)),
        frontend=frontend,
        model=ModelConfig(enc_hidden=32, enc_layers=2, enc_subsample=(1, 2),
                          dec_hidden=32, dec_embed=16, att_dim=16,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.3),
        train=TrainConfig(seed=0, dp=True),
    )
    tok = CharTokenizer()
    utts = build_synthetic_manifest(dp_batch, seed=0, max_tokens=5)
    specs = make_bucket_specs(cfg.data.bucket_bounds_sec, 16000, dp_batch, 16)
    sampler = BucketSampler(utts, specs, 16000, seed=0, shuffle=False)
    loader = DataLoader(utts, sampler, tok)
    b = next(iter(loader.epoch(0)))
    batch = {
        "audio": b.audio, "audio_len": b.audio_len,
        "labels": b.labels, "label_len": b.label_len,
    }
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    tx = make_optimizer(cfg)
    state = create_train_state(cfg, model, tx, batch)
    return cfg, model, tx, state, batch


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_dp_grads_match_single_device():
    cfg, model, tx, state, batch = _setup()
    rng = jax.random.PRNGKey(42)
    # SpecAugment draws per-utterance masks from the same key either way,
    # so the loss is identical; disable nothing.
    grad_fn = jax.grad(
        lambda p, b: compute_loss(p, b, rng, model=model, config=cfg,
                                  train=True)[0]
    )
    g_single = jax.device_get(
        grad_fn(state.params, {k: jnp.asarray(v) for k, v in batch.items()})
    )

    mesh = make_mesh()
    sharded = shard_batch_arrays(mesh, batch)
    repl = replicated_sharding(mesh)
    g_dp = jax.device_get(
        jax.jit(grad_fn, out_shardings=repl)(state.params, sharded)
    )
    for a, b_ in zip(jax.tree_util.tree_leaves(g_single),
                     jax.tree_util.tree_leaves(g_dp)):
        np.testing.assert_allclose(a, b_, rtol=2e-4, atol=2e-5)


@pytest.mark.slow
def test_dp_train_step_runs_and_matches():
    cfg, model, tx, state, batch = _setup()
    cfg.train.dp_impl = "pjit"  # global-view program: same PRNG draws as 1-dev
    mesh = make_mesh()
    step_dp = make_train_step(model, cfg, tx, mesh=mesh)
    step_1d = make_train_step(model, cfg, tx, mesh=None)

    sharded = shard_batch_arrays(mesh, batch)
    s_dp, m_dp = step_dp(state, sharded)
    # fresh state for the single-device run (donated buffers)
    cfg2, model2, tx2, state2, batch2 = _setup()
    s_1d, m_1d = step_1d(state2, {k: jnp.asarray(v) for k, v in batch2.items()})

    np.testing.assert_allclose(
        float(m_dp["loss"]), float(m_1d["loss"]), rtol=2e-4
    )
    for a, b_ in zip(jax.tree_util.tree_leaves(jax.device_get(s_dp.params)),
                     jax.tree_util.tree_leaves(jax.device_get(s_1d.params))):
        np.testing.assert_allclose(a, b_, rtol=2e-3, atol=2e-4)


def test_shard_map_step_matches_single_device():
    """shard_map DP (psum(grads) on local shards) reproduces the
    single-device step exactly on a deterministic config. The loss is
    normalized by the psum'd GLOBAL real-row count inside compute_loss,
    so summed shard gradients equal global-batch gradients."""
    cfg, model, tx, state, batch = _setup(deterministic=True)
    cfg.train.dp_impl = "shard_map"
    mesh = make_mesh()
    step_sm = make_train_step(model, cfg, tx, mesh=mesh)
    s_sm, m_sm = step_sm(state, shard_batch_arrays(mesh, batch))

    cfg2, model2, tx2, state2, batch2 = _setup(deterministic=True)
    step_1 = make_train_step(model2, cfg2, tx2, mesh=None)
    s_1, m_1 = step_1(state2, {k: jnp.asarray(v) for k, v in batch2.items()})

    np.testing.assert_allclose(float(m_sm["loss"]), float(m_1["loss"]),
                               rtol=2e-5)
    np.testing.assert_allclose(float(m_sm["grad_norm"]),
                               float(m_1["grad_norm"]), rtol=2e-4)
    for a, b_ in zip(jax.tree_util.tree_leaves(jax.device_get(s_sm.params)),
                     jax.tree_util.tree_leaves(jax.device_get(s_1.params))):
        np.testing.assert_allclose(a, b_, rtol=2e-3, atol=2e-4)


@pytest.mark.slow
def test_shard_map_step_stochastic_runs():
    """With SpecAugment on, each shard folds axis_index into its step key
    (distinct draws per shard — PRNG discipline [SURVEY.md §5]); the step
    must still run and produce a finite, replicated loss."""
    cfg, model, tx, state, batch = _setup()
    cfg.train.dp_impl = "shard_map"
    mesh = make_mesh()
    step_sm = make_train_step(model, cfg, tx, mesh=mesh)
    s_sm, m_sm = step_sm(state, shard_batch_arrays(mesh, batch))
    assert np.isfinite(float(m_sm["loss"]))
    assert int(m_sm["num_real"]) == batch["audio"].shape[0]
    # second step runs off the donated state
    s_sm2, m2 = step_sm(s_sm, shard_batch_arrays(mesh, batch))
    assert np.isfinite(float(m2["loss"]))


def test_batch_sharding_layout():
    mesh = make_mesh()
    x = np.zeros((8, 16), np.float32)
    sh = batch_sharding(mesh)
    arr = jax.device_put(x, sh)
    # each device holds 1/8 of the batch
    assert arr.addressable_shards[0].data.shape == (1, 16)


@pytest.mark.slow
def test_dp_decode_matches_single_device():
    """DP decode (shard_map over the data axis) must return the same
    transcripts as the single-device decoders on the same global batch
    [SURVEY.md §2.3 seam; decode.dp]."""
    from gluon_e2e_asr.decoding.beam import make_beam_decoder
    from gluon_e2e_asr.decoding.greedy import make_greedy_decoder

    cfg, model, tx, state, batch = _setup(dp_batch=8, deterministic=True)
    cfg.decode.method = "beam"
    cfg.decode.beam_size = 3
    cfg.decode.ctc_weight = 0.3
    tok = CharTokenizer()
    mesh = make_mesh()
    audio = jnp.asarray(batch["audio"])
    audio_len = jnp.asarray(batch["audio_len"])

    g1 = make_greedy_decoder(model, cfg)
    gd = make_greedy_decoder(model, cfg, mesh=mesh)
    ids1, len1 = g1(state.params, audio, audio_len)
    idsd, lend = gd(state.params, audio, audio_len)
    np.testing.assert_array_equal(np.asarray(len1), np.asarray(lend))
    np.testing.assert_array_equal(np.asarray(ids1), np.asarray(idsd))

    cfg.decode.nbest = 2  # [B,N,...] outputs must shard over B too
    b1 = make_beam_decoder(model, cfg, tok)
    bd = make_beam_decoder(model, cfg, tok, mesh=mesh)
    t1, s1 = b1(state.params, audio, audio_len)
    td, sd = bd(state.params, audio, audio_len)
    assert t1 == td
    np.testing.assert_allclose(s1, sd, rtol=1e-5, atol=1e-5)
    n1 = b1.nbest(state.params, audio, audio_len)
    nd = bd.nbest(state.params, audio, audio_len)
    assert [[t for t, _ in u] for u in n1] == [[t for t, _ in u] for u in nd]
