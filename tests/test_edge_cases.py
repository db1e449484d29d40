"""Robustness edge cases: infeasible CTC labels, zero-length rows in
decode, yaml fallback parser, percentile helper."""

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.config import _parse_yaml, config_from_dict
from gluon_e2e_asr.ops.ctc import ctc_loss
from gluon_e2e_asr.utils.logging import percentile


def test_ctc_infeasible_label_zeroed():
    """Label needs more frames than available (repeats require interposed
    blanks): the row contributes exactly 0 loss and 0 gradient instead of
    a ~1e30 loss that would poison global-norm clipping."""
    B, T, V, L = 2, 3, 5, 3
    rng = np.random.RandomState(0)
    logits = jnp.asarray(rng.randn(B, T, V).astype(np.float32))
    # row 0: "2 2 2" needs 5 frames (two interposed blanks) > 3 -> infeasible
    # row 1: "1 2 3" needs 3 frames == 3 -> feasible
    labels = jnp.array([[2, 2, 2], [1, 2, 3]], jnp.int32)
    lens_t = jnp.array([T, T], jnp.int32)
    lens_l = jnp.array([L, L], jnp.int32)
    loss = ctc_loss(logits, lens_t, labels, lens_l)
    assert float(loss[0]) == 0.0
    assert 0.0 < float(loss[1]) < 100.0
    g = jax.grad(lambda x: ctc_loss(x, lens_t, labels, lens_l).sum())(logits)
    np.testing.assert_array_equal(np.asarray(g[0]), 0.0)
    assert np.abs(np.asarray(g[1])).sum() > 0
    assert np.isfinite(np.asarray(g)).all()


def test_beam_pure_ctc_weight_no_collapse():
    """ctc_weight=1.0: dead beam slots must stay suppressed via the alive
    mask (the att term no longer carries their -inf)."""
    from gluon_e2e_asr.config import Config, DecodeConfig, LossConfig, ModelConfig
    from gluon_e2e_asr.data.tokenizer import CharTokenizer
    from gluon_e2e_asr.decoding.beam import make_beam_decoder
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.training.train_step import (
        create_train_state, make_optimizer,
    )

    cfg = Config(
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=16, dec_embed=8, att_dim=8,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.3),
        decode=DecodeConfig(method="beam", beam_size=4, ctc_weight=1.0,
                            maxlen_ratio=0.3),
    )
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size)
    rng = np.random.RandomState(1)
    batch = {
        "audio": rng.randn(2, 8000).astype(np.float32) * 0.1,
        "audio_len": np.array([8000, 8000], np.int32),
        "labels": rng.randint(4, 10, (2, 4)).astype(np.int32),
        "label_len": np.array([4, 4], np.int32),
    }
    state = create_train_state(cfg, model, make_optimizer(cfg), batch)
    decode = make_beam_decoder(model, cfg, tok)
    texts, scores = decode(state.params, jnp.asarray(batch["audio"]),
                           jnp.asarray(batch["audio_len"]))
    assert len(texts) == 2
    assert np.isfinite(scores).all()


def test_beam_zero_length_row():
    from gluon_e2e_asr.config import Config, DecodeConfig, LossConfig, ModelConfig
    from gluon_e2e_asr.data.tokenizer import CharTokenizer
    from gluon_e2e_asr.decoding.beam import make_beam_decoder
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.training.train_step import (
        create_train_state, make_optimizer,
    )

    cfg = Config(
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=16, dec_embed=8, att_dim=8,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.3),
        decode=DecodeConfig(method="beam", beam_size=3, ctc_weight=0.3),
    )
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size)
    rng = np.random.RandomState(0)
    batch = {
        "audio": rng.randn(2, 8000).astype(np.float32) * 0.1,
        "audio_len": np.array([8000, 0], np.int32),  # second row is pad
        "labels": rng.randint(4, 10, (2, 4)).astype(np.int32),
        "label_len": np.array([4, 0], np.int32),
    }
    state = create_train_state(cfg, model, make_optimizer(cfg), batch)
    decode = make_beam_decoder(model, cfg, tok)
    texts, scores = decode(state.params, jnp.asarray(batch["audio"]),
                           jnp.asarray(batch["audio_len"]))
    assert len(texts) == 2  # no crash; pad row yields some (ignorable) hyp


def test_greedy_zero_length_row():
    from gluon_e2e_asr.ops.ctc import ctc_greedy_decode

    logits = jnp.asarray(np.random.RandomState(0).randn(2, 5, 4).astype(np.float32))
    ids, lens = ctc_greedy_decode(logits, jnp.array([5, 0], jnp.int32))
    assert int(lens[1]) == 0


def test_yaml_fallback_parser():
    text = """
# comment
name: test
data:
  dataset: synthetic
  batch_size: 8
  bucket_bounds_sec: [1.5, 3.0]
  shuffle: true
train:
  learning_rate: 0.001
  ckpt_dir: 'ckpts'
"""
    parsed = _parse_yaml(text)
    c = config_from_dict(parsed)
    assert c.name == "test"
    assert c.data.batch_size == 8
    assert c.data.bucket_bounds_sec == (1.5, 3.0)
    assert c.data.shuffle is True
    assert c.train.learning_rate == 0.001
    assert c.train.ckpt_dir == "ckpts"


def test_yaml_scalar_type_coercion(tmp_path):
    """YAML 1.1 parses ``1e-10`` as a STRING (wants ``1.0e-10``); the
    loader must coerce parsed scalars to the dataclass field types so a
    hand-written config doesn't crash deep inside a jit trace."""
    from gluon_e2e_asr.config import load_config

    p = tmp_path / "c.yaml"
    p.write_text(
        "frontend:\n  log_floor: 1e-10\n"
        "data:\n  batch_size: '24'\n  bucket_bounds_sec: [2, 4]\n"
        "train:\n  dp: 'true'\n"
    )
    cfg = load_config(str(p))
    assert cfg.frontend.log_floor == 1e-10
    assert isinstance(cfg.frontend.log_floor, float)
    assert cfg.data.batch_size == 24
    assert cfg.data.bucket_bounds_sec == (2.0, 4.0)
    assert all(isinstance(b, float) for b in cfg.data.bucket_bounds_sec)
    assert cfg.train.dp is True


def test_minimal_parser_without_pyyaml(monkeypatch):
    """Force the no-pyyaml fallback branch."""
    import builtins

    from gluon_e2e_asr import config as cfg_mod

    real_import = builtins.__import__

    def fake_import(name, *a, **k):
        if name == "yaml":
            raise ImportError("no yaml")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", fake_import)
    parsed = cfg_mod._parse_yaml("data:\n  batch_size: 4\n")
    assert parsed == {"data": {"batch_size": 4}}


def test_percentile():
    assert percentile([], 50) == 0.0
    assert percentile([1.0], 50) == 1.0
    vals = [1.0, 2.0, 3.0, 4.0, 5.0]
    assert percentile(vals, 50) == 3.0
    assert percentile(vals, 0) == 1.0
    assert percentile(vals, 100) == 5.0
