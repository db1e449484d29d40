"""Delta features (frontend.deltas) — the Kaldi-era add-deltas stage as
an on-device post-stage shared by both frontend impls
[SURVEY.md §2.1 #4-#7 frontend family; config.py FrontendConfig.deltas]."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.config import Config, FrontendConfig, ModelConfig
from gluon_e2e_asr.frontend.features import add_deltas, frontend_apply


def _ref_deltas(x, length, order, window=2):
    """NumPy reference: Kaldi add-deltas with edge replication inside the
    valid range; zeros outside."""
    F, M = x.shape
    denom = 2.0 * sum(n * n for n in range(1, window + 1))
    blocks = [x.copy()]
    cur = x.copy()
    for _ in range(order):
        nxt = np.zeros_like(cur)
        for t in range(F):
            for n in range(1, window + 1):
                ip = min(t + n, max(length - 1, 0))
                im = max(min(t - n, max(length - 1, 0)), 0)
                nxt[t] += n * (cur[ip] - cur[im])
        cur = nxt / denom
        blocks.append(cur)
    out = np.concatenate(blocks, axis=-1)
    out[length:] = 0.0
    return out


def test_matches_reference_with_ragged_lengths():
    rng = np.random.RandomState(0)
    B, F, M = 3, 12, 4
    x = rng.randn(B, F, M).astype(np.float32)
    lens = np.array([12, 7, 1], np.int32)
    got = np.asarray(add_deltas(jnp.asarray(x), jnp.asarray(lens), 2))
    for b in range(B):
        want = _ref_deltas(x[b], int(lens[b]), 2)
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-6)


def test_constant_signal_zero_deltas_linear_ramp_constant_delta():
    F, M = 16, 2
    lens = jnp.asarray([F], jnp.int32)
    const = jnp.ones((1, F, M))
    out = add_deltas(const, lens, 1)
    np.testing.assert_allclose(np.asarray(out[..., M:]), 0.0, atol=1e-7)
    ramp = jnp.broadcast_to(
        jnp.arange(F, dtype=jnp.float32)[None, :, None], (1, F, M))
    d = np.asarray(add_deltas(ramp, lens, 1))[0, :, M:]
    # interior: slope exactly 1; edges shrink (replication)
    np.testing.assert_allclose(d[2:-2], 1.0, atol=1e-6)
    assert d[0].max() < 1.0 and d[-1].max() < 1.0


def test_order_zero_identity_and_shapes():
    x = jnp.ones((2, 5, 3))
    lens = jnp.asarray([5, 2], jnp.int32)
    assert add_deltas(x, lens, 0) is x
    assert add_deltas(x, lens, 1).shape == (2, 5, 6)
    assert add_deltas(x, lens, 2).shape == (2, 5, 9)


def test_frontend_apply_with_deltas_end_to_end():
    cfg = FrontendConfig(deltas=2)
    rng = np.random.RandomState(1)
    audio = jnp.asarray(rng.randn(2, 8000).astype(np.float32) * 0.1)
    lens = jnp.asarray([8000, 4000], jnp.int32)
    feats, feat_len = jax.jit(
        lambda a, l: frontend_apply(cfg, a, l, train=False))(audio, lens)
    assert feats.shape[-1] == cfg.n_mels * 3
    # padded frames stay zero
    fl = int(feat_len[1])
    assert not np.asarray(feats)[1, fl:].any()
    assert np.isfinite(np.asarray(feats)).all()


def test_model_trains_with_deltas():
    from gluon_e2e_asr.data.tokenizer import CharTokenizer
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.training.train_step import (
        compute_loss, create_train_state, make_optimizer,
    )

    cfg = Config(model=ModelConfig(
        enc_hidden=16, enc_layers=1, enc_subsample=(2,), dec_hidden=16,
        dec_embed=8, att_dim=8, att_type="add"))
    cfg.frontend.deltas = 1
    rng = np.random.RandomState(2)
    batch = {
        "audio": rng.randn(2, 8000).astype(np.float32) * 0.1,
        "audio_len": np.array([8000, 6000], np.int32),
        "labels": rng.randint(4, 10, (2, 5)).astype(np.int32),
        "label_len": np.array([5, 3], np.int32),
    }
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    state = create_train_state(cfg, model, make_optimizer(cfg), batch)
    loss, _ = compute_loss(
        state.params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), model=model, config=cfg, train=True)
    assert np.isfinite(float(loss))
