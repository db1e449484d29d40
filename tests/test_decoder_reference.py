"""The teacher-forced decoder scan (AttentionDecoder.__call__) against a
step-by-step loop over ``decoder_step`` that re-implements scheduled
sampling on the host: same coins from the same key, the previous step's
argmax fed where a coin comes up."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.config import ModelConfig
from gluon_e2e_asr.models.asr import ASRModel


def _setup(att_type, seed=0):
    cfg = ModelConfig(
        enc_hidden=12, enc_layers=1, enc_subsample=(1,), dec_hidden=16,
        dec_layers=1, dec_embed=8, att_dim=10, att_type=att_type,
        loc_conv_channels=3, loc_conv_width=5,
    )
    V = 11
    model = ASRModel(cfg, V, sos_id=2, eos_id=3)
    rng = np.random.RandomState(seed)
    B, T, L = 3, 9, 6
    feats = jnp.asarray(rng.randn(B, T, 6).astype(np.float32))
    params = model.init(jax.random.PRNGKey(seed), feats)["params"]
    enc = jnp.asarray(rng.randn(B, T, 2 * cfg.enc_hidden).astype(np.float32))
    enc_len = jnp.array([9, 6, 2], jnp.int32)
    tokens_in = jnp.asarray(np.concatenate(
        [np.full((B, 1), 2), rng.randint(4, V, size=(B, L - 1))],
        axis=1).astype(np.int32))
    return model, params, enc, enc_len, tokens_in


@pytest.mark.parametrize("ss", ["off", "on"])
@pytest.mark.parametrize("att_type", ["dot", "add", "loc"])
def test_teacher_forced_scan_matches_step_loop(att_type, ss):
    model, params, enc, enc_len, tokens_in = _setup(att_type)
    B, T = enc.shape[:2]
    L = tokens_in.shape[1]
    ss_prob, ss_rng = (0.5, jax.random.PRNGKey(7)) if ss == "on" else (
        0.0, None)
    scan_logits = model.decoder(params["decoder"], enc, enc_len, tokens_in,
                                ss_prob, ss_rng)

    if ss_rng is not None:
        coins = np.array(jax.random.bernoulli(ss_rng, ss_prob, (L, B)))
        coins[0] = False  # step 0 always consumes sos
        assert coins[1:].any() and not coins[1:].all()
    else:
        coins = np.zeros((L, B), bool)
    enc_mask = (jnp.arange(T)[None] < enc_len[:, None]).astype(jnp.float32)
    enc_proj = model.apply({"params": params}, enc,
                           method=model.decoder_precompute)
    band = model.apply({"params": params}, T, method=model.decoder_loc_band)
    state = model.apply({"params": params}, B, T,
                        method=model.decoder_init_state)
    prev_pred = np.asarray(tokens_in[:, 0])
    outs = []
    for t in range(L):
        tok = np.where(coins[t], prev_pred, np.asarray(tokens_in[:, t]))
        state, logits = model.apply(
            {"params": params}, state, jnp.asarray(tok, jnp.int32), enc,
            enc_proj, enc_mask, band, method=model.decoder_step)
        prev_pred = np.asarray(jnp.argmax(logits, axis=-1))
        outs.append(np.asarray(logits))
    np.testing.assert_allclose(np.asarray(scan_logits), np.stack(outs, 1),
                               rtol=1e-5, atol=1e-5)
