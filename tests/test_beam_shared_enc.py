"""step_beam (shared encoder, [B,K] attention) must match step (K-fold
replicated encoder) exactly — they are the same math in different
layouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.config import ModelConfig
from gluon_e2e_asr.models.decoder import AttentionDecoder


@pytest.mark.parametrize("att_type", ["dot", "add", "loc"])
def test_step_beam_matches_replicated_step(att_type):
    cfg = ModelConfig(
        enc_hidden=12, dec_hidden=16, dec_layers=2, dec_embed=8, att_dim=10,
        att_type=att_type, loc_conv_channels=4, loc_conv_width=5,
    )
    V, B, K, T = 9, 2, 3, 7
    dec = AttentionDecoder(cfg, vocab_size=V)
    rng = np.random.RandomState(0)
    enc = jnp.asarray(rng.randn(B, T, 2 * cfg.enc_hidden).astype(np.float32))
    enc_len = jnp.array([7, 4], jnp.int32)
    tokens_init = jnp.asarray(
        np.concatenate([np.full((B, 1), 2), rng.randint(4, V, (B, 2))], 1
                       ).astype(np.int32)
    )
    params = dec.init(jax.random.PRNGKey(0), enc, enc_len, tokens_init)[
        "params"
    ]
    enc_mask = (jnp.arange(T)[None] < enc_len[:, None]).astype(jnp.float32)
    enc_proj = dec.apply({"params": params}, enc, method=dec.precompute)

    # replicated-layout reference
    enc_rep = jnp.repeat(enc, K, axis=0)
    proj_rep = jnp.repeat(enc_proj, K, axis=0)
    mask_rep = jnp.repeat(enc_mask, K, axis=0)
    state_ref = dec.apply({"params": params}, B * K, T,
                          method=dec.init_state)
    state_bm = dec.apply({"params": params}, B, K, T,
                         method=dec.init_state_beam)

    toks = jnp.asarray(rng.randint(4, V, (3, B * K)).astype(np.int32))
    for step_i in range(3):
        state_ref, logits_ref = dec.apply(
            {"params": params}, state_ref, toks[step_i], enc_rep, proj_rep,
            mask_rep, method=dec.step,
        )
        state_bm, logits_bm = dec.apply(
            {"params": params}, state_bm, toks[step_i], enc, enc_proj,
            enc_mask, K, method=dec.step_beam,
        )
        np.testing.assert_allclose(
            np.asarray(logits_bm), np.asarray(logits_ref), rtol=1e-5,
            atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(state_bm["att_w"].reshape(B * K, T)),
            np.asarray(state_ref["att_w"]),
            rtol=1e-5, atol=1e-6,
        )
