"""Banded-matmul location feature == conv_general_dilated SAME conv."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.config import ModelConfig
from gluon_e2e_asr.models.decoder import AttentionDecoder


@pytest.mark.parametrize("width,T", [(5, 13), (6, 13), (100, 40), (4, 4)])
def test_band_matches_conv(width, T):
    cfg = ModelConfig(enc_hidden=8, dec_hidden=8, dec_embed=4, att_dim=6,
                      att_type="loc", loc_conv_channels=3,
                      loc_conv_width=width)
    dec = AttentionDecoder(cfg, vocab_size=7)
    rng = np.random.RandomState(0)
    enc = jnp.asarray(rng.randn(2, T, 16).astype(np.float32))
    enc_len = jnp.array([T, T - 1], jnp.int32)
    toks = jnp.asarray(np.full((2, 2), 2, np.int32))
    params = dec.init(jax.random.PRNGKey(0), enc, enc_len, toks)["params"]

    att = jnp.asarray(rng.rand(4, T).astype(np.float32))
    band_mat = dec.apply({"params": params}, T, method=dec.build_loc_band)
    assert band_mat is not None
    feat = dec.apply({"params": params}, att, band_mat,
                     method=dec._loc_feature)
    conv = jax.lax.conv_general_dilated(
        att[:, :, None], params["loc_filter"], (1,), "SAME",
        dimension_numbers=("NWC", "WIO", "NWC"),
    )
    np.testing.assert_allclose(np.asarray(feat), np.asarray(conv),
                               rtol=1e-5, atol=1e-6)
    # conv fallback path (band=None) must agree too
    feat2 = dec.apply({"params": params}, att, None,
                      method=dec._loc_feature)
    np.testing.assert_allclose(np.asarray(feat2), np.asarray(conv),
                               rtol=1e-5, atol=1e-6)


def test_band_gradient_flows_to_filter():
    cfg = ModelConfig(enc_hidden=8, dec_hidden=8, dec_embed=4, att_dim=6,
                      att_type="loc", loc_conv_channels=3, loc_conv_width=5)
    dec = AttentionDecoder(cfg, vocab_size=7)
    rng = np.random.RandomState(0)
    enc = jnp.asarray(rng.randn(2, 9, 16).astype(np.float32))
    enc_len = jnp.array([9, 6], jnp.int32)
    toks = jnp.asarray(np.full((2, 3), 2, np.int32))
    params = dec.init(jax.random.PRNGKey(0), enc, enc_len, toks)["params"]

    def loss(p):
        return jnp.sum(dec.apply({"params": p}, enc, enc_len, toks) ** 2)

    g = jax.grad(loss)(params)
    assert np.abs(np.asarray(g["loc_filter"])).sum() > 0