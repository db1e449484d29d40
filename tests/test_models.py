"""Model-layer unit tests: LSTM masking, encoder shapes, decoder
scan-vs-step parity [SURVEY.md §4]."""

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.config import ModelConfig
from gluon_e2e_asr.models.decoder import AttentionDecoder
from gluon_e2e_asr.models.encoder import BiLSTMEncoder, subsample_concat
from gluon_e2e_asr.models.lstm import lstm_scan
from gluon_e2e_asr.ops.losses import make_decoder_io


def _rand_gates(B, T, H, seed=0):
    rng = np.random.RandomState(seed)
    return jnp.asarray(rng.randn(B, T, 4 * H).astype(np.float32) * 0.5)


def test_lstm_padding_invariance():
    """Outputs for a padded batch equal outputs computed per-sequence."""
    B, T, H = 3, 10, 8
    rng = np.random.RandomState(1)
    w_h = jnp.asarray(rng.randn(H, 4 * H).astype(np.float32) * 0.2)
    xg = _rand_gates(B, T, H)
    lens = jnp.array([10, 6, 3], jnp.int32)
    for reverse in (False, True):
        full = lstm_scan(xg, lens, w_h, reverse=reverse)
        for b in range(B):
            n = int(lens[b])
            solo = lstm_scan(
                xg[b : b + 1, :n], jnp.array([n], jnp.int32), w_h,
                reverse=reverse,
            )
            np.testing.assert_allclose(
                np.asarray(full[b, :n]), np.asarray(solo[0]), rtol=1e-5,
                atol=1e-5,
            )
            # padded region emits zeros
            np.testing.assert_array_equal(np.asarray(full[b, n:]), 0.0)


def test_subsample_concat():
    x = jnp.arange(2 * 6 * 3, dtype=jnp.float32).reshape(2, 6, 3)
    lens = jnp.array([6, 5], jnp.int32)
    y, new_lens = subsample_concat(x, lens, 2)
    assert y.shape == (2, 3, 6)
    np.testing.assert_array_equal(np.asarray(new_lens), [3, 3])
    np.testing.assert_array_equal(
        np.asarray(y[0, 0]), np.asarray(jnp.concatenate([x[0, 0], x[0, 1]]))
    )


def test_encoder_shapes_and_lengths():
    cfg = ModelConfig(enc_hidden=16, enc_layers=3, enc_subsample=(1, 2, 2))
    enc = BiLSTMEncoder(cfg, vocab_size=10)
    B, T, M = 2, 37, 8
    feats = jnp.asarray(np.random.RandomState(0).randn(B, T, M).astype(np.float32))
    feat_len = jnp.array([37, 20], jnp.int32)
    params = enc.init(jax.random.PRNGKey(0), feats, feat_len)["params"]
    x, lens, logits = enc.apply({"params": params}, feats, feat_len)
    # 37 -> 37 -> ceil(37/2)=19 -> ceil(19/2)=10
    assert x.shape == (B, 10, 2 * cfg.enc_hidden)
    assert logits.shape == (B, 10, 10)
    np.testing.assert_array_equal(np.asarray(lens), [10, 5])


def _decoder_setup(att_type="loc", seed=0):
    cfg = ModelConfig(
        enc_hidden=12, dec_hidden=16, dec_layers=2, dec_embed=8, att_dim=10,
        att_type=att_type, loc_conv_channels=4, loc_conv_width=5,
    )
    V = 9
    dec = AttentionDecoder(cfg, vocab_size=V, sos_id=2, eos_id=3)
    rng = np.random.RandomState(seed)
    B, T = 2, 7
    enc = jnp.asarray(rng.randn(B, T, 2 * cfg.enc_hidden).astype(np.float32))
    enc_len = jnp.array([7, 4], jnp.int32)
    tokens_in = jnp.asarray(
        np.concatenate(
            [np.full((B, 1), 2), rng.randint(4, V, size=(B, 4))], axis=1
        ).astype(np.int32)
    )
    params = dec.init(jax.random.PRNGKey(seed), enc, enc_len, tokens_in)["params"]
    return dec, params, enc, enc_len, tokens_in


def test_decoder_scan_step_parity():
    """Teacher-forced scan logits == step-by-step logits (all att types)."""
    for att_type in ("dot", "add", "loc"):
        dec, params, enc, enc_len, tokens_in = _decoder_setup(att_type)
        logits_scan = dec.apply({"params": params}, enc, enc_len, tokens_in)
        B, T = enc.shape[0], enc.shape[1]
        enc_mask = (jnp.arange(T)[None] < enc_len[:, None]).astype(jnp.float32)
        enc_proj = dec.apply({"params": params}, enc, method=dec.precompute)
        state = dec.apply({"params": params}, B, T, method=dec.init_state)
        outs = []
        for step in range(tokens_in.shape[1]):
            state, logits = dec.apply(
                {"params": params}, state, tokens_in[:, step], enc, enc_proj,
                enc_mask, method=dec.step,
            )
            outs.append(logits)
        logits_steps = jnp.stack(outs, axis=1)
        np.testing.assert_allclose(
            np.asarray(logits_scan), np.asarray(logits_steps), rtol=1e-5,
            atol=1e-5,
        )


def test_scheduled_sampling_changes_logits():
    dec, params, enc, enc_len, tokens_in = _decoder_setup("add")
    base = dec.apply({"params": params}, enc, enc_len, tokens_in)
    ss = dec.apply(
        {"params": params}, enc, enc_len, tokens_in, 1.0,
        jax.random.PRNGKey(5),
    )
    # with ss=1.0 inputs after step 0 are model argmax — logits differ
    assert not np.allclose(np.asarray(base), np.asarray(ss))
    # step 0 consumes sos in both cases
    np.testing.assert_allclose(
        np.asarray(base[:, 0]), np.asarray(ss[:, 0]), rtol=1e-6
    )


def test_make_decoder_io():
    labels = jnp.array([[5, 6, 0], [7, 0, 0]], jnp.int32)
    lens = jnp.array([2, 1], jnp.int32)
    tokens_in, targets, mask = make_decoder_io(labels, lens, sos_id=2, eos_id=3)
    np.testing.assert_array_equal(
        np.asarray(tokens_in), [[2, 5, 6, 0], [2, 7, 0, 0]]
    )
    np.testing.assert_array_equal(
        np.asarray(targets), [[5, 6, 3, 0], [7, 3, 0, 0]]
    )
    np.testing.assert_array_equal(
        np.asarray(mask), [[1, 1, 1, 0], [1, 1, 0, 0]]
    )
