"""VGG2L conv-front encoder ("vggblstm"): length math, padding
invariance, delta-channel unstacking, gradients, and end-to-end
train-step integration [SURVEY.md §2.1 #8, conv variant]."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gluon_e2e_asr.config import (
    Config, DataConfig, FrontendConfig, LossConfig, ModelConfig,
    TrainConfig, encoder_time_reduction,
)
from gluon_e2e_asr.models.encoder import BiLSTMEncoder


def _vgg_cfg(**kw):
    kw.setdefault("enc_type", "vggblstm")
    kw.setdefault("enc_hidden", 16)
    kw.setdefault("enc_layers", 1)
    kw.setdefault("enc_subsample", (1,))
    kw.setdefault("vgg_channels", (8, 16))
    return ModelConfig(**kw)


def _feats(rng, B, T, D, lens):
    x = rng.randn(B, T, D).astype(np.float32)
    for b, n in enumerate(lens):
        x[b, n:] = 0.0  # frontend contract: padded frames are zero
    return x


def test_vgg_length_math_and_shapes():
    cfg = _vgg_cfg()
    enc = BiLSTMEncoder(cfg, vocab_size=10)
    rng = np.random.RandomState(0)
    lens = [37, 21, 4, 1]
    feats = _feats(rng, 4, 37, 40, lens)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                      jnp.asarray(lens, jnp.int32))
    x, out_lens, logits = enc.apply(params, jnp.asarray(feats),
                                    jnp.asarray(lens, jnp.int32))
    # two SAME 2x pools: T 37 -> 19 -> 10; len = ceil(ceil(len/2)/2)
    assert x.shape == (4, 10, 2 * cfg.enc_hidden)
    expect = [(n + 1) // 2 for n in lens]
    expect = [(n + 1) // 2 for n in expect]
    np.testing.assert_array_equal(np.asarray(out_lens), expect)
    assert logits.shape == (4, 10, 10)
    assert encoder_time_reduction(cfg) == 4


def test_vgg_padding_invariance():
    """Valid encoder frames are identical whichever bucket T the
    utterance is padded to (the static-bucket-shape contract)."""
    cfg = _vgg_cfg()
    enc = BiLSTMEncoder(cfg, vocab_size=10)
    rng = np.random.RandomState(1)
    n = 23
    core = rng.randn(1, n, 40).astype(np.float32)

    def run(T):
        feats = np.zeros((1, T, 40), np.float32)
        feats[:, :n] = core
        p = enc.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                     jnp.asarray([n], jnp.int32))
        x, lens, _ = enc.apply(p, jnp.asarray(feats),
                               jnp.asarray([n], jnp.int32))
        return np.asarray(x), int(lens[0])

    x1, l1 = run(24)
    x2, l2 = run(40)
    assert l1 == l2 == 6  # ceil(ceil(23/2)/2)
    np.testing.assert_allclose(x1[:, :l1], x2[:, :l1], rtol=1e-5, atol=1e-6)


def test_vgg_delta_channel_unstack():
    """vgg_in_channels=3 splits a [static|d|dd] feature axis into conv
    channels: permuting within a delta block must not leak across
    blocks' channel assignment (shape-level check + bad-divisor error)."""
    cfg = _vgg_cfg(vgg_in_channels=3)
    enc = BiLSTMEncoder(cfg, vocab_size=10)
    rng = np.random.RandomState(2)
    feats = _feats(rng, 2, 16, 120, [16, 9])  # 3 blocks of 40
    p = enc.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                 jnp.asarray([16, 9], jnp.int32))
    conv1 = p["params"]["vgg"]["conv1_1"]["kernel"]
    assert conv1.shape == (3, 3, 3, 8)  # (kh, kw, in_ch=3, out_ch)

    cfg_bad = _vgg_cfg(vgg_in_channels=7)
    enc_bad = BiLSTMEncoder(cfg_bad, vocab_size=10)
    with pytest.raises(ValueError, match="divisible"):
        enc_bad.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                     jnp.asarray([16, 9], jnp.int32))


def test_vgg_gradients_flow():
    cfg = _vgg_cfg()
    enc = BiLSTMEncoder(cfg, vocab_size=10)
    rng = np.random.RandomState(3)
    feats = jnp.asarray(_feats(rng, 2, 20, 40, [20, 11]))
    lens = jnp.asarray([20, 11], jnp.int32)
    params = enc.init(jax.random.PRNGKey(0), feats, lens)["params"]

    def loss(p):
        _, _, lg = enc.apply({"params": p}, feats, lens)
        return jnp.sum(lg ** 2)

    g = jax.grad(loss)(params)
    for name in ("conv1_1", "conv1_2", "conv2_1", "conv2_2"):
        k = np.asarray(g["vgg"][name]["kernel"])
        assert np.isfinite(k).all() and np.abs(k).max() > 0, name


def test_unknown_enc_type_raises():
    cfg = ModelConfig(enc_type="transformer")
    enc = BiLSTMEncoder(cfg, vocab_size=10)
    with pytest.raises(ValueError, match="enc_type"):
        enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 40)),
                 jnp.asarray([8], jnp.int32))


@pytest.mark.slow
def test_vgg_train_step_end_to_end():
    """Full hybrid train step with the vggblstm encoder: loss finite and
    decreasing over a few steps on a tiny synthetic batch."""
    from gluon_e2e_asr.data.tokenizer import CharTokenizer
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.training.train_step import (
        create_train_state, make_optimizer, make_train_step,
    )

    config = Config(
        data=DataConfig(),
        frontend=FrontendConfig(),
        model=_vgg_cfg(dec_hidden=16, dec_embed=8, att_dim=8,
                       att_type="dot"),
        loss=LossConfig(mtl_alpha=0.3),
        train=TrainConfig(seed=0, learning_rate=1e-3, warmup_steps=1),
    )
    tok = CharTokenizer()
    model = build_model(config, tok.vocab_size, tok.sos_id, tok.eos_id)
    tx = make_optimizer(config)
    rng = np.random.RandomState(0)
    n = 16000
    batch = {
        "audio": rng.randn(2, n).astype(np.float32) * 0.1,
        "audio_len": np.array([n, n // 2], np.int32),
        "labels": np.tile(np.arange(4, 10, dtype=np.int32), (2, 2))[:, :8],
        "label_len": np.array([8, 5], np.int32),
    }
    state = create_train_state(config, model, tx, batch)
    step = make_train_step(model, config, tx)
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
