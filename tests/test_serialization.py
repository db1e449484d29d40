"""The checkpoint codec (utils/serialization.py) and the plain-JAX models
against what they replace: byte-identical msgpack with
``flax.serialization``, and the same parameter trees, initial weights and
outputs as the flax.linen modules in tests/flax_reference.py."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest

from gluon_e2e_asr.config import ModelConfig
from gluon_e2e_asr.models.asr import ASRModel
from gluon_e2e_asr.models.lm import LSTMLM
from gluon_e2e_asr.training.train_step import TrainState
from gluon_e2e_asr.utils import serialization as ser

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "tiny_golden.msgpack")

DTYPES = ["float16", "float32", "float64", "bfloat16", "int8", "int16",
          "int32", "int64", "uint8", "uint16", "uint32", "uint64", "bool",
          "complex64"]


def _dtype(name):
    return np.dtype(ml_dtypes.bfloat16) if name == "bfloat16" else (
        np.dtype(name))


@pytest.mark.parametrize("name", DTYPES)
def test_round_trip_dtype(name):
    dt = _dtype(name)
    rng = np.random.RandomState(0)
    arrays = {
        "scalar_array": np.asarray(rng.randn() * 10).astype(dt),
        "empty": np.zeros((0, 3), dt),
        "matrix": (rng.randn(3, 4) * 10).astype(dt),
        "np_scalar": (rng.randn(1) * 10).astype(dt)[0],
    }
    back = ser.msgpack_restore(ser.msgpack_serialize(arrays))
    assert sorted(back) == sorted(arrays)
    for k, v in arrays.items():
        got = back[k]
        assert np.asarray(got).dtype == dt, k
        assert np.asarray(got).shape == np.asarray(v).shape, k
        np.testing.assert_array_equal(np.asarray(got), np.asarray(v))
    assert isinstance(back["np_scalar"], np.generic)


def _payloads():
    p = {"dense": {"kernel": jnp.ones((3, 4)), "bias": jnp.zeros((4,))},
         "embed": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)}
    adam = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(1e-3))
    adadelta = optax.chain(optax.clip_by_global_norm(5.0),
                           optax.inject_hyperparams(optax.adadelta)(
                               learning_rate=1.0, rho=0.95, eps=1e-8))
    out = {}
    for name, tx in (("adam", adam), ("adadelta", adadelta)):
        state = TrainState(step=jnp.asarray(7, jnp.int32), params=p,
                           opt_state=tx.init(p), rng=jax.random.PRNGKey(3))
        out[name] = {"state": state,
                     "cmvn": [np.ones(4, np.float32), np.zeros(4)]}
    out["scalars"] = {"none": None, "t": True, "f": False, "ints": [
        0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128,
        -129, -32768, -32769, -2 ** 31 - 1], "float": 1.5, "str": "x" * 40,
        "utf8": "é", "np": np.float32(2.5), "complex": 3 + 4j,
        "many": {str(i): i for i in range(20)}, "empty": {}}
    return out


@pytest.mark.parametrize("kind", ["adam", "adadelta", "scalars"])
def test_bytes_identical_to_flax(kind):
    fs = pytest.importorskip("flax.serialization")
    payload = jax.device_get(_payloads()[kind])
    if kind != "scalars":
        # flax walks its own struct dataclass; the state dict is the same.
        payload = dict(payload, state=ser.to_state_dict(payload["state"]))
    ours = ser.msgpack_serialize(ser.to_state_dict(payload))
    theirs = fs.msgpack_serialize(fs.to_state_dict(payload))
    assert ours == theirs
    a, b = ser.msgpack_restore(theirs), fs.msgpack_restore(ours)
    ja, jb = jax.tree_util.tree_flatten_with_path(a), \
        jax.tree_util.tree_flatten_with_path(b)
    assert ja[1] == jb[1]
    for (pa, x), (_, y) in zip(ja[0], jb[0]):
        assert type(x) is type(y), pa
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kind", ["adam", "adadelta"])
def test_train_state_restores_through_template(kind):
    payload = jax.device_get(_payloads()[kind])
    state = payload["state"]
    blob = ser.msgpack_serialize(ser.to_state_dict(payload))
    template = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype),
        state)
    back = ser.from_state_dict(template, ser.msgpack_restore(blob)["state"])
    assert isinstance(back, TrainState)
    assert jax.tree_util.tree_structure(back) == (
        jax.tree_util.tree_structure(state))
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_from_state_dict_rejects_missing_keys():
    with pytest.raises(ValueError, match="lacks keys"):
        ser.from_state_dict({"a": 1, "b": 2}, {"a": 1})
    with pytest.raises(ValueError, match="fields"):
        ser.from_state_dict(optax.ScaleByAdamState(0, {}, {}),
                            {"count": 0, "mu": {}})


def test_golden_checkpoint_rewrites_byte_identical():
    with open(GOLDEN, "rb") as f:
        blob = f.read()
    assert ser.msgpack_serialize(ser.msgpack_restore(blob)) == blob


def test_chunked_arrays_match_flax(monkeypatch):
    fs = pytest.importorskip("flax.serialization")
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(50, dtype=np.float32).reshape(5, 10),
            "small": np.ones(3, np.float32)}
    ours = ser.msgpack_serialize(tree)
    assert ours == fs.msgpack_serialize(tree)
    back = ser.msgpack_restore(ours)
    np.testing.assert_array_equal(back["big"], tree["big"])


MODELS = {
    "blstm_loc": dict(att_type="loc", enc_hidden=16, enc_layers=2,
                      enc_subsample=(1, 2), dec_hidden=16, dec_embed=8,
                      att_dim=12, loc_conv_channels=3, loc_conv_width=5),
    "vgg_dot_2layer": dict(enc_type="vggblstm", vgg_channels=(4, 8),
                           att_type="dot", enc_hidden=16, enc_layers=2,
                           enc_subsample=(1, 1), dec_hidden=16, dec_embed=8,
                           att_dim=12, dec_layers=2),
    "add_bf16": dict(att_type="add", enc_hidden=16, enc_layers=3,
                     enc_subsample=(1, 2, 2), dec_hidden=16, dec_embed=8,
                     att_dim=12, compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_asr_model_matches_flax_era_module(name):
    """Same tree paths, shapes and (for a seed) initial weights as the
    flax.linen module, and the same outputs from the same weights."""
    pytest.importorskip("flax")
    import flax_reference as fr

    cfg = ModelConfig(**MODELS[name])
    rng = np.random.RandomState(0)
    feats = jnp.asarray(rng.randn(2, 21, 12).astype(np.float32))
    feat_len = jnp.array([21, 13], jnp.int32)
    toks = jnp.array([[2, 5, 6, 7], [2, 8, 9, 4]], jnp.int32)
    want = fr.ASRModel(cfg, 10).init(jax.random.PRNGKey(3), feats, feat_len,
                                     toks)["params"]
    model = ASRModel(cfg, 10)
    got = model.init(jax.random.PRNGKey(3), feats, feat_len, toks)["params"]
    fw, tw = jax.tree_util.tree_flatten_with_path(want)
    fg, tg = jax.tree_util.tree_flatten_with_path(got)
    assert tw == tg
    for (path, a), (_, b) in zip(fw, fg):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    out_w = fr.ASRModel(cfg, 10).apply({"params": want}, feats, feat_len,
                                       toks)
    out_g = model.apply({"params": want}, feats, feat_len, toks)
    assert sorted(out_w) == sorted(out_g)
    for k in out_w:
        # The flax-era reference runs location attention as a conv, the
        # model as the equivalent banded matmul: float rounding only.
        np.testing.assert_allclose(
            np.asarray(out_g[k], np.float32), np.asarray(out_w[k], np.float32),
            rtol=1e-5, atol=1e-6, err_msg=k)


def test_lm_matches_flax_era_module():
    pytest.importorskip("flax")
    import flax_reference as fr

    toks = jnp.array([[2, 5, 6], [2, 7, 0]], jnp.int32)
    lens = jnp.array([3, 2], jnp.int32)
    want = fr.LSTMLM(11, 8, 16, 2).init(jax.random.PRNGKey(1), toks,
                                        lens)["params"]
    got = LSTMLM(11, 8, 16, 2).init(jax.random.PRNGKey(1), toks,
                                    lens)["params"]
    assert jax.tree_util.tree_structure(want) == (
        jax.tree_util.tree_structure(got))
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(
        np.asarray(LSTMLM(11, 8, 16, 2).apply({"params": want}, toks, lens)),
        np.asarray(fr.LSTMLM(11, 8, 16, 2).apply({"params": want}, toks,
                                                 lens)),
        rtol=1e-6, atol=1e-6)
