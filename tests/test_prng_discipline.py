"""PRNG-key discipline [SURVEY.md §5 'race detection' analogue]: the
train step splits the carried root key exactly once per step, so no key
is ever reused and runs are reproducible from the seed."""

import jax
import jax.numpy as jnp
import numpy as np

from gluon_e2e_asr.config import Config, LossConfig, ModelConfig, TrainConfig
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.models.asr import build_model
import pytest

from gluon_e2e_asr.training.train_step import (
    create_train_state,
    make_optimizer,
    make_train_step,
)


def _setup():
    cfg = Config(
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,)),
        loss=LossConfig(mtl_alpha=1.0),
        train=TrainConfig(seed=11),
    )
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size)
    rng = np.random.RandomState(0)
    batch = {
        "audio": rng.randn(2, 8000).astype(np.float32) * 0.1,
        "audio_len": np.array([8000, 8000], np.int32),
        "labels": rng.randint(4, 10, (2, 4)).astype(np.int32),
        "label_len": np.array([4, 4], np.int32),
    }
    tx = make_optimizer(cfg)
    state = create_train_state(cfg, model, tx, batch)
    step = make_train_step(model, cfg, tx)
    return state, step, batch


@pytest.mark.slow
def test_rng_advances_every_step():
    state, step, batch = _setup()
    dev = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = [np.asarray(jax.random.key_data(state.rng)).copy()]
    for _ in range(3):
        state, _ = step(state, dev)
        keys.append(np.asarray(jax.random.key_data(state.rng)).copy())
    for i in range(len(keys)):
        for j in range(i + 1, len(keys)):
            assert not np.array_equal(keys[i], keys[j]), (i, j)


@pytest.mark.slow
def test_same_seed_same_losses():
    losses = []
    for _ in range(2):
        state, step, batch = _setup()
        dev = {k: jnp.asarray(v) for k, v in batch.items()}
        run = []
        for _ in range(3):
            state, m = step(state, dev)
            run.append(float(m["loss"]))
        losses.append(run)
    assert losses[0] == losses[1]
