"""create_template_state mirrors create_train_state exactly (structure,
shapes, dtypes) without compiling — checkpoint restore via the template
must be lossless."""

import jax
import numpy as np

from gluon_e2e_asr.config import Config, LossConfig, ModelConfig, TrainConfig
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.training.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from gluon_e2e_asr.training.train_step import (
    create_template_state,
    create_train_state,
    make_optimizer,
)


def test_template_matches_real_state(tmp_path):
    cfg = Config(
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=16, dec_embed=8, att_dim=8,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.5),
        train=TrainConfig(seed=2),
    )
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size)
    tx = make_optimizer(cfg)
    rng = np.random.RandomState(0)
    batch = {
        "audio": rng.randn(2, 8000).astype(np.float32) * 0.1,
        "audio_len": np.array([8000, 6000], np.int32),
        "labels": rng.randint(4, 10, (2, 5)).astype(np.int32),
        "label_len": np.array([5, 3], np.int32),
    }
    real = create_train_state(cfg, model, tx, batch)
    tmpl = create_template_state(cfg, model, tx, batch)

    rt = jax.tree_util.tree_structure(real)
    tt = jax.tree_util.tree_structure(tmpl)
    assert rt == tt
    for a, b in zip(jax.tree_util.tree_leaves(real),
                    jax.tree_util.tree_leaves(tmpl)):
        assert tuple(np.shape(a)) == tuple(b.shape), (np.shape(a), b.shape)

    # save with the real state, restore into the template: bitwise params
    path = save_checkpoint(str(tmp_path), real, {"epoch": 0})
    restored, _, _ = restore_checkpoint(path, tmpl)
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(real)),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
