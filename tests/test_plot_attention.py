"""Attention-map extraction (tools/plot_attention.py)
[SURVEY.md §2.1 #10: the reference family's attention plot reports]."""

import jax
import numpy as np
import pytest

from gluon_e2e_asr.config import (
    Config,
    DataConfig,
    FrontendConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.manifest import build_synthetic_manifest
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.models.asr import build_model
from gluon_e2e_asr.training.train_step import (
    create_train_state,
    make_optimizer,
)


@pytest.mark.parametrize(
    "att_type",
    ["dot", pytest.param("loc", marks=pytest.mark.slow)],
)
def test_attention_maps_shapes_and_normalization(att_type):
    import sys

    sys.path.insert(0, "tools")
    from plot_attention import attention_maps

    cfg = Config(
        data=DataConfig(dataset="synthetic", synth_num_train=4,
                        synth_max_tokens=5, batch_size=4,
                        bucket_bounds_sec=(1.5,)),
        frontend=FrontendConfig(specaug_freq_masks=0, specaug_time_masks=0),
        model=ModelConfig(enc_hidden=16, enc_layers=2, enc_subsample=(1, 2),
                          dec_hidden=16, dec_embed=8, att_dim=8,
                          att_type=att_type, loc_conv_channels=4,
                          loc_conv_width=11),
        loss=LossConfig(mtl_alpha=0.3),
        train=TrainConfig(seed=0),
    )
    tok = CharTokenizer()
    utts = build_synthetic_manifest(4, seed=0, max_tokens=5)
    specs = make_bucket_specs(cfg.data.bucket_bounds_sec, 16000, 4, 16)
    sampler = BucketSampler(utts, specs, 16000, seed=0, shuffle=False)
    loader = DataLoader(utts, sampler, tok)
    b = next(iter(loader.epoch(0)))
    batch = {"audio": b.audio, "audio_len": b.audio_len,
             "labels": b.labels, "label_len": b.label_len}
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    state = create_train_state(cfg, model, make_optimizer(cfg), batch)

    att, enc_len = attention_maps(model, state.params, cfg, batch)
    B, L = b.labels.shape
    assert att.shape == (B, L + 1, att.shape[-1])
    for row in range(len(b.utt_ids)):
        T = int(enc_len[row])
        # each step's weights are a distribution over the VALID frames
        np.testing.assert_allclose(att[row, :, :T].sum(-1), 1.0, rtol=1e-4)
        assert np.abs(att[row, :, T:]).max() == 0.0  # exact zeros on pad
