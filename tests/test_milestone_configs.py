"""Milestone config files stay loadable and structurally sound
[BASELINE.json:L6-L12], and the trainer's beam-eval path (milestone 3's
pure-attention config) runs end to end on CPU."""

import glob
import os

import pytest

from gluon_e2e_asr.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "milestone*.yaml")))


def test_five_milestone_configs_exist():
    # Milestone 2 (the fused frontend kernel) was retired with the kernel;
    # its config went with it.
    names = [os.path.basename(p) for p in CONFIGS]
    assert names == ["milestone1_bilstm_ctc.yaml", "milestone3_las.yaml",
                     "milestone4_hybrid_dp.yaml", "milestone5_beam.yaml"]


@pytest.mark.parametrize("path", CONFIGS)
def test_config_loads(path):
    cfg = load_config(path)
    assert cfg.name.startswith("milestone")
    assert cfg.data.batch_size > 0
    # milestone-specific invariants
    if "milestone1" in path:
        assert cfg.loss.mtl_alpha == 1.0
        assert cfg.decode.method == "greedy"
    if "milestone3" in path:
        assert cfg.loss.mtl_alpha == 0.0
        assert cfg.loss.scheduled_sampling > 0
    if "milestone4" in path:
        assert cfg.train.dp
        assert 0 < cfg.loss.mtl_alpha < 1
    if "milestone5" in path:
        assert cfg.decode.method == "beam"
        assert cfg.decode.beam_size > 1
        assert cfg.decode.length_norm


@pytest.mark.slow
def test_trainer_beam_eval_path(tmp_path):
    """Pure-attention config evaluates dev WER via the att-only beam."""
    from gluon_e2e_asr.config import (
        Config, DataConfig, DecodeConfig, LossConfig, ModelConfig, TrainConfig,
    )
    from gluon_e2e_asr.training.trainer import Trainer

    cfg = Config(
        data=DataConfig(dataset="synthetic", synth_num_train=8,
                        synth_num_dev=4, synth_max_tokens=4, batch_size=8,
                        bucket_bounds_sec=(1.5,)),
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,),
                          dec_hidden=16, dec_embed=8, att_dim=8,
                          att_type="add"),
        loss=LossConfig(mtl_alpha=0.0, scheduled_sampling=0.1),
        train=TrainConfig(num_epochs=1, ckpt_dir=str(tmp_path / "ck"),
                          metrics_path=str(tmp_path / "m.jsonl")),
        decode=DecodeConfig(method="beam", beam_size=2, ctc_weight=0.0,
                            maxlen_ratio=0.4),
    )
    t = Trainer(cfg, workdir=str(tmp_path))
    assert t.greedy is None and t._beam is not None
    final = t.train()
    assert "dev_wer" in final


def test_template_state_with_global_cmvn():
    """create_template_state must trace global-CMVN frontends without
    real stats (placeholder shapes) — the decode CLI builds the restore
    template BEFORE reading the checkpoint's stats [rehearsal-found]."""
    import numpy as np

    from gluon_e2e_asr.config import Config, FrontendConfig
    from gluon_e2e_asr.data.tokenizer import CharTokenizer
    from gluon_e2e_asr.models.asr import build_model
    from gluon_e2e_asr.training.train_step import (
        create_template_state,
        make_optimizer,
    )

    cfg = Config(frontend=FrontendConfig(cmvn="global",
                                         cmvn_stats_path="unused.npz"))
    tok = CharTokenizer()
    model = build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    batch = {
        "audio": np.zeros((2, 16000), np.float32),
        "audio_len": np.array([16000] * 2, np.int32),
        "labels": np.zeros((2, 8), np.int32),
        "label_len": np.array([8] * 2, np.int32),
    }
    st = create_template_state(cfg, model, make_optimizer(cfg), batch)
    assert st.params is not None
