"""dynamic_batch=True: per-bucket batch sizes scale inversely with the
bucket bound, and the trainer + decode spec construction agree."""

import numpy as np

from gluon_e2e_asr.config import Config, DataConfig, LossConfig, ModelConfig, TrainConfig
from gluon_e2e_asr.data.manifest import build_synthetic_manifest
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
import pytest


def test_dynamic_batch_scaling():
    specs = make_bucket_specs([2.0, 4.0, 8.0], 16000, batch_size=8,
                              max_label_len=64, dynamic_batch=True)
    # largest bucket keeps batch_size; smaller buckets scale up
    assert specs[-1].batch_size == 8
    assert specs[0].batch_size == 8 * 4  # 8s / 2s
    assert specs[1].batch_size == 8 * 2


def test_dynamic_batch_dp_divisibility_guard(tmp_path):
    """Under DP every bucket's (dynamic) batch size must divide the
    device count; the trainer must refuse at init, not crash mid-epoch
    in shard_map [code-review round 2]."""
    from gluon_e2e_asr.training.trainer import Trainer

    cfg = Config(
        data=DataConfig(dataset="synthetic", synth_num_train=24,
                        synth_num_dev=4, synth_max_tokens=5, batch_size=8,
                        bucket_bounds_sec=(2.0, 3.0), dynamic_batch=True),
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,)),
        loss=LossConfig(mtl_alpha=1.0),
        train=TrainConfig(num_epochs=1, dp=True,
                          ckpt_dir=str(tmp_path / "ck"),
                          metrics_path=str(tmp_path / "m.jsonl")),
    )
    # 8 virtual devices (conftest); short bucket scales to 8*3/2 = 12.
    with pytest.raises(ValueError, match="divisible by the device count"):
        Trainer(cfg, workdir=str(tmp_path))


def test_nbest_slot_filter():
    """Unfilled n-best slots carry the beam's -1e30 sentinel — which IS
    np.isfinite — and must still be dropped [code-review round 2]."""
    from gluon_e2e_asr.decode import filled_nbest
    from gluon_e2e_asr.decoding.beam import NEG_INF

    row = [("hello", -1.2), ("hallo", -2.5), ("", NEG_INF), ("", NEG_INF)]
    assert filled_nbest(row) == [("hello", -1.2), ("hallo", -2.5)]
    assert filled_nbest([("", NEG_INF)]) == []


@pytest.mark.slow
def test_dynamic_batch_through_trainer(tmp_path):
    from gluon_e2e_asr.training.trainer import Trainer

    cfg = Config(
        data=DataConfig(dataset="synthetic", synth_num_train=24,
                        synth_num_dev=4, synth_max_tokens=5, batch_size=4,
                        bucket_bounds_sec=(1.5, 3.0), dynamic_batch=True),
        model=ModelConfig(enc_hidden=16, enc_layers=1, enc_subsample=(2,)),
        loss=LossConfig(mtl_alpha=1.0),
        train=TrainConfig(num_epochs=1, ckpt_dir=str(tmp_path / "ck"),
                          metrics_path=str(tmp_path / "m.jsonl")),
    )
    t = Trainer(cfg, workdir=str(tmp_path))
    final = t.train()
    assert "dev_wer" in final
    # bucket 0 (1.5s) must carry 2x the base batch size
    assert t.sampler.specs[0].batch_size == 8
    assert t.sampler.specs[1].batch_size == 4
