"""On-the-fly speed perturbation (data.speed_perturb) — the reference
family's 0.9/1.0/1.1 LibriSpeech augmentation, drawn per (epoch,
utterance) on the host [SURVEY.md §2.1 #7 augmentation family;
config.py DataConfig.speed_perturb]."""

import numpy as np
import pytest

from gluon_e2e_asr.config import config_from_dict
from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.manifest import build_synthetic_manifest
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import CharTokenizer

SR = 16000


def _make(utts, speed=(), seed=0, duration_scale=1.0, batch_size=8):
    specs = make_bucket_specs([2.0, 4.0], SR, batch_size=batch_size,
                              max_label_len=64)
    sampler = BucketSampler(utts, specs, SR, seed=seed, shuffle=False,
                            duration_scale=duration_scale)
    loader = DataLoader(utts, sampler, CharTokenizer(), SR,
                        speed_perturb=speed, perturb_seed=seed)
    return sampler, loader


def _dominant_freq(w, sr=SR):
    spec = np.abs(np.fft.rfft(w * np.hanning(len(w))))
    return np.argmax(spec) * sr / len(w)


def test_resample_scales_pitch_and_duration():
    """Factor f plays f× faster: duration × 1/f, frequency × f."""
    utts = build_synthetic_manifest(4, seed=0)
    _, loader = _make(utts)
    tone = np.sin(2 * np.pi * 440.0 * np.arange(SR) / SR).astype(np.float32)
    for f in (0.9, 1.1):
        audio = np.zeros((1, 2 * SR), np.float32)
        audio[0, :SR] = tone
        lens = np.array([SR], np.int32)
        loader.speed_perturb = (f,)
        loader._apply_speed_perturb(audio, lens, [0], epoch=0,
                                    max_samples=2 * SR)
        new_n = int(lens[0])
        assert new_n == int(round(SR / f))
        got = _dominant_freq(audio[0, :new_n])
        assert abs(got - 440.0 * f) < 5.0, (f, got)
        # nothing left behind past the new length
        assert not audio[0, new_n:].any()


def test_factor_one_is_identity():
    utts = build_synthetic_manifest(12, seed=1)
    _, plain = _make(utts, speed=())
    _, unity = _make(utts, speed=(1.0,))
    for (b0, i0), (b1, i1) in zip(plain.sampler.epoch_batches(0),
                                  unity.sampler.epoch_batches(0)):
        a = plain.make_batch(b0, i0, epoch=0)
        b = unity.make_batch(b1, i1, epoch=0)
        np.testing.assert_array_equal(a.audio, b.audio)
        np.testing.assert_array_equal(a.audio_len, b.audio_len)


def test_deterministic_per_epoch_and_varies_across_epochs():
    utts = build_synthetic_manifest(16, seed=2)
    _, l1 = _make(utts, speed=(0.9, 1.0, 1.1), seed=7, duration_scale=1 / 0.9)
    _, l2 = _make(utts, speed=(0.9, 1.0, 1.1), seed=7, duration_scale=1 / 0.9)
    batches1 = [l1.make_batch(b, i, epoch=3)
                for b, i in l1.sampler.epoch_batches(3)]
    batches2 = [l2.make_batch(b, i, epoch=3)
                for b, i in l2.sampler.epoch_batches(3)]
    for a, b in zip(batches1, batches2):
        np.testing.assert_array_equal(a.audio, b.audio)
        np.testing.assert_array_equal(a.audio_len, b.audio_len)
    # across epochs the draws must differ for at least one utterance
    lens3 = np.concatenate([b.audio_len for b in batches1])
    batches4 = [l1.make_batch(b, i, epoch=4)
                for b, i in l1.sampler.epoch_batches(4)]
    lens4 = np.concatenate([b.audio_len for b in batches4])
    assert not np.array_equal(np.sort(lens3), np.sort(lens4))


def test_stretched_audio_fits_bucket():
    """duration_scale placement: every 1/0.9-stretched row fits its
    bucket's static shape and no utterance is silently skipped."""
    utts = build_synthetic_manifest(32, seed=3)
    sampler, loader = _make(utts, speed=(0.9,), duration_scale=1 / 0.9)
    assert not sampler.skipped
    for b, idxs in sampler.epoch_batches(0):
        batch = loader.make_batch(b, idxs, epoch=0)
        spec = sampler.specs[b]
        assert batch.audio.shape == (spec.batch_size, spec.max_samples)
        assert int(batch.audio_len.max()) <= spec.max_samples
        # every real row actually got stretched (factor is always 0.9)
        for row, i in enumerate(idxs):
            n0 = len(loader._wave(i))
            assert int(batch.audio_len[row]) == min(
                int(round(n0 / 0.9)), spec.max_samples)


def test_labels_untouched_by_perturb():
    utts = build_synthetic_manifest(8, seed=4)
    _, plain = _make(utts, speed=())
    _, fast = _make(utts, speed=(1.1,))
    for (b0, i0), (b1, i1) in zip(plain.sampler.epoch_batches(0),
                                  fast.sampler.epoch_batches(0)):
        a = plain.make_batch(b0, i0, epoch=0)
        b = fast.make_batch(b1, i1, epoch=0)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.label_len, b.label_len)
        assert a.utt_ids == b.utt_ids


def test_no_epoch_means_no_perturb():
    """Eval-style make_batch calls (no epoch) never perturb."""
    utts = build_synthetic_manifest(8, seed=5)
    _, plain = _make(utts, speed=())
    _, pert = _make(utts, speed=(0.9,), duration_scale=1 / 0.9)
    # NOTE: duration_scale can shift bucket placement; compare per utt id.
    by_id = {}
    for b, i in plain.sampler.epoch_batches(0):
        batch = plain.make_batch(b, i)
        for row, n in enumerate(batch.audio_len):
            if n > 0:
                by_id[batch.utt_ids[row]] = int(n)
    for b, i in pert.sampler.epoch_batches(0):
        batch = pert.make_batch(b, i)  # epoch omitted
        for row, n in enumerate(batch.audio_len):
            if n > 0:
                assert by_id[batch.utt_ids[row]] == int(n)


def test_config_parses_speed_perturb():
    cfg = config_from_dict(
        {"data": {"speed_perturb": [0.9, 1.0, 1.1]}})
    assert cfg.data.speed_perturb == (0.9, 1.0, 1.1)
    with pytest.raises(ValueError):
        DataLoader([], None, CharTokenizer(), SR, speed_perturb=(0.0,))
