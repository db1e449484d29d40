"""LibriSpeech-layout manifest building + wav loading, exercised with a
generated miniature corpus (no real LibriSpeech on this machine —
SURVEY.md §0)."""

import os
import wave

import numpy as np

from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.manifest import (
    build_librispeech_manifest,
    load_audio,
)
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import CharTokenizer


def _write_wav(path, samples, sr=16000):
    data = (np.clip(samples, -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def _make_corpus(root):
    split = os.path.join(root, "dev-mini", "84", "121123")
    os.makedirs(split)
    rng = np.random.RandomState(0)
    entries = [
        ("84-121123-0000", "hello world"),
        ("84-121123-0001", "testing audio"),
    ]
    with open(os.path.join(split, "84-121123.trans.txt"), "w") as f:
        for utt_id, text in entries:
            f.write(f"{utt_id} {text.upper()}\n")
            n = rng.randint(8000, 16000)
            _write_wav(os.path.join(split, utt_id + ".wav"),
                       rng.randn(n).astype(np.float32) * 0.1)
    return entries


def test_manifest_and_wav_loading(tmp_path):
    root = str(tmp_path)
    entries = _make_corpus(root)
    utts = build_librispeech_manifest(root, "dev-mini")
    assert [u.utt_id for u in utts] == [e[0] for e in entries]
    assert utts[0].text == "hello world"  # lowercased
    assert utts[0].duration > 0.4
    wav = load_audio(utts[0])
    assert wav.dtype == np.float32
    assert len(wav) == int(round(utts[0].duration * 16000))


def test_librispeech_through_loader(tmp_path):
    root = str(tmp_path)
    _make_corpus(root)
    utts = build_librispeech_manifest(root, "dev-mini")
    specs = make_bucket_specs([1.5], 16000, 4, 32)
    sampler = BucketSampler(utts, specs, 16000, seed=0, shuffle=False)
    loader = DataLoader(utts, sampler, CharTokenizer())
    batches = list(loader.epoch(0))
    assert len(batches) == 1
    b = batches[0]
    assert b.num_real == 2
    assert (b.audio_len[:2] > 0).all()
