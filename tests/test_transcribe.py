"""Manifest-free transcription CLI (gluon_e2e_asr.transcribe) —
the recognize() convenience surface [SURVEY.md §3.2]."""

import json
import os
import wave

import numpy as np
import pytest

from gluon_e2e_asr.data.manifest import synth_waveform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")


def _write_wav(path, wave_f32, sr=16000):
    pcm = np.clip(wave_f32 * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def test_transcribe_wav_files(tmp_path):
    from gluon_e2e_asr import transcribe

    paths = []
    for i, text in enumerate(("abc", "hello")):
        p = tmp_path / f"utt{i}.wav"
        _write_wav(p, synth_waveform(text, seed=i))
        paths.append(str(p))
    out = tmp_path / "hyps.jsonl"
    results = transcribe.main([
        "--config", os.path.join(GOLD, "tiny_golden.yaml"),
        "--ckpt", os.path.join(GOLD, "tiny_golden.msgpack"),
        "--output", str(out),
        *paths,
    ])
    # every input produced a (possibly empty) hypothesis string
    assert len(results) == 2
    assert all(isinstance(v, str) for v in results.values())
    ids = sorted(results)
    assert ids[0].endswith("utt0.wav") and ids[1].endswith("utt1.wav")
    recs = [json.loads(line) for line in open(out)]
    assert {r["utt_id"] for r in recs} == set(results)
    assert all("hyp" in r and "latency_s" in r for r in recs)


def test_transcribe_long_file_gets_catch_all_bucket(tmp_path):
    """A file longer than every configured bucket bound must still be
    transcribed (catch-all bucket), not silently dropped."""
    from gluon_e2e_asr import transcribe

    # tiny_golden.yaml buckets end at 4.0 s; render ~5 s of audio
    w = synth_waveform("abcdefghij" * 4, seed=3)
    assert len(w) > 4.0 * 16000
    p = tmp_path / "long.wav"
    _write_wav(p, w)
    results = transcribe.main([
        "--config", os.path.join(GOLD, "tiny_golden.yaml"),
        "--ckpt", os.path.join(GOLD, "tiny_golden.msgpack"),
        str(p),
    ])
    assert len(results) == 1


def test_transcribe_timestamps(tmp_path):
    """--timestamps force-aligns each hypothesis and attaches monotone
    token spans to the JSONL records."""
    from gluon_e2e_asr import transcribe

    p = tmp_path / "utt.wav"
    _write_wav(p, synth_waveform("abc def", seed=5))
    out = tmp_path / "hyps.jsonl"
    transcribe.main([
        "--config", os.path.join(GOLD, "tiny_golden.yaml"),
        "--ckpt", os.path.join(GOLD, "tiny_golden.msgpack"),
        "--output", str(out), "--timestamps",
        str(p),
    ])
    (rec,) = [json.loads(line) for line in open(out)]
    assert len(rec["tokens"]) == len(rec["hyp"])
    last_end = 0.0
    for t in rec["tokens"]:
        if t["start_s"] is None:
            continue
        assert t["start_s"] >= last_end - 1e-9
        assert t["end_s"] > t["start_s"]
        last_end = t["end_s"]


def test_transcribe_missing_file_fails_loudly(tmp_path):
    from gluon_e2e_asr import transcribe

    with pytest.raises(FileNotFoundError):
        transcribe.main([
            "--config", os.path.join(GOLD, "tiny_golden.yaml"),
            "--ckpt", os.path.join(GOLD, "tiny_golden.msgpack"),
            str(tmp_path / "nope.wav"),
        ])
