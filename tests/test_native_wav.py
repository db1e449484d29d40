"""Native wav decode + fused batch-load parity vs the Python paths.

The native library (gluon_e2e_asr/native/asr_native.cpp) carries the real-corpus host
hot path [SURVEY.md §2.2; docs/ROADMAP.md #10]; these tests pin its
numerics to the Python ``wave``-module reference in
data/manifest.py::load_audio.
"""

import os
import struct
import wave as wave_mod

import numpy as np
import pytest

from gluon_e2e_asr.data.manifest import Utterance, load_audio
from gluon_e2e_asr.utils import native


def _write_pcm16(path, data: np.ndarray, rate=16000, channels=1):
    with wave_mod.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((data * 32767.0).astype(np.int16).tobytes())


def _write_float32(path, data: np.ndarray, rate=16000):
    """Minimal IEEE-float32 RIFF writer (the wave module can't)."""
    payload = data.astype(np.float32).tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, rate, rate * 4, 4, 32)
    chunks = b"WAVE"
    chunks += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(chunks)) + chunks)


@pytest.fixture(scope="module")
def lib_ok():
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    return True


def test_decode_pcm16_matches_python(tmp_path, lib_ok):
    rng = np.random.RandomState(0)
    data = np.clip(rng.randn(4321) * 0.2, -1, 1).astype(np.float32)
    p = str(tmp_path / "a.wav")
    _write_pcm16(p, data)
    ref = load_audio(Utterance("a", "", 0.0, audio_path=p))
    got = native.decode_wav(p)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-7)


def test_fuzz_wav_mutations_never_crash(tmp_path, lib_ok):
    # Seeded byte flips + truncations of a valid RIFF must either decode
    # or raise ValueError — never crash (parse_wav_header bounds checks
    # are the safety layer; see the FLAC twin in test_flac.py).
    rng = np.random.RandomState(11)
    data = np.clip(rng.randn(2000) * 0.2, -1, 1).astype(np.float32)
    p = str(tmp_path / "fz.wav")
    _write_pcm16(p, data)
    with open(p, "rb") as f:
        base = f.read()
    for k in range(200):
        buf = bytearray(base)
        pos = int(rng.randint(4, len(buf)))  # keep the RIFF magic
        buf[pos] ^= 1 << int(rng.randint(8))
        with open(p, "wb") as f:
            f.write(bytes(buf))
        try:
            out = native.decode_wav(p, max_samples=16000)
            assert out.dtype == np.float32 and out.ndim == 1
        except ValueError:
            pass
    for cut in range(4, len(base), 53):
        with open(p, "wb") as f:
            f.write(base[:cut])
        try:
            out = native.decode_wav(p, max_samples=16000)
            assert len(out) <= 2000
        except ValueError:
            pass


def test_decode_stereo_downmix(tmp_path, lib_ok):
    rng = np.random.RandomState(1)
    stereo = np.clip(rng.randn(1000, 2) * 0.2, -1, 1).astype(np.float32)
    p = str(tmp_path / "s.wav")
    _write_pcm16(p, stereo.reshape(-1), channels=2)
    ref = load_audio(Utterance("s", "", 0.0, audio_path=p))
    got = native.decode_wav(p)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-7)


def test_decode_float32_wav(tmp_path, lib_ok):
    rng = np.random.RandomState(2)
    data = np.clip(rng.randn(2048) * 0.3, -1, 1).astype(np.float32)
    p = str(tmp_path / "f.wav")
    _write_float32(p, data)
    got = native.decode_wav(p)
    np.testing.assert_array_equal(got, data)


def test_decode_rate_mismatch_raises(tmp_path, lib_ok):
    p = str(tmp_path / "r.wav")
    _write_pcm16(p, np.zeros(100, np.float32), rate=8000)
    with pytest.raises(ValueError):
        native.decode_wav(p, expect_rate=16000)


def test_probe_wav(tmp_path, lib_ok):
    p = str(tmp_path / "p.wav")
    _write_pcm16(p, np.zeros(12345, np.float32))
    lib = native.get_lib()
    import ctypes

    rate = ctypes.c_int32(0)
    frames = ctypes.c_int64(0)
    rc = lib.probe_wav(p.encode(), ctypes.byref(rate), ctypes.byref(frames))
    assert rc == 0 and rate.value == 16000 and frames.value == 12345


def test_load_pack_wav_batch_matches_python_pack(tmp_path, lib_ok):
    rng = np.random.RandomState(3)
    paths, refs = [], []
    for i, n in enumerate([1500, 3000, 800]):
        data = np.clip(rng.randn(n) * 0.2, -1, 1).astype(np.float32)
        p = str(tmp_path / f"b{i}.wav")
        _write_pcm16(p, data)
        paths.append(p)
        refs.append(load_audio(Utterance(f"b{i}", "", 0.0, audio_path=p)))
    max_samples, batch = 2000, 4
    audio, lens = native.load_pack_wav_batch(paths, 16000, max_samples, batch)
    assert audio.shape == (batch, max_samples) and lens.shape == (batch,)
    for i, ref in enumerate(refs):
        m = min(len(ref), max_samples)
        assert lens[i] == m  # truncation to the bucket bound
        np.testing.assert_allclose(audio[i, :m], ref[:m], atol=1e-7)
        assert not audio[i, m:].any()
    assert lens[3] == 0 and not audio[3].any()  # pad row


def test_load_pack_missing_file_raises(tmp_path, lib_ok):
    with pytest.raises(ValueError):
        native.load_pack_wav_batch(
            [str(tmp_path / "nope.wav")], 16000, 100, 1)


def test_dataloader_uses_native_wav_path(tmp_path, lib_ok):
    """End-to-end: a wav-backed manifest batched through DataLoader gives
    identical arrays with the native fused path and the Python path."""
    from gluon_e2e_asr.data.loader import DataLoader
    from gluon_e2e_asr.data.sampler import BucketSampler, BucketSpec
    from gluon_e2e_asr.data.tokenizer import CharTokenizer

    rng = np.random.RandomState(4)
    utts = []
    for i in range(6):
        n = int(rng.randint(1000, 4000))
        data = np.clip(rng.randn(n) * 0.2, -1, 1).astype(np.float32)
        p = str(tmp_path / f"u{i}.wav")
        _write_pcm16(p, data)
        utts.append(Utterance(f"u{i}", "ab c", n / 16000.0, audio_path=p))
    specs = [BucketSpec(max_samples=4000, max_labels=8, batch_size=3)]
    tok = CharTokenizer()
    sampler = BucketSampler(utts, specs, 16000, seed=0, drop_last=False)
    batches_native = [
        (b.audio.copy(), b.audio_len.copy(), b.labels.copy())
        for b in DataLoader(utts, sampler, tok, use_native=True).epoch(0)
    ]
    batches_python = [
        (b.audio.copy(), b.audio_len.copy(), b.labels.copy())
        for b in DataLoader(utts, sampler, tok, use_native=False).epoch(0)
    ]
    assert len(batches_native) == len(batches_python) > 0
    for (a1, l1, t1), (a2, l2, t2) in zip(batches_native, batches_python):
        np.testing.assert_allclose(a1, a2, atol=1e-7)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(t1, t2)
