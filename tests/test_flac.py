"""Native FLAC decoder (asr_native.cpp) vs the pure-Python reference
encoder (tools/flacenc.py): exact roundtrips across every decoder code
path, plus the LibriSpeech-layout ingestion path on a .flac tree
[VERDICT.md round-1 item 2; SURVEY.md §2.1 #1]."""

import os
import sys
import wave

import numpy as np
import pytest

sys.path.insert(0, "tools")

from flacenc import encode_flac, write_flac  # noqa: E402

from gluon_e2e_asr.data.loader import DataLoader
from gluon_e2e_asr.data.manifest import (
    Utterance,
    build_librispeech_manifest,
    load_audio,
)
from gluon_e2e_asr.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr.data.tokenizer import CharTokenizer
from gluon_e2e_asr.utils.native import (
    decode_flac,
    get_lib,
    load_pack_audio_batch,
    probe_flac,
)

pytestmark = pytest.mark.skipif(
    get_lib() is None, reason="native toolchain unavailable"
)


def _sig(n=6000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    s = 3000 * np.sin(2 * np.pi * 440 * t / 16000) + 200 * rng.randn(n)
    return np.clip(s, -32768, 32767).astype(np.int64)


@pytest.mark.parametrize(
    "name,kw",
    [
        ("auto", {}),
        ("verbatim", {"force_subframe": "verbatim"}),
        ("fixed", {"force_subframe": "fixed"}),
        ("fixed-part", {"force_subframe": "fixed", "porder": 3}),
        ("lpc1", {"force_subframe": "lpc", "lpc_order": 1, "lpc_shift": 3}),
        ("lpc2", {"force_subframe": "lpc", "lpc_order": 2, "lpc_shift": 4}),
        ("lpc8", {"force_subframe": "lpc", "lpc_order": 8, "lpc_shift": 5}),
        ("escape", {"force_subframe": "fixed", "force_escape": True}),
        ("small-block", {"block_size": 192}),
    ],
)
def test_roundtrip_subframe_paths(tmp_path, name, kw):
    s = _sig()
    path = str(tmp_path / f"{name}.flac")
    write_flac(path, s, **kw)
    out = decode_flac(path)
    np.testing.assert_array_equal(out, (s / 32768.0).astype(np.float32))


def test_roundtrip_constant_and_wasted(tmp_path):
    const = np.full(1000, -77, np.int64)
    p1 = str(tmp_path / "const.flac")
    write_flac(p1, const)
    np.testing.assert_array_equal(
        decode_flac(p1), (const / 32768.0).astype(np.float32))

    s = (_sig() >> 3) << 3  # 3 zero LSBs -> wasted-bits path
    p2 = str(tmp_path / "wasted.flac")
    write_flac(p2, s, wasted=3)
    np.testing.assert_array_equal(
        decode_flac(p2), (s / 32768.0).astype(np.float32))


@pytest.mark.parametrize("mode", ["indep", "left_side", "right_side",
                                  "mid_side"])
def test_roundtrip_stereo_downmix(tmp_path, mode):
    s = _sig()
    st = np.stack([s, np.roll(s, 3) + 50], axis=1)
    path = str(tmp_path / f"{mode}.flac")
    write_flac(path, st, channel_mode=mode)
    out = decode_flac(path)
    ref = (st.mean(axis=1) / 32768.0).astype(np.float32)
    np.testing.assert_allclose(out, ref, atol=1e-7)


def test_roundtrip_32bit_side_channel(tmp_path):
    # At bps=32 the decorrelated side channel carries 33 bits; the
    # decoder must not truncate the verbatim/warmup reads to 32
    # (asr_native.cpp BitReader::sbits64). Extremes force bit 33.
    n = 256
    rng = np.random.RandomState(7)
    l = rng.randint(-2**31, 2**31, n).astype(np.int64)
    r = rng.randint(-2**31, 2**31, n).astype(np.int64)
    l[0], r[0] = 2**31 - 1, -(2**31)   # side = 2**32 - 1 (33 bits)
    l[1], r[1] = -(2**31), 2**31 - 1   # side = -(2**32 - 1)
    st = np.stack([l, r], axis=1)
    ref = (st.mean(axis=1) / 2**31).astype(np.float32)
    for mode in ("left_side", "right_side", "mid_side"):
        path = str(tmp_path / f"s32_{mode}.flac")
        write_flac(path, st, bps=32, channel_mode=mode,
                   force_subframe="verbatim")
        np.testing.assert_allclose(decode_flac(path), ref, atol=3e-7)


def test_probe_and_rate_mismatch(tmp_path):
    s = _sig(4321)
    path = str(tmp_path / "a.flac")
    write_flac(path, s, sample_rate=16000)
    rate, frames = probe_flac(path)
    assert (rate, frames) == (16000, 4321)
    with pytest.raises(ValueError):
        decode_flac(path, expect_rate=8000)  # rc=-3 rate mismatch


def test_probe_reads_header_only(tmp_path):
    # probe_flac must read only the 42-byte fLaC+STREAMINFO prefix —
    # building a LibriSpeech manifest probes every utterance for its
    # duration and must not slurp the whole corpus [ADVICE/code-review
    # round 2]. A file truncated to that prefix still probes correctly.
    s = _sig(9876)
    path = str(tmp_path / "full.flac")
    write_flac(path, s, sample_rate=16000)
    with open(path, "rb") as f:
        head = f.read(42)
    trunc = str(tmp_path / "head_only.flac")
    with open(trunc, "wb") as f:
        f.write(head)
    assert probe_flac(trunc) == (16000, 9876)


def test_malformed_input_rejected(tmp_path):
    path = str(tmp_path / "bad.flac")
    with open(path, "wb") as f:
        f.write(b"fLaC" + os.urandom(64))
    with pytest.raises(ValueError):
        decode_flac(path)


def test_fuzz_mutations_never_crash(tmp_path):
    # Robustness net for the C++ decoder: seeded single-byte flips and
    # truncations of a valid stream must either decode (CRCs are parsed,
    # not verified) or raise ValueError — never segfault the process.
    # The decoder's bounds checks, not the CRCs, are the safety layer.
    base = encode_flac(_sig(3000), block_size=512)
    rng = np.random.RandomState(42)
    path = str(tmp_path / "fuzz.flac")
    for k in range(200):
        buf = bytearray(base)
        pos = int(rng.randint(4, len(buf)))  # keep the fLaC magic
        buf[pos] ^= 1 << int(rng.randint(8))
        with open(path, "wb") as f:
            f.write(bytes(buf))
        try:
            out = decode_flac(path, max_samples=16000)
            assert out.dtype == np.float32 and out.ndim == 1
        except ValueError:
            pass
    for cut in range(4, len(base), 37):  # truncations
        with open(path, "wb") as f:
            f.write(base[:cut])
        try:
            out = decode_flac(path, max_samples=16000)
            assert len(out) <= 3000
        except ValueError:
            pass


def test_flac_wav_parity_via_load_audio(tmp_path):
    """The same PCM through .flac and .wav containers decodes identically."""
    s = _sig()
    fp = str(tmp_path / "u.flac")
    wp = str(tmp_path / "u.wav")
    write_flac(fp, s)
    with wave.open(wp, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(s.astype("<i2").tobytes())
    a = load_audio(Utterance("u", "x", 0.3, audio_path=fp))
    b = load_audio(Utterance("u", "x", 0.3, audio_path=wp))
    np.testing.assert_array_equal(a, b)


def test_fused_batch_loader_mixed_formats(tmp_path):
    """load_pack_audio_batch dispatches per-path on extension."""
    sigs = [_sig(3000, 1), _sig(5000, 2), _sig(2000, 3)]
    paths = []
    for i, s in enumerate(sigs):
        if i == 1:
            p = str(tmp_path / f"{i}.wav")
            with wave.open(p, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(s.astype("<i2").tobytes())
        else:
            p = str(tmp_path / f"{i}.flac")
            write_flac(p, s)
        paths.append(p)
    audio, lens = load_pack_audio_batch(paths, 16000, 6000, 4)
    assert list(lens) == [3000, 5000, 2000, 0]
    for i, s in enumerate(sigs):
        np.testing.assert_array_equal(
            audio[i, : len(s)], (s / 32768.0).astype(np.float32))
        assert not audio[i, len(s):].any()


def _make_flac_corpus(root):
    split = os.path.join(root, "dev-flac", "19", "198")
    os.makedirs(split)
    entries = [("19-198-0000", "first utterance"),
               ("19-198-0001", "second one")]
    with open(os.path.join(split, "19-198.trans.txt"), "w") as f:
        for i, (utt_id, text) in enumerate(entries):
            f.write(f"{utt_id} {text.upper()}\n")
            write_flac(os.path.join(split, utt_id + ".flac"),
                       _sig(8000 + 4000 * i, seed=i))
    return entries


def test_librispeech_flac_manifest_and_loader(tmp_path):
    """A LibriSpeech-shaped .flac tree feeds the full L0 path: walker ->
    manifest -> bucketed loader -> padded batch, via the native fused
    read+decode+pack."""
    root = str(tmp_path)
    entries = _make_flac_corpus(root)
    utts = build_librispeech_manifest(root, "dev-flac")
    assert [u.utt_id for u in utts] == [e[0] for e in entries]
    assert utts[0].text == "first utterance"
    assert abs(utts[0].duration - 0.5) < 1e-6  # 8000 frames @ 16 kHz
    assert utts[0].audio_path.endswith(".flac")

    specs = make_bucket_specs([1.0], 16000, 4, 32)
    sampler = BucketSampler(utts, specs, 16000, seed=0, shuffle=False)
    loader = DataLoader(utts, sampler, CharTokenizer())
    batches = list(loader.epoch(0))
    assert len(batches) == 1
    b = batches[0]
    assert b.num_real == 2
    # Parity with direct per-file decode (proves the C++ fused path ran
    # through the same decoder).
    for row, u in enumerate(utts):
        w = decode_flac(u.audio_path)
        assert b.audio_len[row] == len(w)
        np.testing.assert_array_equal(b.audio[row, : len(w)], w)
