"""Dataset manifests + synthetic audio fixture generation.

Reference-side realization: Kaldi-style ``data.json``/scp manifests
enumerating (audio path, transcript, duration) [SURVEY.md §2.1 #1,
INFERRED-med]. New-repo realization: JSONL manifests, one record per
utterance, plus a deterministic synthetic-audio generator used for
tests and local benchmarks (no LibriSpeech on this machine — verified
by full-disk search, SURVEY.md §0).

Synthetic audio design: each character is rendered as a short tone
segment at a character-specific fundamental (plus one harmonic) with an
amplitude envelope and low deterministic noise. This gives waveforms
whose frame-level spectral content genuinely encodes the transcript, so
overfit/integration tests exercise the real acoustic mapping
[SURVEY.md §4 "Integration: overfit"].
"""

from __future__ import annotations

import json
import os
import wave
from dataclasses import dataclass, asdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from gluon_e2e_asr.data.tokenizer import CharTokenizer, DEFAULT_ALPHABET


@dataclass
class Utterance:
    utt_id: str
    text: str
    duration: float  # seconds
    audio_path: str = ""  # empty for in-memory synthetic audio
    # For synthetic data, the waveform is regenerated on demand from the
    # seed rather than stored, keeping manifests tiny and deterministic.
    synth_seed: int = -1
    # Additive white-noise std for synthetic audio (the tone amplitude is
    # ~0.6, so 0.003 is ~46 dB SNR — near-clean). Raising it sets a real
    # acoustic error floor, which quality experiments need to escape the
    # ceiling effect (a near-0% base WER leaves LM fusion/rescoring
    # nothing to improve). Default preserves the original fixture
    # bit-for-bit. (Field on Utterance so load_audio can regenerate the
    # waveform from the manifest alone.)
    synth_noise: float = 0.003
    # Multiplicative per-character frequency jitter std. Adjacent
    # character fundamentals are ~6% apart mid-range, so jitter ~0.03+
    # makes neighboring characters acoustically CONFUSABLE — the
    # substitution-error model real ASR has and the one a language model
    # can actually fix (white noise alone is integrated away by the
    # mel+LSTM processing gain: measured dev WER stayed ~2% even at
    # noise=0.30). Default preserves the original fixture bit-for-bit.
    synth_jitter: float = 0.01


# ---------------------------------------------------------------------------
# Synthetic waveform generation
# ---------------------------------------------------------------------------

_SEG_SEC = 0.12  # per-character tone duration
_GAP_SEC = 0.02  # inter-character gap


def _char_freq(ch: str, alphabet: str) -> float:
    """Character-specific fundamental, spread over 200..3200 Hz."""
    idx = alphabet.index(ch) if ch in alphabet else 0
    n = max(len(alphabet), 1)
    return 200.0 + 3000.0 * (idx + 1) / (n + 1)


def synth_waveform(
    text: str,
    seed: int,
    sample_rate: int = 16000,
    alphabet: str = DEFAULT_ALPHABET,
    noise: float = 0.003,
    jitter: float = 0.01,
) -> np.ndarray:
    """Render ``text`` to a float32 waveform in [-1, 1]. Deterministic."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    seg_n = int(_SEG_SEC * sample_rate)
    gap_n = int(_GAP_SEC * sample_rate)
    pieces: List[np.ndarray] = [np.zeros(gap_n, np.float32)]
    for ch in text.lower():
        f0 = _char_freq(ch, alphabet)
        # deterministic per-occurrence frequency jitter (confusability knob)
        f = f0 * (1.0 + jitter * rng.randn())
        t = np.arange(seg_n, dtype=np.float32) / sample_rate
        env = np.hanning(seg_n).astype(np.float32)
        tone = 0.6 * np.sin(2 * np.pi * f * t) + 0.25 * np.sin(2 * np.pi * 2 * f * t)
        pieces.append((env * tone).astype(np.float32))
        pieces.append(np.zeros(gap_n, np.float32))
    wav = np.concatenate(pieces)
    wav = wav + noise * rng.randn(len(wav)).astype(np.float32)
    return np.clip(wav, -1.0, 1.0).astype(np.float32)


_ENGLISH_POOL: Optional[List[str]] = None
_ENGLISH_SPLIT: dict = {}


def english_pool() -> List[str]:
    """The checked-in English sentence pool (normalized real prose).

    Generated once by ``tools/extract_english_pool.py`` from the Python
    documentation corpus and committed, so synthetic transcripts can
    carry genuine English word structure [VERDICT.md round-2 item 1] —
    the property LM fusion / BPE / rescoring experiments exist to
    exploit — without a runtime dependency on the source text.
    """
    global _ENGLISH_POOL
    if _ENGLISH_POOL is None:
        path = os.path.join(os.path.dirname(__file__), "english_pool.txt")
        with open(path) as f:
            _ENGLISH_POOL = [
                ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")
            ]
    return _ENGLISH_POOL


def english_pool_split(split: str, dev_pct: int = 20) -> List[str]:
    """Deterministic sentence-disjoint partition of the English pool.

    ``split`` is ``"train"`` or ``"dev"``. Assignment is by md5 of the
    sentence text (stable across runs/machines), then closed under
    substring containment: 17 pool sentences are substrings of another
    pool sentence, and a containment pair straddling the split would let
    dev word windows appear verbatim in train text — the leakage
    [VERDICT.md round-3 weak #1] this partition exists to remove. Any
    containment-connected group with at least one dev-hashed member goes
    entirely to dev (the safe direction: it can only shrink train).
    """
    key = dev_pct
    if key not in _ENGLISH_SPLIT:
        import hashlib

        pool = english_pool()
        is_dev = {
            s: int(hashlib.md5(s.encode()).hexdigest(), 16) % 100 < dev_pct
            for s in pool
        }
        # Containment closure (iterate to fixpoint; the containment graph
        # is tiny — ~17 edges in the checked-in pool).
        changed = True
        while changed:
            changed = False
            for a in pool:
                if is_dev[a]:
                    continue
                for b in pool:
                    if is_dev[b] and (b in a or a in b):
                        is_dev[a] = True
                        changed = True
                        break
        _ENGLISH_SPLIT[key] = {
            "train": [s for s in pool if not is_dev[s]],
            "dev": [s for s in pool if is_dev[s]],
        }
    if split not in ("train", "dev"):
        raise ValueError(f"unknown pool split: {split!r}")
    return _ENGLISH_SPLIT[key][split]


def _sample_english_fragment(
    rng: np.random.RandomState,
    min_chars: int,
    max_chars: int,
    pool: Optional[List[str]] = None,
    forbid_text: Optional[str] = None,
) -> str:
    """Draw a contiguous word window from a pool sentence whose total
    character length (spaces included) lands in [min_chars, max_chars].
    Contiguity preserves the within-utterance n-gram structure a
    language model can learn.

    ``pool`` restricts the draw to a sentence subset (see
    ``english_pool_split``); ``forbid_text`` rejects any window that
    occurs verbatim inside the given text — used for dev draws so no dev
    window is a substring of the train-side sentences (measured-zero
    leakage, not just sentence disjointness)."""
    if pool is None:
        pool = english_pool()
    for _ in range(200):
        words = pool[rng.randint(len(pool))].split()
        start = int(rng.randint(len(words)))
        picked: List[str] = []
        length = -1  # first word adds len(w), later ones 1 + len(w)
        for w in words[start:]:
            if length + 1 + len(w) > max_chars:
                break
            picked.append(w)
            length += 1 + len(w)
        if length >= min_chars:
            frag = " ".join(picked)
            if forbid_text is None or frag not in forbid_text:
                return frag
    # Degenerate bounds (e.g. max_chars smaller than any word): fall back
    # to a truncated common word so the generator never fails.
    return "the"[:max(max_chars, 1)]


def build_synthetic_manifest(
    num_utts: int,
    seed: int,
    min_tokens: int = 3,
    max_tokens: int = 12,
    alphabet: str = DEFAULT_ALPHABET,
    sample_rate: int = 16000,
    prefix: str = "synth",
    text_mode: str = "random",
    noise: float = 0.003,
    jitter: float = 0.01,
    split: str = "all",
) -> List[Utterance]:
    """Deterministic synthetic utterance list (text + seed; audio on demand).

    ``text_mode``: "random" draws uniform character sequences (the
    original fixture — zero linguistic structure, by design the null
    case); "english" draws word windows from the checked-in English
    pool, giving transcripts real orthographic/word statistics. In both
    modes min_tokens/max_tokens bound the *character* length, which is
    what the audio duration and bucket placement depend on.

    ``split`` (english mode only): "all" draws from the whole pool (the
    round-3 behavior — train and dev share sentences, so dev windows can
    appear verbatim in train); "train"/"dev" draw from the
    ``english_pool_split`` sentence-disjoint partition, and dev draws
    additionally reject any window occurring as a substring of the
    train-side text, giving a measured-zero train→dev text leakage
    [VERDICT.md round-4 item 1].
    """
    if text_mode not in ("random", "english"):
        raise ValueError(f"unknown synth text_mode: {text_mode!r}")
    if split not in ("all", "train", "dev"):
        raise ValueError(f"unknown manifest split: {split!r}")
    rng = np.random.RandomState(seed)
    # Use only "letter" characters for text (skip leading space/quote chars).
    letters = [c for c in alphabet if c.isalpha()]
    pool: Optional[List[str]] = None
    forbid: Optional[str] = None
    if text_mode == "english" and split != "all":
        pool = english_pool_split(split)
        if split == "dev":
            forbid = "\n".join(english_pool_split("train"))
    utts = []
    for i in range(num_utts):
        if text_mode == "english":
            text = _sample_english_fragment(
                rng, min_tokens, max_tokens, pool=pool, forbid_text=forbid)
        else:
            n = int(rng.randint(min_tokens, max_tokens + 1))
            chars = [letters[rng.randint(len(letters))] for _ in range(n)]
            # occasionally insert a space to exercise the space token
            if n >= 6:
                chars[n // 2] = " "
            text = "".join(chars).strip()
        dur = _GAP_SEC + len(text) * (_SEG_SEC + _GAP_SEC)
        utts.append(
            Utterance(
                utt_id=f"{prefix}-{i:05d}",
                text=text,
                duration=round(dur, 4),
                synth_seed=seed * 100003 + i,
                synth_noise=noise,
                synth_jitter=jitter,
            )
        )
    return utts


# ---------------------------------------------------------------------------
# Manifest IO + audio loading
# ---------------------------------------------------------------------------


def save_manifest(utts: Sequence[Utterance], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for u in utts:
            f.write(json.dumps(asdict(u)) + "\n")


def load_manifest(path: str) -> List[Utterance]:
    utts = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                utts.append(Utterance(**json.loads(line)))
    return utts


def load_audio(utt: Utterance, sample_rate: int = 16000) -> np.ndarray:
    """Return float32 waveform for an utterance (synthetic or wav file)."""
    if utt.synth_seed >= 0:
        return synth_waveform(utt.text, utt.synth_seed, sample_rate,
                              noise=utt.synth_noise,
                              jitter=utt.synth_jitter)
    if utt.audio_path.endswith(".wav"):
        with wave.open(utt.audio_path, "rb") as w:
            assert w.getframerate() == sample_rate, (
                f"{utt.audio_path}: rate {w.getframerate()} != {sample_rate}"
            )
            raw = w.readframes(w.getnframes())
            data = np.frombuffer(raw, dtype=np.int16)
            if w.getnchannels() > 1:
                data = data.reshape(-1, w.getnchannels()).mean(axis=1)
            return (data.astype(np.float32) / 32768.0).copy()
    if utt.audio_path.endswith(".flac"):
        # LibriSpeech's shipping format; decoded by the native C++ subset
        # decoder (this image has no libFLAC/ffmpeg/soundfile).
        from gluon_e2e_asr.utils.native import decode_flac

        return decode_flac(utt.audio_path, sample_rate)
    if utt.audio_path.endswith(".npy"):
        return np.load(utt.audio_path).astype(np.float32)
    raise ValueError(f"unsupported audio format: {utt.audio_path!r}")


def build_librispeech_manifest(root: str, split: str) -> List[Utterance]:
    """Walk a LibriSpeech split directory (``root/split/spk/chap/*.trans.txt``)
    and build a manifest. Accepts the corpus as shipped (16 kHz ``.flac``,
    decoded natively) as well as pre-converted ``.wav``/``.npy``.
    [SURVEY.md §2.1 #1]"""
    utts: List[Utterance] = []
    split_dir = os.path.join(root, split)
    for dirpath, _, filenames in os.walk(split_dir):
        for fn in filenames:
            if not fn.endswith(".trans.txt"):
                continue
            with open(os.path.join(dirpath, fn)) as f:
                for line in f:
                    utt_id, _, text = line.strip().partition(" ")
                    for ext in (".flac", ".wav", ".npy"):
                        ap = os.path.join(dirpath, utt_id + ext)
                        if os.path.exists(ap):
                            dur = _probe_duration(ap)
                            utts.append(
                                Utterance(utt_id=utt_id, text=text.lower(),
                                          duration=dur, audio_path=ap)
                            )
                            break
    utts.sort(key=lambda u: u.utt_id)
    return utts


def _probe_duration(path: str, sample_rate: int = 16000) -> float:
    if path.endswith(".wav"):
        with wave.open(path, "rb") as w:
            return w.getnframes() / w.getframerate()
    if path.endswith(".flac"):
        from gluon_e2e_asr.utils.native import probe_flac

        rate, frames = probe_flac(path)
        return frames / rate if rate > 0 else 0.0
    if path.endswith(".npy"):
        return float(np.load(path, mmap_mode="r").shape[0]) / sample_rate
    return 0.0
