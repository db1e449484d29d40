"""ctypes bindings for the native host-path library (lazy g++ build).

The shared library is built on first use from the packaged
``gluon_e2e_asr/native/asr_native.cpp`` (g++ is in the image;
pybind11/Rust are not — SURVEY.md environment notes). Every entry point
has a pure-Python fallback in its caller, so an unavailable toolchain
degrades gracefully. The .so lands next to the source when that
directory is writable (dev checkout), else in a per-user cache dir
(read-only site-packages install).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_ROOT, "native")
_SRC_PATH = os.path.join(_NATIVE_DIR, "asr_native.cpp")


def _host_tag() -> str:
    """Host/ISA identifier folded into the cache key: the build uses
    -march=native, so a shared (e.g. NFS) cache dir across heterogeneous
    hosts must never serve another machine's binary (SIGILL)."""
    import hashlib
    import platform

    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    parts.append(line.split(":", 1)[1].strip())
                    break
    except OSError:
        pass
    return hashlib.sha256(" ".join(parts).encode()).hexdigest()[:8]


def _lib_path() -> str:
    """Cache path keyed by a source digest + host/ISA tag: different
    checkouts (or machines) sharing the user cache never serve each
    other's binaries, and the staleness check is content-based rather
    than mtime-based."""
    try:
        import hashlib

        with open(_SRC_PATH, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        tag = "nosrc"
    name = f"libasr_native.{tag}.{_host_tag()}.so"
    if os.access(_NATIVE_DIR, os.W_OK):
        return os.path.join(_NATIVE_DIR, name)
    cache = os.path.join(
        os.path.expanduser("~"), ".cache", "gluon_e2e_asr")
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, name)


def _prune_stale(lib_path: str) -> None:
    """Remove superseded hash-named binaries beside a freshly built one.

    In the repo-local ``native/`` dir one checkout owns the directory, so
    every other hash is superseded and removed. The per-user cache dir is
    shared across checkouts (and, on NFS homes, across hosts), where
    sibling hashes may be another checkout's *live* binary — unconditional
    pruning there would make two checkouts evict each other into a g++
    rebuild on every alternation. There, only binaries untouched for 30+
    days are removed (bounding accumulation without churn)."""
    import time

    d = os.path.dirname(lib_path)
    keep = os.path.basename(lib_path)
    shared_cache = os.path.abspath(d) != os.path.abspath(_NATIVE_DIR)
    try:
        for f in os.listdir(d):
            if (f.startswith("libasr_native.") and f.endswith(".so")
                    and f != keep):
                p = os.path.join(d, f)
                try:
                    if shared_cache and (
                            time.time() - os.path.getmtime(p)
                            < 30 * 86400):
                        continue
                    os.unlink(p)
                except OSError:
                    pass
    except OSError:
        pass


_LIB_PATH = _lib_path()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    # Compile to a per-pid temp path then atomically rename: concurrent
    # processes racing on the same (content-keyed) cache path each
    # produce an identical binary and the rename is safe either way.
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread", "-o", tmp, _SRC_PATH],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        _prune_stale(_LIB_PATH)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_LIB_PATH):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.pack_waves.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.edit_distance_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.edit_distance_i32.restype = ctypes.c_int32
        lib.edit_distance_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32)
        ] * 4 + [ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        lib.decode_wav_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
        ]
        lib.decode_wav_f32.restype = ctypes.c_int32
        lib.probe_wav.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.probe_wav.restype = ctypes.c_int32
        lib.decode_flac_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
        ]
        lib.decode_flac_f32.restype = ctypes.c_int32
        lib.probe_flac.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.probe_flac.restype = ctypes.c_int32
        batch_sig = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.load_pack_audio_batch.argtypes = batch_sig
        lib.load_pack_audio_batch.restype = ctypes.c_int32
        lib.load_pack_wav_batch.argtypes = batch_sig
        lib.load_pack_wav_batch.restype = ctypes.c_int32
        batch_sig_i16 = list(batch_sig)
        batch_sig_i16[5] = ctypes.POINTER(ctypes.c_int16)
        lib.load_pack_audio_batch_i16.argtypes = batch_sig_i16
        lib.load_pack_audio_batch_i16.restype = ctypes.c_int32
        lib.encode_flac_i16.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.encode_flac_i16.restype = ctypes.c_int32
        _lib = lib
        return _lib


def pack_waves(
    waves: Sequence[np.ndarray], max_samples: int, batch_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Native padded packing of float32 waveforms into [batch, max_samples]."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(waves)
    waves32 = [np.ascontiguousarray(w, dtype=np.float32) for w in waves]
    ptrs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for w in waves32]
    )
    lens = np.array([len(w) for w in waves32], dtype=np.int32)
    out_audio = np.empty((batch_size, max_samples), np.float32)
    out_lens = np.empty((batch_size,), np.int32)
    lib.pack_waves(
        ptrs,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        max_samples,
        batch_size,
        out_audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out_audio, out_lens


def decode_wav(path: str, expect_rate: int = 16000,
               max_samples: int = 16000 * 60 * 10) -> np.ndarray:
    """Decode a PCM16 / IEEE-float32 wav to mono float32 (native reader).

    Raises on open/format/rate errors so callers can fall back to the
    Python ``wave`` path.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rate = ctypes.c_int32(0)
    frames = ctypes.c_int64(0)
    rc = lib.probe_wav(path.encode(), ctypes.byref(rate),
                       ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"probe_wav({path!r}) failed: rc={rc}")
    n = int(min(frames.value, max_samples))
    out = np.empty((n,), np.float32)
    got = lib.decode_wav_f32(
        path.encode(), expect_rate,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
    )
    if got < 0:
        raise ValueError(f"decode_wav_f32({path!r}) failed: rc={got}")
    return out[:got]


def decode_flac(path: str, expect_rate: int = 16000,
                max_samples: int = 16000 * 60 * 10) -> np.ndarray:
    """Decode a FLAC file to mono float32 via the native subset decoder.

    Raises on open/format/rate errors (no Python-side FLAC fallback
    exists — the native lib is the only decoder in this image).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rate = ctypes.c_int32(0)
    frames = ctypes.c_int64(0)
    rc = lib.probe_flac(path.encode(), ctypes.byref(rate),
                        ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"probe_flac({path!r}) failed: rc={rc}")
    n = int(min(frames.value, max_samples)) if frames.value > 0 else max_samples
    out = np.empty((n,), np.float32)
    got = lib.decode_flac_f32(
        path.encode(), expect_rate,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
    )
    if got < 0:
        raise ValueError(f"decode_flac_f32({path!r}) failed: rc={got}")
    return out[:got]


def encode_flac(path: str, pcm: np.ndarray, sample_rate: int = 16000) -> None:
    """Encode mono int16 PCM to a subset FLAC file via the native encoder.

    The corpus-writer hot path (native/asr_native.cpp::encode_flac_i16):
    ~100x realtime vs the pure-Python coverage encoder's ~0.1x on this
    1-core host, which is what makes rendering a LibriSpeech-scale
    synthetic corpus feasible [VERDICT.md round-2 item 3].
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pcm16 = np.ascontiguousarray(pcm, dtype=np.int16)
    rc = lib.encode_flac_i16(
        path.encode(),
        pcm16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        pcm16.shape[0], sample_rate,
    )
    if rc != 0:
        raise ValueError(f"encode_flac_i16({path!r}) failed: rc={rc}")


def probe_flac(path: str) -> Tuple[int, int]:
    """Return (sample_rate, total_frames) from a FLAC STREAMINFO block."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rate = ctypes.c_int32(0)
    frames = ctypes.c_int64(0)
    rc = lib.probe_flac(path.encode(), ctypes.byref(rate),
                        ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"probe_flac({path!r}) failed: rc={rc}")
    return int(rate.value), int(frames.value)


def load_pack_audio_batch(
    paths: Sequence[str], expect_rate: int, max_samples: int,
    batch_size: int, nthreads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fused native read+decode+pack of wav/flac files into a bucket batch.

    Returns (audio [batch, max_samples] float32, lens [batch] int32).
    Raises on any per-file decode error (caller falls back to Python).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out_audio = np.empty((batch_size, max_samples), np.float32)
    out_lens = np.empty((batch_size,), np.int32)
    rc = lib.load_pack_audio_batch(
        arr, n, expect_rate, max_samples, batch_size,
        out_audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nthreads,
    )
    if rc != 0:
        raise ValueError(f"load_pack_audio_batch failed: rc={rc}")
    return out_audio, out_lens


# Backward-compatible alias (pre-FLAC name).
load_pack_wav_batch = load_pack_audio_batch


def load_pack_audio_batch_i16(
    paths: Sequence[str], expect_rate: int, max_samples: int,
    batch_size: int, nthreads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """PCM16 device-transfer variant of :func:`load_pack_audio_batch`
    [data.transfer_dtype=int16]: rows land as int16 (exact inverse of the
    decoder's /32768 for 16-bit sources), halving host->device bytes.

    Returns (audio [batch, max_samples] int16, lens [batch] int32).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out_audio = np.empty((batch_size, max_samples), np.int16)
    out_lens = np.empty((batch_size,), np.int32)
    rc = lib.load_pack_audio_batch_i16(
        arr, n, expect_rate, max_samples, batch_size,
        out_audio.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nthreads,
    )
    if rc != 0:
        raise ValueError(f"load_pack_audio_batch_i16 failed: rc={rc}")
    return out_audio, out_lens


def edit_distance_native(ref: List[str], hyp: List[str]) -> int:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    table: dict = {}
    def ids(seq):
        arr = np.empty(len(seq), np.int32)
        for i, t in enumerate(seq):
            arr[i] = table.setdefault(t, len(table))
        return arr
    r, h = ids(ref), ids(hyp)
    return int(
        lib.edit_distance_i32(
            r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(r),
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(h),
        )
    )
