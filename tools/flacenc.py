"""Minimal pure-Python FLAC encoder (fixture + synthetic-corpus writer).

The image ships no FLAC tooling (no libFLAC/ffmpeg/soundfile — verified),
yet LibriSpeech distributes `.flac`, so the native decoder in
``gluon_e2e_asr/native/asr_native.cpp`` needs spec-compliant streams
to be tested against, and synthetic on-disk corpora want the real
LibriSpeech container format [VERDICT.md round-1 item 2].

This encoder favours coverage over compression: every decoder code path
can be forced (subframe type, LPC order, rice partition order, escape
partitions, wasted bits, all four stereo modes) so tests can exercise
each branch deterministically. Output is standard FLAC: correct
STREAMINFO (incl. MD5), frame-header CRC-8, frame CRC-16 — any compliant
decoder plays these files.

Format reference: https://xiph.org/flac/format.html (public spec).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np


class BitWriter:
    """MSB-first bit accumulator over a bytearray."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self.buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_signed(self, value: int, nbits: int) -> None:
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then the terminating 1

    def align(self) -> None:
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def bytes(self) -> bytes:
        assert self._nbits == 0, "stream not byte-aligned"
        return bytes(self.buf)


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
    return c


def _utf8_code(n: int) -> bytes:
    """FLAC's extended-UTF-8 coding of the frame number."""
    if n < 0x80:
        return bytes([n])
    # An nbytes-long sequence carries (7 - nbytes) + 6*(nbytes - 1) bits.
    nbytes = 2
    while n >= (1 << ((7 - nbytes) + 6 * (nbytes - 1))):
        nbytes += 1
    lead = (0xFF << (8 - nbytes)) & 0xFF
    shift = 6 * (nbytes - 1)
    out = [lead | (n >> shift)]
    for _ in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def _zigzag(res: np.ndarray) -> np.ndarray:
    res = res.astype(np.int64)
    return np.where(res >= 0, res << 1, (-res << 1) - 1)


def _rice_cost(u: np.ndarray, param: int) -> int:
    return int(np.sum(u >> param)) + len(u) * (param + 1)


def _best_rice_param(u: np.ndarray, maxp: int) -> int:
    best_p, best_c = 0, None
    for p in range(maxp + 1):
        c = _rice_cost(u, p)
        if best_c is None or c < best_c:
            best_p, best_c = p, c
    return best_p


def _write_residual(
    bw: BitWriter,
    res: np.ndarray,
    block_size: int,
    order: int,
    porder: int,
    force_escape: bool,
) -> None:
    """Partitioned rice coding (method 0: 4-bit params, escape 0b1111)."""
    bw.write(0, 2)  # coding method 0
    bw.write(porder, 4)
    nparts = 1 << porder
    psize = block_size >> porder
    idx = 0
    for part in range(nparts):
        count = psize - (order if part == 0 else 0)
        seg = res[idx : idx + count]
        idx += count
        u = _zigzag(seg)
        if force_escape:
            raw = int(max(1, (int(np.abs(seg).max(initial=0)).bit_length() + 1)))
            bw.write(0xF, 4)
            bw.write(raw, 5)
            for v in seg:
                bw.write_signed(int(v), raw)
            continue
        param = _best_rice_param(u, 14)
        bw.write(param, 4)
        for uv in u:
            uv = int(uv)
            bw.write_unary(uv >> param)
            bw.write(uv, param) if param else None


def _fixed_residual(sig: np.ndarray, order: int) -> np.ndarray:
    res = sig.astype(np.int64)
    for _ in range(order):
        res = np.diff(res)
    return res


def _write_subframe(
    bw: BitWriter,
    sig: np.ndarray,
    bps: int,
    force: Optional[str],
    lpc_order: int,
    lpc_shift: int,
    porder: int,
    force_escape: bool,
    wasted: int,
) -> None:
    sig = sig.astype(np.int64)
    if wasted:
        assert np.all(sig % (1 << wasted) == 0), "wasted bits require zero LSBs"
        sig = sig >> wasted
        bps -= wasted
    block_size = len(sig)

    kind = force
    if kind is None:
        if np.all(sig == sig[0]):
            kind = "constant"
        else:
            kind = "fixed"

    bw.write(0, 1)  # pad bit
    if kind == "constant":
        bw.write(0, 6)
    elif kind == "verbatim":
        bw.write(1, 6)
    elif kind == "fixed":
        order = min(2, block_size - 1) if block_size > 1 else 0
        bw.write(8 + order, 6)
    elif kind == "lpc":
        order = lpc_order
        bw.write(32 + order - 1, 6)
    else:
        raise ValueError(kind)

    if wasted:
        bw.write(1, 1)
        bw.write_unary(wasted - 1)
    else:
        bw.write(0, 1)

    if kind == "constant":
        bw.write_signed(int(sig[0]), bps)
    elif kind == "verbatim":
        for v in sig:
            bw.write_signed(int(v), bps)
    elif kind == "fixed":
        order = min(2, block_size - 1) if block_size > 1 else 0
        for v in sig[:order]:
            bw.write_signed(int(v), bps)
        res = _fixed_residual(sig, order)
        _write_residual(bw, res, block_size, order, porder, force_escape)
    else:  # lpc
        order = lpc_order
        assert 1 <= order <= 32 and order < block_size
        # Deterministic quantized coefficients: a damped order-2-style
        # predictor extended with zeros — valid for any signal, and the
        # exact integer arithmetic matches the decoder's reconstruction.
        precision = 12
        coefs = np.zeros(order, np.int64)
        coefs[0] = (3 << lpc_shift) // 2  # ~1.5
        if order >= 2:
            coefs[1] = -(1 << lpc_shift) // 2  # ~-0.5
        for v in sig[:order]:
            bw.write_signed(int(v), bps)
        bw.write(precision - 1, 4)
        bw.write_signed(lpc_shift, 5)
        for c in coefs:
            bw.write_signed(int(c), precision)
        pred = np.zeros(block_size - order, np.int64)
        for i in range(order, block_size):
            acc = int(np.dot(coefs, sig[i - order : i][::-1]))
            pred[i - order] = acc >> lpc_shift
        res = sig[order:] - pred
        _write_residual(bw, res, block_size, order, porder, force_escape)


def encode_flac(
    samples: np.ndarray,
    sample_rate: int = 16000,
    bps: int = 16,
    block_size: int = 4096,
    channel_mode: str = "indep",
    force_subframe: Optional[str] = None,
    lpc_order: int = 2,
    lpc_shift: int = 4,
    porder: int = 0,
    force_escape: bool = False,
    wasted: int = 0,
) -> bytes:
    """Encode integer PCM ``samples`` ([N] mono or [N, C]) to a FLAC stream.

    ``channel_mode``: 'indep' | 'left_side' | 'right_side' | 'mid_side'
    (stereo modes require C == 2). ``force_subframe`` pins every subframe
    to 'constant' | 'verbatim' | 'fixed' | 'lpc' for decoder coverage.
    """
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, nch = samples.shape
    assert 1 <= nch <= 8
    samples = samples.astype(np.int64)
    lim = 1 << (bps - 1)
    assert samples.min(initial=0) >= -lim and samples.max(initial=0) < lim

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block)
    si = BitWriter()
    si.write(block_size, 16)  # min block size
    si.write(block_size, 16)  # max block size
    si.write(0, 24)  # min frame size unknown
    si.write(0, 24)  # max frame size unknown
    si.write(sample_rate, 20)
    si.write(nch - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    md5 = hashlib.md5()
    width = (bps + 7) // 8
    inter = samples.reshape(-1)  # row-major: frame-interleaved
    if width == 1:
        md5.update(inter.astype(np.int8).tobytes())
    elif width == 2:
        md5.update(inter.astype("<i2").tobytes())
    elif width == 3:
        b4 = inter.astype("<i4").tobytes()
        md5.update(b"".join(b4[i : i + 3] for i in range(0, len(b4), 4)))
    else:
        md5.update(inter.astype("<i4").tobytes())
    si_bytes = si.bytes() + md5.digest()
    out.append(0x80 | 0)  # last-block flag, type 0 = STREAMINFO
    out += len(si_bytes).to_bytes(3, "big")
    out += si_bytes

    if channel_mode != "indep":
        assert nch == 2, "stereo decorrelation requires 2 channels"

    frame_no = 0
    for start in range(0, n, block_size):
        blk = samples[start : start + block_size]
        bs = len(blk)
        hdr = BitWriter()
        hdr.write(0x3FFE, 14)  # sync
        hdr.write(0, 1)  # reserved
        hdr.write(0, 1)  # fixed-blocksize stream
        hdr.write(7, 4)  # block size: 16-bit value - 1 at header end
        hdr.write(0, 4)  # sample rate: from STREAMINFO
        if channel_mode == "indep":
            hdr.write(nch - 1, 4)
        elif channel_mode == "left_side":
            hdr.write(8, 4)
        elif channel_mode == "right_side":
            hdr.write(9, 4)
        else:
            hdr.write(10, 4)
        ss_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps]
        hdr.write(ss_code, 3)
        hdr.write(0, 1)  # reserved
        hdr_bytes = bytearray(hdr.bytes())
        hdr_bytes += _utf8_code(frame_no)
        hdr_bytes += (bs - 1).to_bytes(2, "big")
        hdr_bytes.append(crc8(bytes(hdr_bytes)))

        fw = BitWriter()
        fw.buf += hdr_bytes
        if channel_mode == "indep":
            chans: List[np.ndarray] = [blk[:, c] for c in range(nch)]
            extra = [0] * nch
        else:
            l, r = blk[:, 0], blk[:, 1]
            side = l - r
            if channel_mode == "left_side":
                chans, extra = [l, side], [0, 1]
            elif channel_mode == "right_side":
                chans, extra = [side, r], [1, 0]
            else:
                chans, extra = [(l + r) >> 1, side], [0, 1]
        for c, sig in enumerate(chans):
            _write_subframe(
                fw, sig, bps + extra[c], force_subframe, lpc_order,
                lpc_shift, porder, force_escape, wasted,
            )
        fw.align()
        frame = bytes(fw.buf)
        out += frame
        out += crc16(frame).to_bytes(2, "big")
        frame_no += 1

    return bytes(out)


def write_flac(path: str, samples: np.ndarray, **kw) -> None:
    with open(path, "wb") as f:
        f.write(encode_flac(samples, **kw))
