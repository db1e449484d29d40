"""Checkpoint codec: state dicts and the msgpack subset checkpoints use.

Checkpoints (``training/checkpoint.py``, ``models/lm.py``,
``tools/average_ckpts.py``) are msgpack documents in the layout
``flax.serialization`` wrote: containers become string-keyed maps,
arrays become ext type 1 holding ``packb((shape, dtype name, C bytes))``,
numpy scalars ext type 3, and arrays above 1 GiB are split into chunks.
This module reads and writes that layout byte for byte with numpy alone,
so existing ``.msgpack`` checkpoints keep loading and new ones stay
readable by older code.

State dicts follow the same conventions: dicts keep their keys, lists,
tuples and namedtuples (optax states) map positions or field names to
keys, and dataclasses (``TrainState``) map field names to keys. Maps are
written with sorted keys.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30
_CHUNK_MARK = "__msgpack_chunked_array__"


# ----------------------------------------------------------------------
# State dicts
# ----------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_dataclass_instance(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def to_state_dict(x) -> Any:
    """Containers -> nested string-keyed dicts; leaves pass through."""
    if _is_namedtuple(x):
        return {k: to_state_dict(getattr(x, k)) for k in x._fields}
    if type(x) is dict:
        keys = {str(k) for k in x}
        if len(keys) != len(x):
            raise ValueError(f"dict keys are not unique as strings: {list(x)}")
        return {str(k): to_state_dict(v) for k, v in x.items()}
    if type(x) in (list, tuple):
        return {str(i): to_state_dict(v) for i, v in enumerate(x)}
    if _is_dataclass_instance(x):
        return {f.name: to_state_dict(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


def from_state_dict(target, state, path: str = ""):
    """Rebuild ``target``'s structure with the leaves of ``state``.

    Only the structure of ``target`` is used; its leaves may be arrays or
    ``jax.ShapeDtypeStruct``. Keys ``state`` has beyond a dict target's
    are ignored; keys it lacks raise."""
    if _is_namedtuple(target):
        if set(state) == {"name", "fields", "values"}:
            state = {state["fields"][str(i)]: state["values"][str(i)]
                     for i in range(len(state["fields"]))}
        if set(state) != set(target._fields):
            raise ValueError(
                f"namedtuple fields {sorted(target._fields)} != state keys "
                f"{sorted(state)} at {path or '/'}")
        return type(target)(**{
            k: from_state_dict(getattr(target, k), v, f"{path}/{k}")
            for k, v in state.items()})
    if type(target) is dict:
        missing = {str(k) for k in target} - set(state)
        if missing:
            raise ValueError(
                f"state lacks keys {sorted(missing)} at {path or '/'}")
        return {k: from_state_dict(v, state[str(k)], f"{path}/{k}")
                for k, v in target.items()}
    if type(target) in (list, tuple):
        if len(state) != len(target):
            raise ValueError(
                f"sequence of {len(target)} != state of {len(state)} "
                f"at {path or '/'}")
        items = [from_state_dict(t, state[str(i)], f"{path}/{i}")
                 for i, t in enumerate(target)]
        return items if type(target) is list else tuple(items)
    if _is_dataclass_instance(target):
        names = [f.name for f in dataclasses.fields(target)]
        if set(state) != set(names):
            raise ValueError(
                f"{type(target).__name__} fields {names} != state keys "
                f"{sorted(state)} at {path or '/'}")
        return dataclasses.replace(target, **{
            n: from_state_dict(getattr(target, n), state[n], f"{path}/{n}")
            for n in names})
    return state


# ----------------------------------------------------------------------
# msgpack writer
# ----------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix_base, fix_max, codes) -> None:
    """Header for a length-prefixed object: fixed form up to ``fix_max``,
    then the 8/16/32-bit forms in ``codes`` (None = form not defined)."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"object of length {n} is too large for msgpack")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} too large for msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} too small for msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out = bytearray()
    # packb((shape, dtype name, bytes)) with tuples packed as arrays.
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, obj) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif t is str:
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif t in (bytes, bytearray):
        _pack_len(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif t is list:
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for x in obj:
            _pack(out, x)
    elif t is dict:
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray) or hasattr(obj, "__array__") and hasattr(
            obj, "dtype") and not isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(np.asarray(obj)))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif t is complex:
        inner = bytearray()
        _pack(inner, [obj.real, obj.imag])
        _pack_ext(out, _EXT_COMPLEX, bytes(inner))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _canonical(tree):
    """Maps with sorted keys; arrays above MAX_CHUNK_SIZE bytes in the
    chunked-map form, whose own keys keep their fixed order."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_canonical(v) for v in tree]
    if hasattr(tree, "__array__") and hasattr(tree, "dtype") and not (
            isinstance(tree, np.generic)):
        arr = np.asarray(tree)
        if arr.size * arr.dtype.itemsize <= MAX_CHUNK_SIZE:
            return arr
        step = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
        flat = arr.reshape(-1)
        return {
            _CHUNK_MARK: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + step] for j, i in
                       enumerate(range(0, flat.size, step))},
        }
    return tree


def msgpack_serialize(tree) -> bytes:
    """Nested dicts/lists of arrays and Python scalars -> msgpack bytes."""
    out = bytearray()
    _pack(out, _canonical(tree))
    return bytes(out)


# ----------------------------------------------------------------------
# msgpack reader
# ----------------------------------------------------------------------

def _dtype_from_name(name: str):
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes  # bfloat16 and friends; installed with jax

        return np.dtype(getattr(ml_dtypes, name))


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).read()
            return complex(re, im)
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lens:
            return self.str_(self.unpack(lens[b]))
        bins = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in bins:
            return bytes(self.take(self.unpack(bins[b])))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in exts:
            return self.ext(self.unpack(exts[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map_(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buf = _Reader(data, raw=True).read()
    return np.frombuffer(buf, dtype=_dtype_from_name(name.decode())).reshape(
        shape, order="C")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNK_MARK in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def msgpack_restore(data: bytes):
    """msgpack bytes -> nested dicts/lists with numpy array leaves."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack document")
    return _unchunk(tree)
