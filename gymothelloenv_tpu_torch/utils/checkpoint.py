"""Checkpoints in flax's msgpack format, read and written in pure Python —
the port of ``gymothelloenv_tpu/utils/checkpoint.py`` (``save_checkpoint``/
``load_checkpoint``, checkpoint.py:28-61).

A checkpoint is the state dict ``{step, params, opt_state, extra}`` that
``flax.serialization.msgpack_serialize`` writes: nested maps with string
keys, written in sorted key order (flax maps the tree through
``jax.tree_util`` first, which sorts dict keys), numpy arrays as msgpack
ext type 1 (a packed ``[shape, dtype name, C-order bytes]``) and numpy
scalars as ext type 3.  The reader and writer here cover the subset flax
emits: maps, arrays, str, bin, nil, bool, every int width, float32/64
(float64 written), ext types 1 and 3.  They refuse flax's chunked-array
form (``__msgpack_chunked_array__``, written only for an array above
2**30 bytes) and ext type 2 (a Python ``complex``), which no checkpoint of
this repo holds.  The card's machine has no ``msgpack`` package, so the
format is written out here; ``tests/test_torch_checkpoint.py`` holds it
byte for byte against flax.
"""

from __future__ import annotations

import os
import struct

import numpy as np

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

# (largest length, header byte, struct format of the length) per family.
_STR = ((0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"), (0xFFFFFFFF, 0xDB, ">I"))
_BIN = ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"), (0xFFFFFFFF, 0xC6, ">I"))
_ARRAY = ((0xFFFF, 0xDC, ">H"), (0xFFFFFFFF, 0xDD, ">I"))
_MAP = ((0xFFFF, 0xDE, ">H"), (0xFFFFFFFF, 0xDF, ">I"))
_EXT = ((0xFF, 0xC7, ">B"), (0xFFFF, 0xC8, ">H"), (0xFFFFFFFF, 0xC9, ">I"))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
# Integers in msgpack-python's order of preference: (low, high, header,
# struct format).
_INTS = ((0x80, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"),
         (0x100, 0xFFFF, 0xCD, ">H"), (-0x8000, -0x81, 0xD1, ">h"),
         (0x10000, 0xFFFFFFFF, 0xCE, ">I"),
         (-0x80000000, -0x8001, 0xD2, ">i"),
         (0x100000000, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
         (-0x8000000000000000, -0x80000001, 0xD3, ">q"))


# --- writer -----------------------------------------------------------------

def _header(out: bytearray, n: int, forms, what: str) -> None:
    for most, byte, fmt in forms:
        if n <= most:
            out.append(byte)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: {what} of length {n} is too long")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out.append(v & 0xFF)
        return
    for low, high, byte, fmt in _INTS:
        if low <= v <= high:
            out.append(byte)
            out += struct.pack(fmt, v)
            return
    raise OverflowError(f"msgpack: int {v} does not fit 64 bits")


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax ``_ndarray_to_bytes``: ``[shape, dtype name, C-order bytes]``
    packed on its own."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be "
                         "serialized")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    if len(data) in _FIXEXT:
        out.append(_FIXEXT[len(data)])
    else:
        _header(out, len(data), _EXT, "ext")
    out += struct.pack(">b", code)
    out += data


def _pack(obj, out: bytearray) -> None:
    kind = type(obj)
    if obj is None:
        out.append(0xC0)
    elif obj is False or obj is True:
        out.append(0xC3 if obj else 0xC2)
    elif kind is int:
        _pack_int(out, obj)
    elif kind is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif kind is str:
        data = obj.encode("utf-8")
        if len(data) < 32:
            out.append(0xA0 | len(data))
        else:
            _header(out, len(data), _STR, "str")
        out += data
    elif kind is bytes:
        _header(out, len(obj), _BIN, "bin")
        out += obj
    elif kind is dict:
        if len(obj) < 16:
            out.append(0x80 | len(obj))
        else:
            _header(out, len(obj), _MAP, "map")
        for key in sorted(obj):
            _pack(key, out)
            _pack(obj[key], out)
    elif kind is list:
        if len(obj) < 16:
            out.append(0x90 | len(obj))
        else:
            _header(out, len(obj), _ARRAY, "array")
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"msgpack: cannot serialize {kind.__name__}")


def packb(obj) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts (string
    keys, written sorted), lists, None, bool, int, float, str, bytes,
    numpy arrays and numpy scalars."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# --- reader -----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTH = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
           0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
           0xDC: (">H", "array"), 0xDD: (">I", "array"),
           0xDE: (">H", "map"), 0xDF: (">I", "map"),
           0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


def _ndarray_from(payload: bytes) -> np.ndarray:
    shape, name, buf = unpackb(payload)
    if isinstance(name, bytes):
        name = name.decode()
    try:
        dtype = np.dtype(name)
    except TypeError as err:
        raise ValueError(f"msgpack: array dtype {name!r} is not a numpy "
                         "dtype (bfloat16 needs JAX)") from err
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _ext(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from(payload)
    if code == EXT_NPSCALAR:
        return _ndarray_from(payload)[()]
    if code == EXT_COMPLEX:
        raise ValueError("msgpack: ext type 2 (a Python complex) is not "
                         "supported in a checkpoint")
    raise ValueError(f"msgpack: unknown ext type {code}")


def _read(r: _Reader):
    byte = r.take(1)[0]
    if byte < 0x80:
        return byte
    if byte >= 0xE0:
        return byte - 0x100
    if 0x80 <= byte <= 0x8F:
        return _read_map(r, byte & 0x0F)
    if 0x90 <= byte <= 0x9F:
        return [_read(r) for _ in range(byte & 0x0F)]
    if 0xA0 <= byte <= 0xBF:
        return str(r.take(byte & 0x1F), "utf-8")
    if byte == 0xC0:
        return None
    if byte in (0xC2, 0xC3):
        return byte == 0xC3
    if byte in _FIXED:
        return r.num(_FIXED[byte])
    if byte in _FIXEXT_LEN:
        code = r.num(">b")
        return _ext(code, bytes(r.take(_FIXEXT_LEN[byte])))
    if byte in _LENGTH:
        fmt, kind = _LENGTH[byte]
        n = r.num(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return str(r.take(n), "utf-8")
        if kind == "array":
            return [_read(r) for _ in range(n)]
        if kind == "map":
            return _read_map(r, n)
        code = r.num(">b")
        return _ext(code, bytes(r.take(n)))
    raise ValueError(f"msgpack: unknown type byte 0x{byte:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        if not isinstance(key, (str, bytes)):
            raise ValueError(f"msgpack: map key {key!r} is not a string")
        out[key] = _read(r)
    if CHUNKED in out:
        raise ValueError("msgpack: flax's chunked-array form "
                         f"({CHUNKED}, arrays above 2**30 bytes) is not "
                         "supported")
    return out


def unpackb(data: bytes):
    """``flax.serialization.msgpack_restore``: arrays come back as
    read-only ``np.frombuffer`` views, numpy scalars as numpy scalars."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the "
                         "object")
    return obj


# --- checkpoints --------------------------------------------------------------

def save_checkpoint(path: str, step: int, params, opt_state=None,
                    extra: dict | None = None) -> None:
    """Write ``{step, params, opt_state, extra}`` (trees of dicts and numpy
    arrays) to ``path`` through ``<path>.tmp`` and ``os.replace``."""
    payload = {"step": step, "params": params, "opt_state": opt_state,
               "extra": extra or {}}
    data = packb(payload)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Returns ``(step, params, opt_state, extra)``: nested dicts of numpy
    arrays as they were stored (flax's state-dict form; the caller maps
    them onto its modules)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    return (int(payload["step"]), payload["params"], payload["opt_state"],
            payload.get("extra", {}))
