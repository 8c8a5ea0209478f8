"""A msgpack encoder and decoder for the checkpoint payload: exactly the
subset ``flax.serialization.msgpack_serialize`` writes for a train state,
so the port reads and writes the JAX package's checkpoints without the
``msgpack`` or ``flax`` packages.

The subset:

* maps with str keys (written in their insertion order, as
  ``flax.serialization.to_bytes`` writes a state dict), arrays
  (lists/tuples), str, bin (bytes), int, float (float64), nil, bool;
* ext type 1 for numpy arrays (flax's ``_ndarray_to_bytes``): the payload
  is itself msgpack of the tuple ``(shape, dtype.name, C-order bytes)``.
  0-d arrays (how ``step`` and optax's ``count`` are stored) included.
  Ext type 3 (a numpy scalar, same payload) is written for numpy scalars
  and read as a 0-d array.

Flax splits arrays above 2**30 bytes into ``__msgpack_chunked_array__``
maps; a train state never has one, and reading one raises.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED_KEY = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Bytes outside the supported subset, or malformed."""


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise MsgpackError(f"integer {n} does not fit 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise MsgpackError(f"integer {n} does not fit 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: bytearray) -> None:
    """Header of a str/bin/array/map of length ``n``: the fix form when
    ``fix`` is given and ``n < fix_max``, else the smallest sized form."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in codes:
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} too large")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARR = ((None, "", 0), (0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((None, "", 0), (0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
# Ext headers: fixext for lengths 1/2/4/8/16, else ext 8/16/32.
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _pack_len(n, None, 0, _EXT, out)
    out += struct.pack(">b", code)
    out += data


def ndarray_to_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of ``(shape, dtype name,
    C-order bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise MsgpackError("object and structured dtypes are not supported")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, ndarray_to_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, ndarray_to_bytes(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, _STR, out)
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, _BIN, out)
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, _ARR, out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise MsgpackError("map keys must be str")
        _pack_len(len(obj), 0x80, 16, _MAP, out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise MsgpackError(f"cannot encode {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode ``obj`` (numpy arrays as ext type 1)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def ndarray_from_bytes(data: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes`` (a writable copy)."""
    shape, dtype_name, buf = unpackb(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise MsgpackError("bfloat16 arrays are not supported")
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name))
    return arr.reshape(tuple(shape), order="C").copy()


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise MsgpackError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_SIZED = {  # code: (kind, length format)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("arr", ">H"), 0xDD: ("arr", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
}
_NUMBERS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


def _ext(code: int, data: bytes):
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        return ndarray_from_bytes(data)
    raise MsgpackError(f"unsupported msgpack ext type {code}")


def _read(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode("utf-8")
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in _NUMBERS:
        value = r.unpack(_NUMBERS[b])
        return float(value) if b in (0xCA, 0xCB) else int(value)
    if b in _FIXEXT_LEN:
        code = r.unpack(">b")
        return _ext(code, r.take(_FIXEXT_LEN[b]))
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return r.take(n)
        if kind == "str":
            return r.take(n).decode("utf-8")
        if kind == "arr":
            return [_read(r) for _ in range(n)]
        if kind == "map":
            return _read_map(r, n)
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")


def _read_map(r: _Reader, n: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for _ in range(n):
        key = _read(r)
        if not isinstance(key, str):
            raise MsgpackError(f"map key {key!r} is not a str")
        out[key] = _read(r)
    if _CHUNKED_KEY in out:
        raise MsgpackError(
            "chunked array (an array above flax's 2**30-byte chunk size) "
            "in the payload: not supported by this reader")
    return out


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object; trailing bytes raise."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} trailing bytes after "
                           f"the msgpack object")
    return obj
