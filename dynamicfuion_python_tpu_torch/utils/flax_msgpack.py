"""A decoder, in plain Python, for the msgpack files Flax writes
(``flax.serialization.msgpack_serialize``, e.g. DeformNet parameter
checkpoints), so the port reads them without msgpack or flax.

It decodes the msgpack subset Flax emits: maps, arrays, strings, bin,
integers, floats, nil and booleans, and three ext types: 1, an ndarray whose
payload is itself msgpack ``(shape, dtype name, C-order bytes)``; 2, a
complex number ``(real, imag)``; 3, a numpy scalar packed as an ndarray.
Arrays larger than Flax's chunk limit arrive as a map
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}`` and
are joined back. msgpack arrays (Python tuples and lists) come back as
lists; bfloat16 arrays as float32.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos : self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {  # type byte -> struct format of the value that follows
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}


def _decode(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode("utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if 0xC4 <= b <= 0xC6:  # bin 8 / 16 / 32
        return r.take(r.unpack(_LENGTH[1 << (b - 0xC4)]))
    if 0xD9 <= b <= 0xDB:  # str 8 / 16 / 32
        return r.take(r.unpack(_LENGTH[1 << (b - 0xD9)])).decode("utf-8")
    if b in (0xDC, 0xDD):  # array 16 / 32
        return [_decode(r) for _ in range(r.unpack(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):  # map 16 / 32
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"))
    if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
        code = r.unpack(">b")
        return _ext(code, r.take(1 << (b - 0xD4)))
    if 0xC7 <= b <= 0xC9:  # ext 8 / 16 / 32
        n = r.unpack(_LENGTH[1 << (b - 0xC7)])
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    raise ValueError(f"msgpack type byte 0x{b:02x} is not used by Flax")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r)
        out[key] = _decode(r)
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag)
    raise ValueError(f"msgpack ext type {code} is not one Flax writes")


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """One msgpack object (with Flax's ext types) from ``data``."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes follow the msgpack object")
    return out


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` returns: dicts,
    lists and Python scalars with numpy array leaves."""
    return _unchunk(unpackb(data))


def load(path: str | Path):
    return msgpack_restore(Path(path).read_bytes())
