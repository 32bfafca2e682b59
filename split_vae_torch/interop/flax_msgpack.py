"""A reader of the msgpack files that flax writes (``flax.serialization``),
without the ``msgpack`` package.

It reads the msgpack types a flax state dict is made of: maps, strings, ints,
floats, bools, nil, arrays and binary, and flax's ext types 1 (an ndarray)
and 3 (a numpy scalar), each a msgpack triple of shape, dtype name and C-order
bytes (``flax/serialization.py::_ndarray_from_bytes``, ids at
``_MsgpackExtType``). Flax splits a leaf above about 2 GiB into chunks; no
weights of this project reach that size, and such a file is refused.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_NDARRAY, _NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack data ends at byte {len(self.data)}, wanted "
                             f"{n} bytes at {self.pos}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sizes:
            return bytes(self.take(self.unpack(sizes[b])))
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sizes:
            return self.str(self.unpack(sizes[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        sizes = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sizes:
            return self.ext(self.unpack(sizes[b]))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack value")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("a flax leaf chunked for its size (over ~2 GiB) is not read here")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == _NDARRAY:
            return _ndarray(data)
        if code == _NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"msgpack ext type {code} is not one flax writes for arrays")


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = loads(data)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(tuple(shape)).copy()


def loads(data: bytes) -> Any:
    """The msgpack value in ``data``, with flax's arrays as numpy arrays."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes follow the msgpack value")
    return out


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read())
