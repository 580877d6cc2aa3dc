"""A pure-Python decoder for the subset of msgpack that flax writes.

flax.serialization.to_bytes stores a parameter tree as msgpack maps of
str keys whose leaves are ext type 1 (ndarray): a msgpack payload
(shape, dtype name, raw C-order bytes). This module reads that format so
that a release loads on a machine without msgpack or flax.

Handled: nil, bool, ints, float32/64, str, bin, array, map, ext type 1.
Anything else (other ext types, flax's chunked arrays) raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
_CHUNKED_KEY = "__msgpack_chunked_array__"
_DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
           "uint32", "uint64", "float16", "float32", "float64")

# type byte -> value, for the one-byte constants
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
# type byte -> struct format of the number that follows
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# type byte -> (struct format of the length that follows, reader)
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}
# fixext type byte -> payload length
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:                               # positive fixint
            return b
        if b >= 0xE0:                               # negative fixint
            return b - 0x100
        if b <= 0x8F:                               # fixmap
            return self.map(b & 0x0F)
        if b <= 0x9F:                               # fixarray
            return self.array(b & 0x0F)
        if b <= 0xBF:                               # fixstr
            return self.str(b & 0x1F)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _SIZED:
            fmt, reader = _SIZED[b]
            return getattr(self, reader)(self.unpack(fmt))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNKED_KEY in out:
            raise ValueError("chunked flax arrays are not supported")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code != EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, buf = unpackb(payload)
        if dtype_name not in _DTYPES:
            raise ValueError(f"unsupported ndarray dtype {dtype_name!r}")
        return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(
            tuple(shape))


def unpackb(data: bytes):
    """Decode one msgpack object that fills `data` exactly."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the "
                         f"msgpack object")
    return out
