"""A pure-Python decoder and encoder for the subset of msgpack that flax
writes.

flax.serialization.to_bytes stores a parameter tree as msgpack maps of
str keys whose leaves are ext type 1 (ndarray): a msgpack payload
(shape, dtype name, raw C-order bytes). This module reads that format so
that a release loads on a machine without msgpack or flax, and writes it
byte for byte as flax's msgpack_serialize does (`packb`), so that a model
the port trained goes back to the JAX package.

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


# arrays above this many bytes flax splits into chunks (MAX_CHUNK_SIZE)
_CHUNK_BYTES = 2 ** 30


def _head(out: bytearray, n: int, fix: int, fix_max: int, wide: tuple):
    """A header for a length n: the fix type (fix | n) up to fix_max, else
    the first of `wide`'s (type byte, struct format, limit) that holds n."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for byte, fmt, limit in wide:
        if n < limit:
            out.append(byte)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


_STR = ((0xD9, ">B", 2 ** 8), (0xDA, ">H", 2 ** 16), (0xDB, ">I", 2 ** 32))
_BIN = ((0xC4, ">B", 2 ** 8), (0xC5, ">H", 2 ** 16), (0xC6, ">I", 2 ** 32))
_ARRAY = ((0xDC, ">H", 2 ** 16), (0xDD, ">I", 2 ** 32))
_MAP = ((0xDE, ">H", 2 ** 16), (0xDF, ">I", 2 ** 32))
_EXT = ((0xC7, ">B", 2 ** 8), (0xC8, ">H", 2 ** 16), (0xC9, ">I", 2 ** 32))
_FIXEXT_OF = {n: b for b, n in _FIXEXT.items()}


def _pack_int(out: bytearray, v: int):
    """msgpack-python's choice: the narrowest encoding of v."""
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    kinds = (((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
              (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)) if v >= 0 else
             ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
              (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)))
    for byte, fmt, limit in kinds:
        if -limit <= v < limit:
            out.append(byte)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"integer {v} does not fit in 64 bits")


def _pack(out: bytearray, v):
    if v is None or isinstance(v, bool):
        out.append({None: 0xC0, False: 0xC2, True: 0xC3}[v])
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):                  # always float 64
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _head(out, len(b), 0xA0, 31, _STR)
        out += b
    elif isinstance(v, (bytes, bytearray)):
        _head(out, len(v), None, -1, _BIN)
        out += v
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 15, _ARRAY)
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 15, _MAP)
        for k, x in v.items():
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, np.ndarray):
        _pack_ndarray(out, v)
    else:
        raise ValueError(f"cannot encode {type(v).__name__} as msgpack")


def _pack_ndarray(out: bytearray, a: np.ndarray):
    """ext type 1 whose payload is the msgpack of (shape, dtype name,
    C-order bytes), as flax's _ndarray_to_bytes writes it."""
    if a.dtype.name not in _DTYPES:
        raise ValueError(f"unsupported ndarray dtype {a.dtype.name!r}")
    if a.nbytes > _CHUNK_BYTES:
        raise ValueError(f"array of {a.nbytes} bytes: flax would chunk it, "
                         f"which is not supported")
    payload = packb([[int(n) for n in a.shape], a.dtype.name,
                     a.tobytes("C")])
    n = len(payload)
    if n in _FIXEXT_OF:
        out.append(_FIXEXT_OF[n])
    else:
        _head(out, n, None, -1, _EXT)
    out += struct.pack(">b", EXT_NDARRAY)
    out += payload


def packb(obj) -> bytes:
    """Encode `obj` (nested str-keyed dicts in insertion order, lists,
    tuples, str, bytes, ints, floats, bools, None and numpy arrays) as
    flax's msgpack_serialize does: ints at their narrowest width, Python
    floats as float 64, str and bin types apart, ndarrays as ext type 1.
    Arrays over 2^30 bytes raise (flax chunks them)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)
