"""The msgpack artifact format of the JAX package, without ``msgpack`` or
``flax``: ``packb`` gives the bytes ``flax.serialization.msgpack_serialize``
gives for the same tree, and ``unpackb`` reads them back as
``flax.serialization.msgpack_restore`` does.

What the format holds (flax ``serialization.py``):

- maps with string keys, written in sorted key order (flax copies the
  tree with ``jax.tree_util.tree_map``, which sorts dict keys), lists, str,
  bytes, int, float (float64), bool and None, each as msgpack writes it,
  in its smallest form;
- a numpy array as ExtType 1 holding ``packb((shape, dtype.name,
  bytes in C order))``; a numpy scalar as ExtType 3 holding the same for
  its 0-d array.

Python types are matched exactly, as msgpack's ``strict_types=True`` does:
a ``numpy.float64`` is a numpy scalar, not a float; a tuple is refused.
flax splits arrays over 1 GiB into chunks; no phase-1 leaf comes near that,
so such an array raises here, in both directions.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30  # flax serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_NPSCALAR = 1, 3


# ---------------- writing ----------------

def _head(out: List[bytes], n: int, fix: int, fix_max: int,
          codes: Tuple[int, int, int]) -> None:
    """The header of a str, bin, array or map of length ``n``: a fix form
    below ``fix_max`` (``fix`` 0 when there is none), then 8-, 16- and
    32-bit lengths (a code of 0: that width does not exist)."""
    if fix and n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack object of length {n} is too large")


def _int(out: List[bytes], v: int) -> None:
    if v < -(1 << 5):
        if v < -(1 << 15):
            if v < -(1 << 31):
                if v < -(1 << 63):
                    raise OverflowError(f"{v} does not fit in int64")
                out.append(struct.pack(">Bq", 0xd3, v))
            else:
                out.append(struct.pack(">Bi", 0xd2, v))
        elif v < -(1 << 7):
            out.append(struct.pack(">Bh", 0xd1, v))
        else:
            out.append(struct.pack(">Bb", 0xd0, v))
    elif v < 1 << 7:
        out.append(struct.pack(">b", v) if v < 0 else bytes([v]))
    elif v < 1 << 8:
        out.append(struct.pack(">BB", 0xcc, v))
    elif v < 1 << 16:
        out.append(struct.pack(">BH", 0xcd, v))
    elif v < 1 << 32:
        out.append(struct.pack(">BI", 0xce, v))
    elif v < 1 << 64:
        out.append(struct.pack(">BQ", 0xcf, v))
    else:
        raise OverflowError(f"{v} does not fit in uint64")


def _ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(bytes([fixed[n]]))
    else:
        _head(out, n, 0, 0, (0xc7, 0xc8, 0xc9))
    out.append(struct.pack(">b", code))
    out.append(data)


def _array_bytes(arr: np.ndarray) -> bytes:
    """flax ``_ndarray_to_bytes``: ``packb((shape, dtype name, C-order
    bytes))``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out: List[bytes] = []
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")],
          strict=False)
    return b"".join(out)


def _pack(out: List[bytes], x: Any, strict: bool = True) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _int(out, x)
    elif t is float:
        out.append(struct.pack(">Bd", 0xcb, x))
    elif t is str:
        data = x.encode("utf-8")
        _head(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif t is bytes:
        _head(out, len(x), 0, 0, (0xc4, 0xc5, 0xc6))
        out.append(x)
    elif t is list or (not strict and t is tuple):
        _head(out, len(x), 0x90, 16, (0, 0xdc, 0xdd))
        for v in x:
            _pack(out, v, strict)
    elif t is dict:
        _head(out, len(x), 0x80, 16, (0, 0xde, 0xdf))
        for k in sorted(x):
            if type(k) is not str:
                raise TypeError(f"map key {k!r} is not a str")
            _pack(out, k, strict)
            _pack(out, x[k], strict)
    elif isinstance(x, np.ndarray):
        if x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
            raise ValueError(
                f"array of {x.size * x.dtype.itemsize} bytes: flax would "
                "split it into chunks, which this codec does not write")
        _ext(out, EXT_NDARRAY, _array_bytes(x))
    elif isinstance(x, np.generic):
        _ext(out, EXT_NPSCALAR, _array_bytes(np.asarray(x)))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


# ---------------- reading ----------------

class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax reads array headers so)

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(chunk)

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("chunked array (over 1 GiB): not read by this "
                             "codec")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_bytes(data)
        if code == EXT_NPSCALAR:
            return _array_from_bytes(data)[()]
        raise ValueError(f"unknown msgpack ExtType {code}")

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str_(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        lengths = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B",
                   0xda: ">H", 0xdb: ">I", 0xdc: ">H", 0xdd: ">I",
                   0xde: ">H", 0xdf: ">I", 0xc7: ">B", 0xc8: ">H",
                   0xc9: ">I"}
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in lengths:
            raise ValueError(f"unknown msgpack type byte 0x{b:02x}")
        n = self.unpack(lengths[b])
        if b in (0xc4, 0xc5, 0xc6):
            return self.take(n)
        if b in (0xd9, 0xda, 0xdb):
            return self.str_(n)
        if b in (0xdc, 0xdd):
            return self.array(n)
        if b in (0xde, 0xdf):
            return self.map(n)
        return self.ext(n)


def _array_from_bytes(data: bytes) -> np.ndarray:
    """flax ``_ndarray_from_bytes`` (a read-only view of the bytes)."""
    shape, name, buffer = _Reader(data, raw=True).read()
    return np.frombuffer(buffer, dtype=np.dtype(name.decode("ascii"))
                         ).reshape(shape, order="C")


def unpackb(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)`` for the trees
    :func:`packb` writes."""
    reader = _Reader(data, raw=False)
    value = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack object")
    return value
