"""A reader of the JAX package's ``.msgpack`` checkpoints with neither
``msgpack`` nor ``flax`` (what ``flax.serialization.msgpack_restore``
returns for the bytes ``flax.serialization.to_bytes`` writes).

The file is one MessagePack object: maps, arrays, strings, binaries, nil,
booleans, integers and floats of every width, and three extension types:

- 1, an ndarray: the packed triple ``(shape, dtype name, C-order bytes)``;
- 2, a Python complex: the packed pair ``(real, imag)``;
- 3, a numpy scalar: an ndarray triple of shape ``()``.

Arrays above flax's chunk size (2**30 bytes) are written as a map
``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0":
flat part, ...}}``, which :func:`loads` joins back into one array, as flax
does, wherever such a map is a value in a map.

Leaves come back as numpy arrays and scalars, except a ``bfloat16`` array,
which numpy cannot hold: it comes back as a ``torch.bfloat16`` tensor of the
same raw bytes. Unknown extension types and malformed or truncated input
raise ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-size scalars: type byte -> (struct format, size)
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# variable-size objects: type byte -> (kind, struct format of the length)
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: memoryview) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.data)} in all")
        out = self.data[self.pos : end]
        self.pos = end
        return out

    def unpack(self, fmt: str, size: int) -> Any:
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            return self.unpack(*_SCALARS[b])
        if b in _FIXEXT:
            code = self.unpack(">b", 1)
            return _ext(code, self.take(_FIXEXT[b]))
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt, struct.calcsize(fmt))
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            code = self.unpack(">b", 1)
            return _ext(code, self.take(n))
        raise ValueError(f"not msgpack: type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def _array(payload: memoryview) -> Any:
    """An ndarray extension's ``(shape, dtype name, bytes)`` as an array."""
    shape, dtype, buffer = _loads(payload)
    shape = tuple(shape)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        flat = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16) if buffer else \
            torch.empty(0, dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape)


def _ext(code: int, payload: memoryview) -> Any:
    if code == _EXT_NDARRAY:
        return _array(payload)
    if code == _EXT_NPSCALAR:
        arr = _array(payload)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == _EXT_COMPLEX:
        real, imag = _loads(payload)
        return complex(real, imag)
    raise ValueError(f"unknown msgpack extension type {code}")


def _loads(data: Any) -> Any:
    reader = _Reader(memoryview(data))
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    return out


def _unchunk(d: dict) -> Any:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d: Any) -> Any:
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_leaves(v)
    return d


def loads(data: bytes) -> Any:
    """The tree that ``flax.serialization.msgpack_restore(data)`` returns."""
    return _unchunk_leaves(_loads(data))


def load(path: str) -> Any:
    """:func:`loads` of the file at ``path``."""
    with open(path, "rb") as f:
        return loads(f.read())


def looks_like_msgpack_map(head: bytes) -> Tuple[bool, str]:
    """Whether the first two bytes of a file start a msgpack map whose first
    key is a string, as every flax checkpoint does (``0x80 + n`` for up to
    15 keys, then a string's type byte), and why not. A pickle also starts
    with ``0x80``, then its protocol number, 2 to 5, which is never a
    string's type byte."""
    if len(head) < 2:
        return False, "shorter than two bytes"
    b0, b1 = head[0], head[1]
    if not (0x81 <= b0 <= 0x8F or b0 in (0xDE, 0xDF)):
        return False, f"first byte 0x{b0:02x} does not start a map"
    if b0 in (0xDE, 0xDF):
        return True, ""
    if 0xA0 <= b1 <= 0xBF or b1 in (0xD9, 0xDA, 0xDB):
        return True, ""
    return False, f"second byte 0x{b1:02x} does not start a string key"
