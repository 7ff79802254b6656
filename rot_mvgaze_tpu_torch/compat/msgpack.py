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

:func:`dumps` and :func:`dump` write the same format (what
``flax.serialization.to_bytes`` writes for a tree of string-keyed maps,
arrays and scalars), each object in its shortest form; arrays are written
whole, which is what flax does below its chunk size.
"""

from __future__ import annotations

import os
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


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> None:
    """A container or string header: the fix form below ``fix_max``, else
    the 8-bit (when ``codes`` has three), 16-bit or 32-bit length form."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")[-len(codes):]):
        if n < 256 ** struct.calcsize(fmt):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of {n} entries or bytes is too long")


def _ndarray_payload(arr: Any) -> bytes:
    """The ndarray extension's packed ``(shape, dtype name, C-order
    bytes)``."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().contiguous()
        if arr.dtype == torch.bfloat16:
            return dumps([list(arr.shape), "bfloat16", arr.view(torch.int16).numpy().tobytes()])
        arr = arr.numpy()
    arr = np.asarray(arr, order="C")  # (ascontiguousarray would make a 0-d array 1-d)
    return dumps([list(arr.shape), arr.dtype.name, arr.tobytes()])


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    if n in fixed:
        out.append(fixed[n])
    else:
        for head, fmt in ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")):
            if n < 256 ** struct.calcsize(fmt):
                out.append(head)
                out += struct.pack(fmt, n)
                break
    out += struct.pack(">b", code)
    out += payload


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
            return
        forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if obj >= 0 else \
            ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
        for code, fmt in forms:
            try:
                packed = struct.pack(fmt, obj)
            except struct.error:
                continue
            out.append(code)
            out += packed
            return
        raise ValueError(f"integer {obj} does not fit in 64 bits")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), 0, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    else:
        raise TypeError(f"cannot write {type(obj).__name__} as msgpack")


def dumps(tree: Any) -> bytes:
    """The msgpack bytes of ``tree`` (maps, lists, strings, bytes, numbers,
    None, numpy arrays and scalars, tensors), as flax writes them."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def dump(path: str, tree: Any) -> str:
    """Write :func:`dumps` of ``tree`` to ``path`` atomically (a temporary
    file in the same directory, synced, then renamed over it, as the JAX
    package's ``save_state``); returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(dumps(tree))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path
