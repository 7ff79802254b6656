"""Minimal, dependency-free TensorBoard event writer (the port's own copy of
``rot_mvgaze_tpu/train/tb.py``; numpy only).

The reference logs scalars and image grids through torch's SummaryWriter,
which needs the tensorboard package. This module encodes the small subset of
the event-file format that scalar and image summaries need: the protobuf
wire format of ``Event``/``Summary`` messages and the TFRecord framing
(length and masked CRC32C). The files load in stock TensorBoard.

Wire schema (field numbers from tensorboard's event.proto / summary.proto):

    Event      { double wall_time = 1; int64 step = 2; string file_version = 3;
                 Summary summary = 5; }
    Summary    { repeated Value value = 1; }
    Value      { string tag = 1; float simple_value = 2; Image image = 4; }
    Image      { int32 height = 1; int32 width = 2; int32 colorspace = 3;
                 bytes encoded_image_string = 4; }
"""

from __future__ import annotations

import io
import itertools
import os
import socket
import struct
import time
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — required by the TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_table() -> None:
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


try:  # C implementation when available (image payloads are 100s of KB;
    # the pure-Python loop costs tens of ms per record on the train loop)
    import google_crc32c as _gcrc32c
except ImportError:  # pragma: no cover - environment-dependent
    _gcrc32c = None


def crc32c(data: bytes) -> int:
    if _gcrc32c is not None:
        return int(_gcrc32c.value(bytes(data)))
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire-format encoding (just what Event/Summary need).
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:
        # protobuf encodes negative int64 as 64-bit two's complement
        # (10-byte varint); python's arithmetic >> would loop forever.
        n += 1 << 64
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _double_field(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _encode_event(
    step: int, summary: Optional[bytes] = None, file_version: Optional[str] = None
) -> bytes:
    msg = _double_field(1, time.time()) + _int_field(2, step)
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if summary is not None:
        msg += _bytes_field(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    v = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
    return _bytes_field(1, v)


def _image_summary(tag: str, png: bytes, h: int, w: int) -> bytes:
    img = (
        _int_field(1, h) + _int_field(2, w) + _int_field(3, 3) + _bytes_field(4, png)
    )
    v = _bytes_field(1, tag.encode()) + _bytes_field(4, img)
    return _bytes_field(1, v)


class SummaryWriter:
    """Drop-in subset of torch.utils.tensorboard.SummaryWriter
    (``add_scalar`` / ``add_image`` / ``flush`` / ``close``)."""

    # per-process writer counter (torch's `.{uid}` suffix): two writers in
    # ONE process within the same epoch-second must not share a file either
    _uid = itertools.count()

    def __init__(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        # pid + uid in the filename (as torch's SummaryWriter does):
        # multi-process trainers on one host start near-simultaneously, and
        # two writers appending to one epoch-second-named file interleave
        # TFRecords — TensorBoard stops at the first CRC mismatch and
        # silently drops everything after it.
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.{next(self._uid)}"
        )
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._write_record(_encode_event(0, file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_encode_event(step, _scalar_summary(tag, value)))

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """image: (H, W, 3) float [0,1] or uint8 (NHWC single image)."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        png = _encode_png(img)
        self._write_record(
            _encode_event(
                step, _image_summary(tag, png, img.shape[0], img.shape[1])
            )
        )

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class NullSummaryWriter:
    """:class:`SummaryWriter`'s interface writing nothing: the writer of
    every rank but 0 under data parallelism (rank 0 alone writes logs)."""

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _encode_png(img: np.ndarray) -> bytes:
    try:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return buf.getvalue()
    except ImportError:  # pragma: no cover - PIL is in the base image
        import zlib

        h, w = img.shape[:2]
        raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
        def chunk(typ, data):
            c = typ + data
            return struct.pack(">I", len(data)) + c + struct.pack(
                ">I", zlib.crc32(c)
            )
        return (
            b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b"")
        )


def make_image_grid(images: np.ndarray, nrow: int = 4, pad: int = 2) -> np.ndarray:
    """Tile (N,H,W,3) images into one grid image, min-max normalized, as
    torchvision's ``make_grid(normalize=True)`` does for the reference."""
    images = np.asarray(images, np.float32)
    lo, hi = images.min(), images.max()
    images = (images - lo) / max(hi - lo, 1e-6)
    n, h, w, c = images.shape
    ncol = (n + nrow - 1) // nrow
    # black padding (torchvision make_grid pad_value=0)
    grid = np.zeros((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c), np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y0 = r * (h + pad) + pad
        x0 = col * (w + pad) + pad
        grid[y0 : y0 + h, x0 : x0 + w] = images[i]
    return grid
