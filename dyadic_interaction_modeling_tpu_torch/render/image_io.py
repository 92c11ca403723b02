"""PNG in and out without Pillow, and the images that need it.

The port's own image layer: the render path writes and reads its frames as
PNG through the standard library's ``zlib`` and ``struct``, so it runs where
Pillow is not installed. ``encode_png`` writes 8-bit gray, RGB or RGBA
with filter 0 on every row; ``decode_png`` reads 8-bit gray, gray + alpha,
RGB and RGBA, non-interlaced, with all five row filters (Paeth included), so
it also reads what Pillow or libpng write. Anything else (JPEG, palette or
16-bit PNGs, interlacing, resizing) goes through Pillow, imported inside the
function that needs it.
"""

from __future__ import annotations

import struct
import zlib
from io import BytesIO
from typing import Optional, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


class UnsupportedPNG(ValueError):
    """A PNG this module does not decode (palette, 16-bit, interlaced)."""


def pillow():
    """The ``PIL.Image`` module, or an ImportError that says what needs it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("this image needs Pillow (the 'PIL' module), which is not "
                          "installed: only 8-bit PNG at the model's resolution is read "
                          "and written without it") from e
    return Image


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8 pixels, not {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"encode_png takes 1, 2, 3 or 4 channels, not {c}")
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 on each row
    rows[:, 1:] = np.ascontiguousarray(img).reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        start = y * (stride + 1)
        kind = raw[start]
        row = np.frombuffer(raw, np.uint8, stride, start + 1)
        if kind == 0:
            cur = row
        elif kind == 1:  # Sub: a running sum along each byte of the pixel, mod 256
            cur = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint64)
            cur = (cur & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = row + prev
        elif kind in (3, 4):
            buf = bytearray(row.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, C), C = 1 gray, 2 gray + alpha, 3 RGB,
    4 RGBA. Raises ``UnsupportedPNG`` on a file it does not take."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise UnsupportedPNG(f"PNG of bit depth {depth}, colour type {color}, interlace "
                             f"{interlace}: only 8-bit non-interlaced gray / RGB / alpha is "
                             "decoded without Pillow")
    c = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    return _unfilter(raw, h, w * c, c).reshape(h, w, c)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _to_rgb(img: np.ndarray) -> np.ndarray:
    """As Pillow's ``convert("RGB")``: gray repeated, alpha dropped."""
    c = img.shape[-1]
    if c in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=-1)
    return np.ascontiguousarray(img[:, :, :3])


def decode_rgb(data: bytes, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Image bytes -> uint8 (H, W, 3): a PNG this module takes, at ``size``
    (width, height) or with ``size`` None, without Pillow; anything else, or a
    resize, through Pillow (``convert("RGB")``, then its default resampling)."""
    if data[:8] == SIGNATURE:
        try:
            img = _to_rgb(decode_png(data))
        except UnsupportedPNG:
            img = None
        if img is not None and (size is None or (img.shape[1], img.shape[0]) == tuple(size)):
            return img
    image = pillow().open(BytesIO(data)).convert("RGB")
    if size is not None:
        image = image.resize(tuple(size))
    return np.asarray(image)


def read_rgb(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_rgb(f.read(), size)
