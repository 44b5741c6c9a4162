"""Image output: uint8 conversion, PNG files and grids, with the standard
library's `zlib` and `struct` and no imaging package.

Counterpart of the JAX package's `utils/images.py` (`to_uint8`,
`save_image_grid`), which writes through PIL; the card's machine has
none. `encode_png` / `write_png` write 8-bit grayscale, RGB or RGBA,
every row with filter 0; `decode_png` / `read_png` read those back (and
any 8-bit non-interlaced PNG, all five row filters), for checks.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[H, W, C] float (about [0, 1]) -> uint8, clipped, truncated as the
    reference's `(clip(img) * 255).astype(uint8)`."""
    img = np.asarray(img, dtype=np.float32)
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(pixels: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C in 1, 3, 4) -> PNG bytes."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8:
        raise TypeError(f"PNG pixels must be uint8, got {pixels.dtype}")
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    h, w, c = pixels.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"PNG pixels need 1, 3 or 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path, pixels: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(pixels))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def read_png(path) -> np.ndarray:
    """An 8-bit, non-interlaced grayscale / RGB / RGBA PNG file -> uint8
    [H, W, C]."""
    return decode_png(Path(path).read_bytes(), name=str(path))


def decode_png(data: bytes, name: str = "data") -> np.ndarray:
    """`read_png` of PNG bytes (a served image's, say)."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name} is not a PNG file")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(f"{name}: only 8-bit non-interlaced gray / RGB / RGBA PNGs are read")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        else:  # sub, average and paeth depend on the row's own earlier bytes
            cur = np.zeros_like(line)
            for x in range(w * c):
                left = cur[x - c] if x >= c else 0
                up, up_left = prev[x], prev[x - c] if x >= c else 0
                pred = {1: left, 3: (left + up) // 2, 4: _paeth(left, up, up_left)}[int(kind)]
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.reshape(h, w, c)


def save_image_grid(images: np.ndarray, path, nrow: int = 8) -> None:
    """[N, H, W, C] float -> one PNG grid at `path`, `nrow` images a row."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    nrow = min(nrow, n)
    ncol = (n + nrow - 1) // nrow
    grid = np.zeros((ncol * h, nrow * w, c), dtype=np.uint8)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = to_uint8(images[i])
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_png(path, grid)
