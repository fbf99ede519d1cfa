"""A small PNG reader and writer on numpy and zlib (no Pillow).

``read_png`` takes 8-bit RGB or RGBA, non-interlaced images with any of the
five row filters, and returns [H, W, 3] uint8 (alpha dropped, as Pillow's
``convert("RGB")`` does).  ``write_png`` writes [H, W, 3] uint8 as 8-bit RGB
with filter 0 on every row.  Every other PNG variant raises ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # color type -> channels (RGB, RGBA)


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _paeth_row(filt: bytearray, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (out[x] + pred) & 0xFF
    return out


def _average_row(filt: bytearray, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        out[x] = (out[x] + ((a + prev[x]) >> 1)) & 0xFF
    return out


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        filt = np.frombuffer(raw, np.uint8, stride, start + 1)
        if kind == 0:
            row = filt
        elif kind == 1:  # Sub: running sum over each channel, mod 256
            row = (filt.reshape(-1, bpp).astype(np.int64).cumsum(axis=0) % 256)
            row = row.astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = filt + prev  # uint8 wraps mod 256
        elif kind == 3:
            row = np.frombuffer(_average_row(bytearray(filt), prev.tobytes(), bpp), np.uint8)
        elif kind == 4:
            row = np.frombuffer(_paeth_row(bytearray(filt), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} is not one of 0-4")
        rows[y] = row
        prev = rows[y]
    return rows


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] uint8 pixels of an 8-bit RGB/RGBA, non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _CHANNELS or compression or filtering or interlace:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA non-interlaced PNGs are supported "
                         f"(depth {depth}, color type {color}, interlace {interlace})")
    channels = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (width * channels + 1):
        raise ValueError(f"{path}: PNG data of {len(raw)} bytes does not match its header")
    rows = _unfilter(raw, height, width * channels, channels)
    return np.ascontiguousarray(rows.reshape(height, width, channels)[:, :, :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write [H, W, 3] uint8 as an 8-bit RGB PNG (filter 0 on every row)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, got {image.dtype} {image.shape}")
    height, width, _ = image.shape
    rows = np.zeros((height, width * 3 + 1), np.uint8)
    rows[:, 1:] = image.reshape(height, width * 3)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


__all__ = ["read_png", "write_png"]
