"""PNG files without PIL: the reader the DSB2018 dataset needs.

Reads non-interlaced PNGs of bit depth 8 in the five colour types (grey,
grey + alpha, RGB, RGBA, palette), each scanline under any of the five
row filters (none, sub, up, average, Paeth).  Adam7 interlacing and
other bit depths raise ``ValueError``.  ``to_grey`` converts as PIL's
``convert("L")`` does: L = (R 19595 + G 38470 + B 7471 + 0x8000) >> 16
on RGB, RGBA and palette entries, the grey channel as it is, alpha
ignored.  ``write_png`` writes grey, grey + alpha, RGB and RGBA images
(filter none).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type (grey, RGB, palette, grey + alpha, RGBA) -> samples per
# pixel
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    off = len(SIGNATURE)
    while off + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[off:off + 8])
        body = data[off + 8:off + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        off += 12 + length
    raise ValueError("PNG without IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines of ``raw`` (each a filter byte then ``stride``
    bytes) reconstructed, as an ``(height, stride)`` uint8 array."""
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data too short")
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)].reshape(
        height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:           # sub: a running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):      # average, Paeth: left to right
            buf, up = bytearray(line.tobytes()), prior.tobytes()
            for i in range(stride):
                a = buf[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, up[i - bpp] if i >= bpp else 0)
                buf[i] = (buf[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str):
    """``(pixels, colour type, palette)``: pixels ``(H, W, samples)``
    uint8 as stored (palette indices for colour type 3), the palette
    ``(n, 3)`` uint8 or None."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNGs are not read")
    if colour not in _SAMPLES:
        raise ValueError(f"{path}: unknown PNG colour type {colour}")
    if depth != 8:
        raise ValueError(f"{path}: PNG bit depth {depth} is not read "
                         f"(8 only)")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    samples = _SAMPLES[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height,
                       width * samples, samples)
    return pixels.reshape(height, width, samples), colour, palette


def _luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def to_grey(pixels: np.ndarray, colour: int, palette=None) -> np.ndarray:
    """PIL's ``convert("L")`` of :func:`read_png`'s result: ``(H, W)``
    uint8."""
    if colour in (0, 4):
        return pixels[..., 0].copy()
    if colour == 3:
        idx = pixels[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError("palette index beyond PLTE")
        return _luma(palette)[idx]
    return _luma(pixels[..., :3])


def load_grey(path: str) -> np.ndarray:
    """The PNG at ``path`` as greyscale ``(H, W)`` uint8."""
    return to_grey(*read_png(path))


def write_png(path: str, pixels: np.ndarray) -> None:
    """An ``(H, W)`` or ``(H, W, C)`` uint8 array, C in 1..4 (grey, grey
    + alpha, RGB, RGBA), as an 8-bit PNG."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    h, w, c = pixels.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           pixels.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
