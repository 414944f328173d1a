"""PNG read/write with the standard library (zlib + struct), and
`read_image`, which reads PNG or JPEG.

Counterpart of the JAX package's image I/O (`dataset_readers._load_image`,
`render_modes._save_png`), which goes through Pillow/imageio; the port
carries its own codecs so that it needs neither. The PNG codec covers what
those paths use: 8-bit, non-interlaced gray, RGB and RGBA, all five row
filters on read.

`read_image` decodes a file by its signature: PNG here, JPEG (COLMAP sets
such as MipNeRF-360, Tanks&Temples and Deep Blending usually are) with
`jpeg.py`, equal to Pillow bit for bit. The JAX package reads any format
Pillow reads; here any other format raises a ValueError. The port writes
PNG only.

`read_label_png` reads segmentation label maps, which are usually paletted
or 16-bit: it returns what `np.asarray(PIL.Image.open(p))[..., 0]` gives
(the SAM-variant trainer's `load_label_maps`).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .jpeg import SIGNATURE as _JPEG_SIGNATURE, decode_jpeg

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG color type -> samples per pixel


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    data = np.frombuffer(raw, np.uint8)
    if data.size != height * (stride + 1):
        raise ValueError("PNG: image data size does not match the header")
    rows = data.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:          # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:          # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):     # Average / Paeth: left depends on output
            cur = line.copy()
            zero = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                left = cur[x - bpp:x] if x else zero
                up = prev[x:x + bpp]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    pred = _paeth(left, up, prev[x - bpp:x] if x else zero)
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = cur
        prev = cur
    return out


def _read_chunks(path: str, data: bytes | None = None):
    """-> (IHDR fields, the joined IDAT bytes) of a PNG file."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    if data[:3] == _JPEG_SIGNATURE:
        raise ValueError(f"{path}: a JPEG image; read it with read_image")
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: neither PNG nor JPEG; the port decodes "
                         "those two only - convert the images to PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    return header, b"".join(idat)


def read_image(path: str) -> np.ndarray:
    """A PNG or JPEG file -> uint8 array, what `np.asarray(PIL.Image.open(
    path))` gives for the formats each codec covers; any other format
    raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] == _JPEG_SIGNATURE:
        try:
            return decode_jpeg(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    return read_png(path, data)


def read_png(path: str, data: bytes | None = None) -> np.ndarray:
    """-> uint8 array (H, W) for gray, (H, W, 3|4) for RGB/RGBA."""
    header, idat = _read_chunks(path, data)
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, color "
                         f"type {color}, interlace {interlace}); 8-bit "
                         "non-interlaced gray/RGB/RGBA only")
    ch = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(idat), height, width * ch, ch)
    return pixels.reshape(height, width, ch) if ch > 1 else \
        pixels.reshape(height, width)


def read_label_png(path: str) -> np.ndarray:
    """A label map -> (H, W) array, what `np.asarray(PIL.Image.open(path))`
    followed by `[..., 0]` gives: palette indices for a paletted PNG (bit
    depth 1, 2, 4 or 8; not the palette's colours), the values of 8- and
    16-bit gray, channel 0 of 8-bit RGB and RGBA. Any other format
    (interlaced, gray with alpha, 16-bit colour, 1/2/4-bit gray) raises a
    ValueError that names it."""
    header, idat = _read_chunks(path)
    width, height, depth, color, _, _, interlace = header
    ok = interlace == 0 and ((color == 3 and depth in (1, 2, 4, 8))
                             or (color == 0 and depth in (8, 16))
                             or (color in (2, 6) and depth == 8))
    if not ok:
        raise ValueError(
            f"{path}: unsupported label PNG (bit depth {depth}, color type "
            f"{color}, interlace {interlace}); non-interlaced paletted "
            "(1/2/4/8-bit), 8/16-bit gray, 8-bit RGB or RGBA only")
    ch = 1 if color in (0, 3) else _CHANNELS[color]
    bits = width * ch * depth
    stride = (bits + 7) // 8
    rows = _unfilter(zlib.decompress(idat), height, stride,
                     max(1, ch * depth // 8))
    if depth == 16:
        return (rows.reshape(height, width, 2).astype(np.uint16)
                @ np.array([256, 1], np.uint16))
    if depth < 8:            # palette indices packed MSB first
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        idx = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        return idx.reshape(height, stride * per)[:, :width]
    pixels = rows.reshape(height, width, ch)
    return pixels[..., 0]


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W) gray or (H, W, 3|4) RGB/RGBA image."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png: expected uint8, got {img.dtype}")
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        color = 2 if img.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png: unsupported shape {img.shape}")
    height, width = img.shape[:2]
    rows = img.reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))
