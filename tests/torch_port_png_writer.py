"""A PNG writer for the tests and chip_smoke.py, for the formats Pillow
cannot write: 16-bit RGB, RGBA and gray+alpha, 2- and 4-bit gray, Adam7
interlacing of any of them, every row filter. numpy and the standard
library only (the card's machine has no Pillow).

    encode_png(samples, depth, color, interlace=False) -> bytes

`samples` is (H, W, C) or (H, W) of integer values below 2^depth; `color`
is the PNG color type (0 gray, 2 RGB, 3 palette indices, 4 gray+alpha,
6 RGBA). Each pass's rows cycle through `filters`, by default 0-4 (None,
Sub, Up, Average, Paeth), so a reader meets every filter in every pass.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _row_bytes(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, stride) bytes of the unfiltered rows."""
    h, w, c = samples.shape
    if depth == 16:
        v = samples.astype(np.uint16).reshape(h, w * c)
        return np.stack([v >> 8, v & 0xFF], -1).reshape(h, -1) \
            .astype(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    per = 8 // depth
    v = samples.reshape(h, w * c).astype(np.uint8)
    v = np.pad(v, ((0, 0), (0, -(w * c) % per)))
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (v.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _filtered(rows: np.ndarray, bpp: int, filters=(0, 1, 2, 3, 4)) -> bytes:
    """Rows of bytes -> each prefixed by its filter type (the filters in
    turn) and filtered with it."""
    h, stride = rows.shape
    x = rows.astype(np.int32)
    up = np.concatenate([np.zeros((1, stride), np.int32), x[:-1]])
    pad = np.zeros((h, bpp), np.int32)
    left = np.concatenate([pad, x[:, :-bpp]], 1)[:, :stride]
    ul = np.concatenate([pad, up[:, :-bpp]], 1)[:, :stride]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    kind = np.asarray(filters)[np.arange(h) % len(filters)]
    out = (x - preds[kind, np.arange(h)]) & 0xFF
    return np.concatenate([kind[:, None], out], 1).astype(np.uint8).tobytes()


def encode_png(samples: np.ndarray, depth: int, color: int, *,
               interlace: bool = False, extra: bytes = b"",
               filters=(0, 1, 2, 3, 4)) -> bytes:
    """-> the bytes of a PNG file of `samples` (see the module docstring);
    `extra` is inserted between IHDR and IDAT (iCCP, tRNS, PLTE...)."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    assert c == SAMPLES[color] and int(samples.max(initial=0)) < 1 << depth
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(
            _filtered(_row_bytes(samples[y0::dy, x0::dx], depth), bpp,
                      filters)
            for x0, y0, dx, dy in ADAM7 if x0 < w and y0 < h)
    else:
        raw = _filtered(_row_bytes(samples, depth), bpp, filters)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    return (SIGNATURE + chunk(b"IHDR", ihdr) + extra
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def write_png16_rgba(path: str, rgba8: np.ndarray, *,
                     interlace: bool = False) -> None:
    """An 8-bit (H, W, 4) image -> a 16-bit RGBA PNG of v · 257 per sample,
    which Pillow (and the port) open as the same 8-bit image."""
    with open(path, "wb") as f:
        f.write(encode_png(rgba8.astype(np.uint16) * 257, 16, 6,
                           interlace=interlace))
