"""PNG read/write with the standard library (zlib + struct), and
`read_image`, which reads PNG or JPEG.

Counterpart of the JAX package's image I/O (`dataset_readers._load_image`,
`render_modes._save_png`, `convert.py`'s pyramid), which goes through
Pillow/imageio; the port carries its own codecs so that it needs neither.

`read_png` returns what `np.asarray(PIL.Image.open(path))` gives for the
PNG formats the JAX readers train on, all five row filters, interlaced
(Adam7: seven passes, each filtered on its own) or not:
- 8-bit gray (H, W), RGB (H, W, 3), RGBA (H, W, 4), gray+alpha (H, W, 2);
- 2- and 4-bit gray as Pillow's mode L: the values times 85 and 17;
- 16-bit RGB and RGBA: the high byte of each sample; 16-bit gray+alpha
  as Pillow does, RGBA with the gray in R, G and B.
Three formats raise a ValueError that names them, since JAX's readers
mis-train on what Pillow makes of them: 1-bit gray (Pillow's mode 1, a bool
array), 16-bit gray (mode I;16) and palette (mode P). An (H, W, 2) gray +
alpha image loads for `convert --resize`; the readers then fail on its
two channels at `[..., :3]`, as JAX's readers do.

`read_image` decodes a file by its signature: PNG here, JPEG (COLMAP sets
such as MipNeRF-360, Tanks&Temples and Deep Blending usually are) with
`jpeg.py`, equal to Pillow bit for bit. The JAX package reads any format
Pillow reads; here any other format raises a ValueError. With
`info=True` it also returns the entries of Pillow's `im.info` that its
savers write back: a PNG's `icc_profile` (iCCP) and `transparency`
(tRNS, for gray and RGB), a JPEG's `comment` (its last COM segment) and
`icc_profile` (APP2).

`write_png` writes 8-bit gray, gray+alpha, RGB and RGBA, with the iCCP and
tRNS chunks Pillow's PNG saver writes from those entries.

`read_label_png` reads segmentation label maps, which are usually paletted
or 16-bit: it returns what `np.asarray(PIL.Image.open(p))[..., 0]` gives
(the SAM-variant trainer's `load_label_maps`).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .jpeg import COM as _JPEG_COM, SIGNATURE as _JPEG_SIGNATURE, \
    SOS as _JPEG_SOS, decode_jpeg

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG color type -> per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: first column, first row, column step, row step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_ICC_NAME = b"ICC Profile"                  # the name Pillow's saver writes


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    data = np.frombuffer(raw, np.uint8)
    if data.size != height * (stride + 1):
        raise ValueError("PNG: image data size does not match the header")
    rows = data.reshape(height, stride + 1)
    kinds = rows[:, 0]
    if height and kinds.max() > 4:
        raise ValueError(f"PNG: unknown row filter {kinds.max()}")
    if np.isin(kinds, (3, 4)).any():
        return _unfilter_diagonals(rows[:, 1:], kinds, bpp)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ftype, line = kinds[y], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:          # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        else:                     # Up
            cur = (line + prev) & 0xFF
        out[y] = cur
        prev = cur
    return out


def _unfilter_diagonals(lines: np.ndarray, kinds: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Rows of any filter, Average (3) and Paeth (4) among them, whose
    pixel depends on the reconstructed pixel to its left: every pixel of
    one anti-diagonal (y + x = d) depends only on earlier diagonals, so
    each diagonal is one vector step (height + width - 1 steps). The rows
    are skewed, pixel (y, x) at column y + x + 2 of row y + 1, so that a
    diagonal is a column and its left, upper and upper-left neighbours are
    the two columns before it, zero outside the image."""
    h, stride = lines.shape
    w = stride // bpp
    y = np.arange(h)[:, None]
    cols = y + np.arange(w) + 2
    line = np.zeros((h, h + w + 2, bpp), np.int32)
    line[y, cols] = lines.reshape(h, w, bpp)
    out = np.zeros((h + 1, h + w + 2, bpp), np.int32)
    kind = kinds.astype(np.int32)[:, None]
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        left = out[lo + 1:hi + 1, d + 1]
        up, ul = out[lo:hi, d + 1], out[lo:hi, d]
        f = kind[lo:hi]
        pred = np.where(f == 4, _paeth(left, up, ul),
                        np.where(f == 3, (left + up) >> 1,
                                 np.where(f == 2, up, np.where(f == 1, left,
                                                               0))))
        out[lo + 1:hi + 1, d + 2] = (line[lo:hi, d + 2] + pred) & 0xFF
    return out[y + 1, cols].reshape(h, stride).astype(np.uint8)


def _read_chunks(path: str, data: bytes | None = None):
    """-> (IHDR fields, the joined IDAT bytes, {iCCP, tRNS: chunk body}) of
    a PNG file."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    if data[:3] == _JPEG_SIGNATURE:
        raise ValueError(f"{path}: a JPEG image; read it with read_image")
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: neither PNG nor JPEG; the port decodes "
                         "those two only - convert the images to PNG")
    pos, idat, header, extra = 8, [], None, {}
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype in (b"iCCP", b"tRNS") and not idat:
            extra[ctype.decode()] = body
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    return header, b"".join(idat), extra


def _unpack(rows: np.ndarray, width: int, depth: int, ch: int) -> np.ndarray:
    """Unfiltered rows (h, stride) -> samples (h, width, ch): uint16 at
    depth 16, else uint8 (1/2/4-bit values unpacked MSB first)."""
    h = rows.shape[0]
    if depth == 16:
        return (rows.reshape(h, width, ch, 2).astype(np.uint16)
                @ np.array([256, 1], np.uint16))
    if depth == 8:
        return rows.reshape(h, width, ch)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width, None]


def _samples(raw: bytes, width: int, height: int, depth: int, ch: int,
             interlace: int) -> np.ndarray:
    """The decompressed image data -> samples (height, width, ch), one
    image or the seven Adam7 passes, each unfiltered on its own (a pass
    with no rows or columns has no bytes)."""
    bpp = max(1, ch * depth // 8)
    if interlace == 0:
        stride = (width * ch * depth + 7) // 8
        return _unpack(_unfilter(raw, height, stride, bpp), width, depth, ch)
    out = np.zeros((height, width, ch), np.uint16 if depth == 16
                   else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * ch * depth + 7) // 8
        size = ph * (stride + 1)
        rows = _unfilter(raw[pos:pos + size], ph, stride, bpp)
        out[y0::dy, x0::dx] = _unpack(rows, pw, depth, ch)
        pos += size
    if pos != len(raw):
        raise ValueError("PNG: image data size does not match the header")
    return out


def _jpeg_info(data: bytes) -> dict:
    """A JPEG's entries of Pillow's `im.info` that `convert` writes back:
    `comment`, the last COM segment before the first scan, and
    `icc_profile`, its APP2 ICC_PROFILE chunks joined in sequence order
    (None where their count is wrong), as `JpegImagePlugin` reads them."""
    info, icc, pos = {}, [], 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == _JPEG_SOS or 0xD0 <= marker <= 0xD9:
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        if marker == _JPEG_COM:
            info["comment"] = body
        elif marker == 0xE2 and body[:12] == b"ICC_PROFILE\0":
            icc.append(body)
        pos += 2 + length
    if icc:
        icc.sort()
        info["icc_profile"] = (b"".join(p[14:] for p in icc)
                               if icc[0][13] == len(icc) else None)
    return info


def _png_info(extra: dict, color: int) -> dict:
    """Pillow's `im.info` entries from a PNG's iCCP and tRNS chunks."""
    info = {}
    if "iCCP" in extra:
        body = extra["iCCP"]
        info["icc_profile"] = zlib.decompress(body[body.find(b"\0") + 2:])
    trns = extra.get("tRNS")
    if trns is not None and color == 0:
        info["transparency"] = struct.unpack(">H", trns[:2])[0]
    elif trns is not None and color == 2:
        info["transparency"] = struct.unpack(">HHH", trns[:6])
    return info


def read_image(path: str, *, info: bool = False):
    """A PNG or JPEG file -> uint8 array, what `np.asarray(PIL.Image.open(
    path))` gives for the formats each codec covers; any other format
    raises ValueError. With `info=True` -> (array, the `icc_profile`,
    `transparency` and `comment` entries of Pillow's `im.info` that the
    file has)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] == _JPEG_SIGNATURE:
        try:
            img = decode_jpeg(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        return (img, _jpeg_info(data)) if info else img
    return read_png(path, data, info=info)


def read_png(path: str, data: bytes | None = None, *, info: bool = False):
    """-> uint8 array (H, W) gray, (H, W, 2) gray+alpha, (H, W, 3) RGB,
    (H, W, 4) RGBA, as Pillow opens the file (see the module docstring);
    with `info=True`, (array, its `icc_profile` / `transparency`)."""
    header, idat, extra = _read_chunks(path, data)
    width, height, depth, color, _, _, interlace = header
    refused = {(0, 1): "1-bit gray (Pillow's mode 1, a bool array)",
               (0, 16): "16-bit gray (Pillow's mode I;16)"}
    what = ("palette (Pillow's mode P)" if color == 3
            else refused.get((color, depth)))
    if what is None and (depth not in _DEPTHS.get(color, ())
                         or interlace > 1):
        what = f"bit depth {depth}, color type {color}, interlace {interlace}"
    if what:
        raise ValueError(
            f"{path}: unsupported PNG ({what}); the port reads gray "
            "(2/4/8-bit), gray+alpha, RGB and RGBA (8/16-bit), interlaced "
            "or not")
    ch = _SAMPLES[color]
    px = _samples(zlib.decompress(idat), width, height, depth, ch, interlace)
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
        if color == 4:                    # Pillow opens it as RGBA
            px = px[..., [0, 0, 0, 1]]
    elif depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    img = px[..., 0] if ch == 1 else px
    return (img, _png_info(extra, color)) if info else img


def read_label_png(path: str) -> np.ndarray:
    """A label map -> (H, W) array, what `np.asarray(PIL.Image.open(path))`
    followed by `[..., 0]` gives: palette indices for a paletted PNG (bit
    depth 1, 2, 4 or 8; not the palette's colours), the values of 8- and
    16-bit gray, channel 0 of 8-bit RGB and RGBA. Any other format
    (interlaced, gray with alpha, 16-bit colour, 1/2/4-bit gray) raises a
    ValueError that names it."""
    header, idat, _ = _read_chunks(path)
    width, height, depth, color, _, _, interlace = header
    ok = interlace == 0 and ((color == 3 and depth in (1, 2, 4, 8))
                             or (color == 0 and depth in (8, 16))
                             or (color in (2, 6) and depth == 8))
    if not ok:
        raise ValueError(
            f"{path}: unsupported label PNG (bit depth {depth}, color type "
            f"{color}, interlace {interlace}); non-interlaced paletted "
            "(1/2/4/8-bit), 8/16-bit gray, 8-bit RGB or RGBA only")
    ch = _SAMPLES[color]
    return _samples(zlib.decompress(idat), width, height, depth, ch, 0)[..., 0]


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, *, icc_profile: bytes | None =
              None, transparency=None) -> None:
    """Write a uint8 (H, W) gray, (H, W, 2) gray+alpha or (H, W, 3|4)
    RGB/RGBA image; with an iCCP chunk for `icc_profile` and a tRNS chunk
    for `transparency` (an int for gray, (r, g, b) for RGB), as Pillow's
    PNG saver writes them from `im.info`."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png: expected uint8, got {img.dtype}")
    colors = {1: 0, 2: 4, 3: 2, 4: 6}
    ch = 1 if img.ndim == 2 else img.shape[2] if img.ndim == 3 else 0
    if ch not in colors:
        raise ValueError(f"write_png: unsupported shape {img.shape}")
    height, width = img.shape[:2]
    rows = img.reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, colors[ch], 0, 0, 0)
    chunks = [_chunk(b"IHDR", ihdr)]
    if icc_profile:
        chunks.append(_chunk(b"iCCP", _ICC_NAME + b"\0\0"
                             + zlib.compress(icc_profile)))
    if transparency is not None:
        if ch == 1:
            trns = struct.pack(">H", max(0, min(65535, int(transparency))))
        elif ch == 3:
            trns = struct.pack(">HHH", *transparency)
        else:
            raise ValueError("write_png: transparency is for gray and RGB "
                             "images; these have alpha")
        chunks.append(_chunk(b"tRNS", trns))
    chunks += [_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
               _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(_SIGNATURE + b"".join(chunks))
