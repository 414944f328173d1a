"""JPEG decoding in numpy, equal bit for bit to Pillow's (libjpeg-turbo's
default decode).

`read_jpeg(path)` returns what `np.asarray(PIL.Image.open(path))` gives: a
uint8 (H, W) array for a grayscale file, (H, W, 3) for a colour one. The
card's machine has no Pillow, and COLMAP scenes (MipNeRF-360,
Tanks&Temples, Deep Blending) are usually JPEG, so the readers need their
own decoder.

Covered: baseline (SOF0) and extended sequential 8-bit (SOF1) Huffman
frames and progressive ones (SOF2: spectral selection and successive
approximation, first and refinement scans, DC and AC); standard or
optimized Huffman tables; restart intervals (DRI / RSTn); any sampling
factors whose ratios are integers (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...) and
sizes that crop the last MCUs; one component (grayscale), three YCbCr, and
three RGB (an Adobe APP14 transform of 0, or component ids 'R', 'G',
'B'). EXIF orientation is not applied, as `Image.open` does not apply it.
CMYK / YCCK, 12-bit samples, arithmetic coding, lossless and hierarchical
frames raise a ValueError that names what is not supported; so does a file
that ends early.

The arithmetic is libjpeg-turbo's default decode, all of it integer:
- the `JDCT_ISLOW` inverse DCT (`jidctint.c`: 13-bit constants, descaled
  by CONST_BITS - PASS1_BITS after the columns and CONST_BITS + PASS1_BITS
  + 3 after the rows, then its 1024-entry range-limit table);
- "fancy" upsampling (`jdsample.c`): h2v1 `(3a + b + 1|2) >> 2`, h2v2
  triangular on column sums with biases 8 / 7, libjpeg-turbo's h1v2 with
  biases 1 / 2, box replication where the component is two samples wide
  or less, or the ratio is another integer; context rows past the
  component's last real row repeat it;
- fixed-point YCbCr -> RGB (`jdcolor.c`: SCALEBITS 16, ONE_HALF rounding,
  the same tables).
A progressive file is decoded once every scan is in; libjpeg's block
smoothing (`jdcoefct.c`) runs only while coefficient bits are still
unknown, so on a complete file it does nothing and is not ported.

Entropy decoding is serial and runs in Python: a 16-bit lookahead table
per Huffman table gives each symbol with one list lookup, and the
coefficients go into one flat `array('i')` per component. Dequantisation,
de-zigzag, the IDCT, upsampling and colour conversion are numpy over all
blocks at once.
"""
from __future__ import annotations

import functools
from array import array

import numpy as np

SIGNATURE = b"\xff\xd8\xff"              # SOI and the next marker's FF
# marker codes (the byte after 0xFF) that the decoder and encoder share
SOF0, DHT, SOI, EOI, SOS, DQT, DRI = 0xC0, 0xC4, 0xD8, 0xD9, 0xDA, 0xDB, 0xDD
APP0, COM = 0xE0, 0xFE

# natural (row-major) index of zigzag position k
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_UNSUPPORTED = {
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
    0xC7: "hierarchical (SOF7)",
    0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)",
    0xCB: "arithmetic coding (SOF11)", 0xCD: "arithmetic coding (SOF13)",
    0xCE: "arithmetic coding (SOF14)", 0xCF: "arithmetic coding (SOF15)",
    0xCC: "arithmetic coding (DAC)",
    0xDE: "hierarchical (DHP)", 0xDF: "hierarchical (EXP)",
    0xDC: "a DNL marker",
}

# the value of s extra bits v: v if its top bit is set, else v - (2^s - 1)
_HALF = [0] + [1 << (s - 1) for s in range(1, 17)]
_OFFSET = [0] + [(1 << s) - 1 for s in range(1, 17)]
_MASK = [(1 << s) - 1 for s in range(17)]


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "q", "width", "height",
                 "width_blocks", "rows_own", "stride", "rows", "coef")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.q = None                 # the table latched at its first scan


def _unsupported(what: str) -> ValueError:
    return ValueError(f"JPEG: unsupported {what}; the decoder reads "
                      "8-bit baseline, extended and progressive Huffman "
                      "files with 1 (gray) or 3 (YCbCr / RGB) components")


# a lookahead entry: bits consumed (0-4), run r (5-8), size s (9-12); with
# _FUSED (13) set, the coefficient's value is in bits 14+ and the consumed
# bits include its s extra bits
_FUSED = 1 << 13


@functools.lru_cache(maxsize=32)
def _huffman_luts(counts: bytes, symbols: bytes) -> tuple[tuple, tuple]:
    """-> (plain, fused) 16-bit lookahead tables of one Huffman table, None
    where no code starts with those bits. `fused` decodes a symbol and its
    extra bits at once where they fit in the 16 bits."""
    plain = np.full(1 << 16, -1, np.int64)
    fused = np.full(1 << 16, -1, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("JPEG: bad Huffman table")
            sym = symbols[k]
            r, s = sym >> 4, sym & 15
            span = 1 << (16 - length)
            lo = code * span
            plain[lo:lo + span] = length | (r << 5) | (s << 9)
            if s == 0 or length + s > 16:
                fused[lo:lo + span] = plain[lo:lo + span]
            else:
                bits = (np.arange(lo, lo + span) >> (16 - length - s)) \
                    & ((1 << s) - 1)
                value = np.where(bits < (1 << (s - 1)),
                                 bits - ((1 << s) - 1), bits)
                fused[lo:lo + span] = ((length + s) | (r << 5) | (s << 9)
                                       | _FUSED | (value << 14))
            code, k = code + 1, k + 1
        code <<= 1

    def table(a):
        out = a.astype(object)
        out[a == -1] = None
        return tuple(out.tolist())
    return table(plain), table(fused)


class _Bits:
    """The entropy-coded data of one scan, unstuffed, one segment per
    restart interval: `words[i]` holds bytes i..i+3 big-endian, so any 16
    bits starting at bit `pos` are one lookup and two shifts away."""

    def __init__(self, segments: list[bytes]):
        pad = b"\x00" * 8
        self.starts, self.ends = [], []
        pos = 0
        for seg in segments:
            self.starts.append(pos * 8)
            self.ends.append((pos + len(seg)) * 8)
            pos += len(seg) + len(pad)
        buf = np.frombuffer(pad.join(segments) + pad + b"\x00" * 3,
                            np.uint8).astype(np.uint32)
        self.words = ((buf[:-3] << 24) | (buf[1:-2] << 16) | (buf[2:-1] << 8)
                      | buf[3:]).tolist()


def _scan_segments(data: bytes, pos: int):
    """-> (the scan's restart segments, unstuffed; the offset of the marker
    that ends the scan, or None where the file ends inside it)."""
    segments, start = [], pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            return segments + [data[start:].replace(b"\xff\x00", b"\xff")], \
                None
        nxt = data[i + 1]
        if nxt == 0:
            pos = i + 2
            continue
        j = i + 1
        while j < len(data) and data[j] == 0xFF:       # fill bytes
            j += 1
        if j >= len(data):
            return segments + [data[start:i].replace(b"\xff\x00", b"\xff")], \
                None
        marker = data[j]
        if marker == 0:            # FF FF 00: not valid; read as data
            pos = j + 1
            continue
        segments.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= marker <= 0xD7:
            start = pos = j + 1
            continue
        return segments, j - 1


def _truncated() -> ValueError:
    return ValueError("JPEG: the file ends before its image does "
                      "(truncated or corrupt)")


def _block_layout(scan, mcus_x, mcus_y):
    """The scan's blocks in decode order -> (component index in the scan,
    flat offset of the block's 64 coefficients), and blocks per MCU."""
    if len(scan) == 1:
        c = scan[0]
        by, bx = np.meshgrid(np.arange(c.rows_own), np.arange(c.width_blocks),
                             indexing="ij")
        base = (by * c.stride + bx).reshape(-1) * 64
        return [(0, b) for b in base.tolist()], 1
    per = []
    for si, c in enumerate(scan):
        for v in range(c.v):
            for h in range(c.h):
                per.append((si, c, v, h))
    my, mx = np.meshgrid(np.arange(mcus_y), np.arange(mcus_x), indexing="ij")
    my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
    cols = [((my * c.v + v) * c.stride + mx * c.h + h) * 64
            for _, c, v, h in per]
    bases = np.concatenate(cols, axis=1).reshape(-1).tolist()
    idx = [si for si, *_ in per] * (mcus_y * mcus_x)
    return list(zip(idx, bases)), len(per)


def _decode_scan(bits, layout, per_mcu, restart, coefs, dcs, acs, ss, se,
                 ah, al, progressive):
    """Entropy-decode one scan into the components' coefficient arrays
    (zigzag order within each block)."""
    words, starts, ends = bits.words, bits.starts, bits.ends
    half, offset, mask, fused = _HALF, _OFFSET, _MASK, _FUSED
    seg, pos = 0, starts[0]
    preds = [0] * len(coefs)
    eobrun = 0
    interval = restart * per_mcu if restart else 0
    for n, (si, base) in enumerate(layout):
        if interval and n and n % interval == 0:
            if pos > ends[seg]:
                raise _truncated()
            seg += 1
            if seg >= len(starts):
                raise _truncated()
            pos = starts[seg]
            preds = [0] * len(coefs)
            eobrun = 0
        blk = coefs[si]
        k = ss
        if ss == 0:
            if ah == 0:
                e = dcs[si][(words[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += e & 31
                if e & fused:
                    preds[si] += e >> 14
                else:
                    s = (e >> 9) & 15
                    v = (words[pos >> 3] >> (32 - s - (pos & 7))) & mask[s]
                    pos += s
                    if v < half[s]:
                        v -= offset[s]
                    preds[si] += v
                blk[base] = preds[si] << al
            else:                   # DC refinement: one bit
                if (words[pos >> 3] >> (31 - (pos & 7))) & 1:
                    blk[base] |= 1 << al
                pos += 1
            if progressive:
                continue
            k = 1                   # the block's AC coefficients follow
        if ah == 0:
            if eobrun:
                eobrun -= 1
                continue
            table = acs[si][1]
            while k <= se:
                e = table[(words[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += e & 31
                if e & fused:
                    k += (e >> 5) & 15
                    blk[base + k] = (e >> 14) << al
                    k += 1
                    continue
                s = (e >> 9) & 15
                r = (e >> 5) & 15
                if s:
                    k += r
                    v = (words[pos >> 3] >> (32 - s - (pos & 7))) & mask[s]
                    pos += s
                    if v < half[s]:
                        v -= offset[s]
                    blk[base + k] = v << al
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    if progressive:
                        eobrun = 1 << r
                        if r:
                            eobrun += (words[pos >> 3]
                                       >> (32 - r - (pos & 7))) & mask[r]
                            pos += r
                        eobrun -= 1
                    break
            continue
        # AC refinement (libjpeg's decode_mcu_AC_refine)
        p1, m1 = 1 << al, -1 << al
        table = acs[si][0]
        if not eobrun:
            while k <= se:
                e = table[(words[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += e & 31
                s = (e >> 9) & 15
                r = (e >> 5) & 15
                if s:
                    if s != 1:
                        raise ValueError("JPEG: bad refinement symbol")
                    s = p1 if (words[pos >> 3] >> (31 - (pos & 7))) & 1 \
                        else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (words[pos >> 3]
                                   >> (32 - r - (pos & 7))) & mask[r]
                        pos += r
                    break
                while k <= se:
                    c = blk[base + k]
                    if c:
                        if (words[pos >> 3] >> (31 - (pos & 7))) & 1:
                            if not c & p1:
                                blk[base + k] = c + p1 if c >= 0 else c + m1
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    blk[base + k] = s
                k += 1
        if eobrun:
            while k <= se:
                c = blk[base + k]
                if c:
                    if (words[pos >> 3] >> (31 - (pos & 7))) & 1:
                        if not c & p1:
                            blk[base + k] = c + p1 if c >= 0 else c + m1
                    pos += 1
                k += 1
            eobrun -= 1
    if pos > ends[seg]:
        raise _truncated()


# jidctint.c's constants: FIX(x) = round(x * 2^13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x, axis, shift):
    """One pass of jpeg_idct_islow over `axis` of int64 blocks; returns
    the 8 outputs descaled by `shift` (rounding half up)."""
    g = [np.take(x, i, axis=axis) for i in range(8)]
    z2, z3 = g[2], g[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (g[0] + g[4]) << 13
    tmp1 = (g[0] - g[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = g[7], g[5], g[3], g[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    rnd = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(o + rnd) >> shift for o in out], axis=axis)


def _idct_limit() -> np.ndarray:
    """jdmaster.c's post-IDCT range limit, indexed by (x & 1023): x + 128
    clamped to [0, 255] for x in [-512, 511], wrapping outside."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_LIMIT = _idct_limit()


def _idct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantised int coefficients (row = vertical frequency)
    -> (N, 8, 8) uint8 samples."""
    x = blocks.astype(np.int64)
    x = _idct_1d(x, 1, 13 - 2)             # columns: CONST_BITS - PASS1_BITS
    x = _idct_1d(x.astype(np.int32).astype(np.int64), 2, 13 + 2 + 3)
    return _LIMIT[x & 1023]


def _component_plane(c: _Component) -> np.ndarray:
    coef = np.frombuffer(c.coef, np.int32).reshape(-1, 64)
    deq = coef.astype(np.int64) * c.q[None, :]
    nat = np.empty_like(deq)
    nat[:, _NATURAL] = deq
    pix = _idct_islow(nat.reshape(-1, 8, 8))
    pix = pix.reshape(c.rows, c.stride, 8, 8).transpose(0, 2, 1, 3)
    return pix.reshape(c.rows * 8, c.stride * 8)


def _rows_with_context(p: np.ndarray, height: int) -> tuple:
    """The rows above and below each of `p`'s rows, past the component's
    `height` real rows the last real one (jdmainct.c's context rows)."""
    p = p.astype(np.int32)
    idx = np.minimum(np.arange(p.shape[0]), height - 1)
    p = p[idx]
    up = p[np.maximum(np.arange(p.shape[0]) - 1, 0)]
    down = p[np.minimum(np.arange(p.shape[0]) + 1, height - 1)]
    return p, up, down


def _upsample(p: np.ndarray, c: _Component, hmax: int, vmax: int
              ) -> np.ndarray:
    """A component's sample plane at the full sampling (jdsample.c)."""
    fh, fv = hmax // c.h, vmax // c.v
    if fh == 1 and fv == 1:
        return p
    w = c.width
    if fh == 2 and fv == 1 and w > 2:           # h2v1_fancy_upsample
        a = p[:, :w].astype(np.int32)
        left = np.concatenate([a[:, :1], a[:, :-1]], axis=1)
        right = np.concatenate([a[:, 1:], a[:, -1:]], axis=1)
        out = np.empty((a.shape[0], 2 * w), np.int32)
        out[:, 0::2] = (3 * a + left + 1) >> 2
        out[:, 1::2] = (3 * a + right + 2) >> 2
        return out.astype(np.uint8)
    if fh == 1 and fv == 2:                     # h1v2_fancy_upsample
        a, up, down = _rows_with_context(p[:, :w], c.height)
        out = np.empty((2 * a.shape[0], w), np.int32)
        out[0::2] = (3 * a + up + 1) >> 2
        out[1::2] = (3 * a + down + 2) >> 2
        return out.astype(np.uint8)
    if fh == 2 and fv == 2 and w > 2:           # h2v2_fancy_upsample
        a, up, down = _rows_with_context(p[:, :w], c.height)
        out = np.empty((2 * a.shape[0], 2 * w), np.int32)
        for v, near in ((0, up), (1, down)):
            cs = 3 * a + near
            left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
            right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
            out[v::2, 0::2] = (3 * cs + left + 8) >> 4
            out[v::2, 1::2] = (3 * cs + right + 7) >> 4
        return out.astype(np.uint8)
    return np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)   # box


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: its four tables and range limit."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (91881 * x + one_half) >> 16          # FIX(1.40200)
    cb_b = (116130 * x + one_half) >> 16         # FIX(1.77200)
    cr_g = -46802 * x                            # -FIX(0.71414)
    cb_g = -22554 * x + one_half                 # -FIX(0.34414) + ONE_HALF
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG file bytes -> uint8 (H, W) or (H, W, 3), as Pillow decodes."""
    if data[:3] != SIGNATURE:
        raise ValueError("JPEG: no SOI marker")
    qt: dict[int, np.ndarray] = {}
    dc_luts: dict[int, tuple] = {}
    ac_luts: dict[int, tuple] = {}
    comps: list[_Component] = []
    frame = None
    restart = 0
    jfif = False
    adobe = None
    pos, eoi = 2, False
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        if pos + 1 >= len(data):
            raise _truncated()
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:                      # fill byte
            pos -= 1
            continue
        if marker == EOI:
            eoi = True
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise _truncated()
        length = (data[pos] << 8) | data[pos + 1]
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            raise _truncated()
        pos += length
        if marker in _SOF_UNSUPPORTED:
            raise _unsupported(_SOF_UNSUPPORTED[marker])
        if marker in (0xC0, 0xC1, 0xC2):
            if body[0] != 8:
                raise _unsupported(f"{body[0]}-bit samples")
            height = (body[1] << 8) | body[2]
            width = (body[3] << 8) | body[4]
            n = body[5]
            if n == 4:
                raise _unsupported("CMYK / YCCK (4 components)")
            if n not in (1, 3):
                raise _unsupported(f"{n} components")
            if height == 0 or width == 0:
                raise _unsupported("a zero height (DNL)")
            for i in range(n):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            frame = (marker == 0xC2, width, height)
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            if any(hmax % c.h or vmax % c.v for c in comps):
                raise _unsupported("non-integral sampling ratios")
            mcus_x = -(-width // (8 * hmax))
            mcus_y = -(-height // (8 * vmax))
            for c in comps:
                c.width = -(-width * c.h // hmax)
                c.height = -(-height * c.v // vmax)
                c.width_blocks = -(-c.width // 8)
                c.rows_own = -(-c.height // 8)
                c.stride = mcus_x * c.h
                c.rows = mcus_y * c.v
                c.coef = array("i", bytes(4 * 64 * c.stride * c.rows))
        elif marker == DHT:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                total = sum(counts)
                luts = _huffman_luts(bytes(counts),
                                     bytes(body[i + 17:i + 17 + total]))
                if tc:
                    ac_luts[th] = luts
                else:
                    dc_luts[th] = luts[1]
                i += 17 + total
        elif marker == DQT:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    q = np.frombuffer(body[i + 1:i + 129], ">u2")
                    i += 129
                else:
                    q = np.frombuffer(body[i + 1:i + 65], np.uint8)
                    i += 65
                qt[tq] = q.astype(np.int64)
        elif marker == DRI:
            restart = (body[0] << 8) | body[1]
        elif marker == APP0:
            jfif = jfif or body[:5] == b"JFIF\x00"
        elif marker == 0xEE:
            if body[:5] == b"Adobe" and len(body) >= 12:
                adobe = body[11]
        elif marker == SOS:
            if frame is None:
                raise ValueError("JPEG: a scan before the frame header")
            ns = body[0]
            scan, dcs, acs = [], [], []
            for i in range(ns):
                cid, tables = body[1 + 2 * i], body[2 + 2 * i]
                c = next((c for c in comps if c.cid == cid), None)
                if c is None:
                    raise ValueError(f"JPEG: scan names component {cid}")
                if c.q is None:
                    if c.tq not in qt:
                        raise ValueError("JPEG: missing quantization table")
                    c.q = qt[c.tq]
                scan.append(c)
                dcs.append(dc_luts.get(tables >> 4))
                acs.append(ac_luts.get(tables & 15))
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = a >> 4, a & 15
            progressive = frame[0]
            if not progressive:
                ss, se, ah, al = 0, 63, 0, 0
            if (ss == 0 and ah == 0 and None in dcs) or (se > 0 and
                                                         None in acs):
                raise ValueError("JPEG: missing Huffman table")
            layout, per_mcu = _block_layout(scan, mcus_x, mcus_y)
            segments, end = _scan_segments(data, pos)
            bits = _Bits(segments)
            try:
                _decode_scan(bits, layout, per_mcu, restart,
                             [c.coef for c in scan], dcs, acs, ss, se, ah,
                             al, progressive)
            except IndexError:
                raise _truncated() from None
            except TypeError:           # a None entry: no such code
                raise ValueError("JPEG: bad Huffman code") from None
            if end is None:
                raise _truncated()
            pos = end
        # APPn, COM and anything else: skipped
    if frame is None:
        raise ValueError("JPEG: no frame header")
    if not eoi:
        raise _truncated()
    if any(c.q is None for c in comps):
        raise ValueError("JPEG: a component appears in no scan")
    _, width, height = frame
    planes = [_upsample(_component_plane(c), c, hmax, vmax)[:height, :width]
              for c in comps]
    if len(comps) == 1:
        return np.ascontiguousarray(planes[0])
    rgb = (not jfif and (adobe == 0 if adobe is not None else
                         [c.cid for c in comps] == [82, 71, 66]))
    if rgb:
        return np.stack(planes, axis=-1)
    return _ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file -> uint8 (H, W) for gray, (H, W, 3) for colour: what
    `np.asarray(PIL.Image.open(path))` gives. Errors name the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_jpeg(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
