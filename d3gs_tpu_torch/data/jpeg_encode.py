"""JPEG encoding in numpy, equal byte for byte to Pillow's default save
(libjpeg-turbo's baseline encode).

`encode_jpeg(img, quality=75, comment=None)` returns what
`PIL.Image.fromarray(img).save(buf, "JPEG", quality=quality,
comment=comment)` writes for a uint8 (H, W) gray or (H, W, 3) RGB array:
SOI; APP0 (JFIF 1.01, no density unit, 1x1, no thumbnail); the comment as
a COM segment where one is given; one DQT per table; SOF0; the four
standard Huffman tables (Annex K.3) as one DHT each, in the order the scan
first uses them; SOS; the entropy-coded data; EOI. `convert --resize`
writes its JPEG pyramid with it; the card's machine has no Pillow.

The arithmetic is libjpeg-turbo's, all of it integer:
- quantisation tables (`jcparam.c`): the Annex K tables scaled by
  `jpeg_quality_scaling` (q < 50: 5000 / q, else 200 - 2q), rounded as
  (t · scale + 50) / 100 and clamped to [1, 255] (force_baseline);
- RGB -> YCbCr (`jccolor.c`): 16-bit fixed point, ONE_HALF rounding for Y
  and ONE_HALF - 1 for Cb and Cr;
- 4:2:0 subsampling of Cb and Cr (`jcsample.c::h2v2_downsample`): the
  mean of each 2x2 with a bias of 1, 2, 1, 2, ... along the row, after
  the rows are made even by repeating the last (`jcprepct.c`) and the
  columns are repeated out to whole blocks; the downsampled rows repeat
  their last out to a whole block row; Y repeats its last row and column
  out to whole blocks;
- the `JDCT_ISLOW` forward DCT (`jfdctint.c`: 13-bit constants, PASS1_BITS
  2) on samples less 128, its output scaled by 8;
- quantisation (`jcdctmgr.c`): divisors q << 3 through libjpeg-turbo's
  `compute_reciprocal` (a 16-bit reciprocal, a rounding correction and a
  shift), applied to |x| with the sign put back;
- dummy blocks (`jccoefct.c::compress_data`): where the last MCU runs past
  the luma's blocks, a block to the right gets zero AC and the DC of the
  block to its left, and a block row below gets the DC of the MCU's
  upper-right block;
- Huffman coding (`jchuff.c`): DC differences per component in scan order,
  AC runs with ZRL and EOB, 0xFF followed by a stuffed 0x00, 1-bits
  padding the last byte.
A gray image is one non-interleaved component in 8x8 MCUs; a colour image
one interleaved scan of Y00 Y01 Y10 Y11 Cb Cr MCUs.

Every step is numpy over all blocks at once, the entropy coder included:
the symbols, their codes and lengths are arrays, the bits are placed by
their cumulative offset and the bytes stuffed with `np.insert`.
"""
from __future__ import annotations

import struct

import numpy as np

from .jpeg import (APP0, COM, DHT, DQT, EOI, SOF0, SOI, SOS, _NATURAL)

# Annex K.1, natural (row-major) order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3, each as the body of its DHT segment: Tc/Th, 16 counts, symbols
_SYMBOLS_AC_Y = (
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
    "5455565758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_SYMBOLS_AC_C = (
    "000102031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a82838485868788"
    "898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
_DHT_BODY = {
    (0, 0): bytes.fromhex("00" "00010501010101010100000000000000"
                          "000102030405060708090a0b"),
    (1, 0): bytes.fromhex("10" "0002010303020403050504040000017d"
                          + _SYMBOLS_AC_Y),
    (0, 1): bytes.fromhex("01" "00030101010101010101010000000000"
                          "000102030405060708090a0b"),
    (1, 1): bytes.fromhex("11" "00020102040403040705040400010277"
                          + _SYMBOLS_AC_C),
}

# jfdctint.c
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172

# jccolor.c: FIX(x) = (x · 2^16 + 0.5) truncated
_SCALEBITS = 16


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_ONE_HALF = 1 << (_SCALEBITS - 1)
_CBCR_OFFSET = 128 << _SCALEBITS


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c: jpeg_quality_scaling + jpeg_add_quant_table(force_baseline
    TRUE), natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _reciprocals(qtable: np.ndarray):
    """jcdctmgr.c: compute_reciprocal(q << 3) with 16-bit DCTELEMs, per
    coefficient -> (reciprocal, correction, shift)."""
    recip, corr, shift = [], [], []
    for q in qtable.tolist():
        d = q << 3
        r = 16 + d.bit_length() - 1
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:                   # a power of two
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return (np.array(recip, np.int64), np.array(corr, np.int64),
            np.array(shift, np.int64))


def _huffman_codes(body: bytes) -> tuple[np.ndarray, np.ndarray]:
    """A DHT body -> (code, length) of each of the 256 symbols."""
    counts, symbols = body[1:17], body[17:]
    code_of = np.zeros(256, np.int64)
    size_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]] = code
            size_of[symbols[k]] = length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, size_of


_CODES = {key: _huffman_codes(body) for key, body in _DHT_BODY.items()}


def _fdct_pass(d: list, first: bool) -> list:
    """One 1-D pass of jpeg_fdct_islow over the 8 arrays `d` (one sample
    position each): rows first (scaled up by PASS1_BITS), then columns."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if first:
        shift = _CONST_BITS - _PASS1_BITS
        o0 = (tmp10 + tmp11) << _PASS1_BITS
        o4 = (tmp10 - tmp11) << _PASS1_BITS
    else:
        shift = _CONST_BITS + _PASS1_BITS
        half = 1 << (_PASS1_BITS - 1)
        o0 = (tmp10 + tmp11 + half) >> _PASS1_BITS
        o4 = (tmp10 - tmp11 + half) >> _PASS1_BITS
    rnd = 1 << (shift - 1)
    z1 = (tmp12 + tmp13) * _F0541
    o2 = (z1 + tmp13 * _F0765 + rnd) >> shift
    o6 = (z1 - tmp12 * _F1847 + rnd) >> shift
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5 = tmp4 * _F0298, tmp5 * _F2053
    tmp6, tmp7 = tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    o7 = (tmp4 + z1 + z3 + rnd) >> shift
    o5 = (tmp5 + z2 + z4 + rnd) >> shift
    o3 = (tmp6 + z2 + z3 + rnd) >> shift
    o1 = (tmp7 + z1 + z4 + rnd) >> shift
    return [o0, o1, o2, o3, o4, o5, o6, o7]


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8a, 8b) samples -> (a, b, 8, 8) blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


def _quantized(blocks: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(..., 8, 8) samples -> (..., 64) quantized coefficients in zigzag
    order (jcdctmgr.c: convsamp, the islow DCT, quantize). The samples are
    laid out position-major, so each of the DCT's 1-D passes reads whole
    rows."""
    lead = blocks.shape[:-2]
    x = blocks.reshape(-1, 8, 8).transpose(1, 2, 0).astype(np.int32) - 128
    # int32 as libjpeg-turbo's SIMD DCT, which is bit-equal to the C one
    rows = np.stack(_fdct_pass(list(x.transpose(1, 0, 2)), True))  # u, r
    coef = np.stack(_fdct_pass(list(rows.transpose(1, 0, 2)), False))
    coef = coef.reshape(64, -1)[_NATURAL]              # (8 v, 8 u) -> zigzag
    recip, corr, shift = (a[_NATURAL, None].astype(np.int32)
                          for a in _reciprocals(qtable))
    # (|coef| + corr) < 2^15 and recip < 2^16: the product fits in int32
    mag = ((np.abs(coef) + corr) * recip) >> shift
    return np.where(coef < 0, -mag, mag).T.reshape(*lead, 64)


def _pad_edge(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Repeat the last row and column out to (rows, cols)."""
    return np.pad(plane, ((0, rows - plane.shape[0]),
                          (0, cols - plane.shape[1])), mode="edge")


def _ycc(img: np.ndarray) -> tuple:
    """jccolor.c: rgb_ycc_convert."""
    r, g, b = (img[..., c].astype(np.int32) for c in range(3))
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + _ONE_HALF) >> _SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> _SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> _SCALEBITS
    return y, cb, cr


def _h2v2(plane: np.ndarray, out_rows: int, out_cols: int) -> np.ndarray:
    """jcprepct.c + jcsample.c: rows made even, columns repeated out to
    2 · out_cols, each 2x2 averaged with the bias 1, 2, 1, 2, ..., then the
    output's last row repeated down to out_rows."""
    h = plane.shape[0]
    p = _pad_edge(plane, h + (h & 1), 2 * out_cols)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = 1 + (np.arange(out_cols) & 1)
    return _pad_edge((s + bias) >> 2, out_rows, out_cols)


def _color_scan(img: np.ndarray, qy: np.ndarray, qc: np.ndarray):
    """RGB -> (coefficients (n, 64) in scan order, Huffman table of each
    block, component of each block)."""
    height, width = img.shape[:2]
    mx, my = -(-width // 16), -(-height // 16)
    wb, hb = -(-width // 8), -(-height // 8)        # the luma's own blocks
    y, cb, cr = _ycc(img)
    ycoef = np.zeros((2 * my, 2 * mx, 64), np.int64)
    ycoef[:hb, :wb] = _quantized(_blocks(_pad_edge(y, 8 * hb, 8 * wb)), qy)
    if wb & 1:                      # dummy blocks right: the DC to the left
        ycoef[:hb, wb, 0] = ycoef[:hb, wb - 1, 0]
    if hb & 1:                      # a dummy block row: the upper-right DC
        ycoef[hb, :, 0] = np.repeat(ycoef[hb - 1, 1::2, 0], 2)
    chroma = [_quantized(_blocks(_h2v2(p, 8 * my, 8 * mx)), qc)
              for p in (cb, cr)]
    mcu = np.concatenate(
        [ycoef.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4)
         .reshape(my, mx, 4, 64)] + [c[:, :, None] for c in chroma], 2)
    n = my * mx
    return (mcu.reshape(n * 6, 64), np.tile([0, 0, 0, 0, 1, 1], n),
            np.tile([0, 0, 0, 0, 1, 2], n))


def _bit_length(v: np.ndarray) -> np.ndarray:
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _extra_bits(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The s bits after a symbol: v, or v - 1 in s bits where v < 0."""
    return (v - (v < 0)) & ((1 << s) - 1)


def _entropy_code(coef: np.ndarray, table: np.ndarray,
                  comp: np.ndarray) -> bytes:
    """Huffman-code blocks in scan order -> the scan's stuffed bytes."""
    n = len(coef)
    # DC: the difference from the component's previous block
    dc = coef[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
    dc_s = _bit_length(diff)
    dc_code = np.stack([_CODES[(0, t)][0] for t in (0, 1)])
    dc_size = np.stack([_CODES[(0, t)][1] for t in (0, 1)])
    dc_val = (dc_code[table, dc_s] << dc_s) | _extra_bits(diff, dc_s)
    dc_len = dc_size[table, dc_s] + dc_s
    # AC: each non-zero coefficient after its run of zeros
    blk, k = np.nonzero(coef[:, 1:])
    k = k + 1
    a = coef[blk, k]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    last_nz = np.ones(len(blk), bool)
    last_nz[:-1] = first[1:]
    run = k - np.where(first, 0, np.roll(k, 1)) - 1
    zrl = run >> 4
    ac_s = _bit_length(a)
    rs = ((run & 15) << 4) | ac_s
    ac_code = np.stack([_CODES[(1, t)][0] for t in (0, 1)])
    ac_size = np.stack([_CODES[(1, t)][1] for t in (0, 1)])
    t = table[blk]
    ac_val = (ac_code[t, rs] << ac_s) | _extra_bits(a, ac_s)
    ac_len = ac_size[t, rs] + ac_s
    # EOB where a block's last coefficient is zero
    last = np.zeros(n, np.int64)
    last[blk[last_nz]] = k[last_nz]
    eob = last < 63
    # the items' places: per block DC, (ZRL* AC)*, EOB?
    per_nz = zrl + 1
    nz_items = np.bincount(blk, weights=per_nz, minlength=n).astype(np.int64)
    items = 1 + nz_items + eob
    start = np.concatenate([[0], np.cumsum(items)[:-1]])
    before = np.concatenate([[0], np.cumsum(per_nz)[:-1]])   # over all nz
    block_nz0 = np.concatenate([[0], np.cumsum(nz_items)[:-1]])
    ac_pos = start[blk] + 1 + before - block_nz0[blk] + zrl
    total = int(items.sum())
    val = np.zeros(total, np.int64)
    length = np.zeros(total, np.int64)
    val[start], length[start] = dc_val, dc_len
    val[ac_pos], length[ac_pos] = ac_val, ac_len
    if zrl.any():
        owner = np.repeat(np.arange(len(zrl)), zrl)
        offs = np.arange(len(owner)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
        zpos = ac_pos[owner] - zrl[owner] + offs
        val[zpos] = ac_code[t[owner], 0xF0]
        length[zpos] = ac_size[t[owner], 0xF0]
    epos = (start + items - 1)[eob]
    val[epos] = ac_code[table[eob], 0x00]
    length[epos] = ac_size[table[eob], 0x00]
    return _pack(val, length)


def _pack(val: np.ndarray, length: np.ndarray) -> bytes:
    """Codes of `length` bits each, in order -> bytes, the last padded with
    1-bits, each 0xFF followed by a stuffed 0x00."""
    end = np.cumsum(length)
    off = end - length
    nbits = int(end[-1]) if len(end) else 0
    # each code in a 40-bit window starting at its first byte
    window = val << (40 - (off & 7) - length)
    base = off >> 3
    nbytes = -(-nbits // 8)
    idx = (base[:, None] + np.arange(5)).reshape(-1)
    part = ((window[:, None] >> np.arange(32, -1, -8)) & 0xFF).reshape(-1)
    out = np.bincount(idx, weights=part, minlength=nbytes + 5)[:nbytes]
    out = out.astype(np.uint8)
    if nbits & 7:
        out[-1] |= 0xFF >> (nbits & 7)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(img: np.ndarray, *, quality: int = 75,
                comment: bytes | str | None = None) -> bytes:
    """uint8 (H, W) gray or (H, W, 3) RGB -> the bytes of Pillow's
    `Image.fromarray(img).save(buf, "JPEG", quality=quality,
    comment=comment)`: baseline, 4:2:0 for colour."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg: expected uint8, got {img.dtype}")
    gray = img.ndim == 2
    if not (gray or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg: gray (H, W) or RGB (H, W, 3) only, "
                         f"got shape {img.shape}")
    height, width = img.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"encode_jpeg: size {width}x{height} out of range")
    if isinstance(comment, str):
        comment = comment.encode()
    qy = quant_table(_LUMA_Q, quality)
    qc = quant_table(_CHROMA_Q, quality)
    out = [bytes([0xFF, SOI]),
           _segment(APP0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    if comment:
        if len(comment) > 65533:
            raise ValueError("encode_jpeg: a comment of at most 65533 bytes")
        out.append(_segment(COM, comment))
    tables = [(0, qy)] if gray else [(0, qy), (1, qc)]
    out += [_segment(DQT, bytes([tq]) + t[_NATURAL].astype(np.uint8)
                     .tobytes()) for tq, t in tables]
    if gray:
        sof = struct.pack(">BHHB", 8, height, width, 1) + b"\x01\x11\x00"
        sos = b"\x01\x01\x00\x00\x3f\x00"
        p = _pad_edge(img.astype(np.int32), 8 * -(-height // 8),
                      8 * -(-width // 8))
        coef = _quantized(_blocks(p), qy).reshape(-1, 64)
        table = comp = np.zeros(len(coef), np.int64)
    else:
        sof = (struct.pack(">BHHB", 8, height, width, 3)
               + b"\x01\x22\x00\x02\x11\x01\x03\x11\x01")
        sos = b"\x03\x01\x00\x02\x11\x03\x11\x00\x3f\x00"
        coef, table, comp = _color_scan(img, qy, qc)
    out.append(_segment(SOF0, sof))
    keys = [(0, 0), (1, 0)] if gray else [(0, 0), (1, 0), (0, 1), (1, 1)]
    out += [_segment(DHT, _DHT_BODY[k]) for k in keys]
    out.append(_segment(SOS, sos))
    out.append(_entropy_code(coef, table, comp))
    out.append(bytes([0xFF, EOI]))
    return b"".join(out)
