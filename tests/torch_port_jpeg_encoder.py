"""A small baseline JPEG encoder for the decoder's tests, for the layouts
Pillow cannot write: sampling factors other than 4:4:4 / 4:2:2 / 4:2:0
(4:4:0, 4:1:1) and one scan per component.

Quality does not matter here, only that the file is valid: the test holds
`d3gs_tpu_torch.data.jpeg` against Pillow's decode of the same bytes. The
DCT is float, the colour conversion JFIF's, and the Huffman tables are
the standard ones that Pillow writes (read from a file it saved).
"""
from __future__ import annotations

import io
import struct

import numpy as np

from d3gs_tpu_torch.data.jpeg import _NATURAL


def _standard_tables() -> tuple[bytes, dict]:
    """The DHT segment bytes Pillow writes by default, and per (class, id)
    the code of each symbol: symbol -> (code, length)."""
    from PIL import Image
    buf = io.BytesIO()
    Image.new("RGB", (8, 8)).save(buf, "JPEG", quality=90)
    data = buf.getvalue()
    segments, codes, pos = [], {}, 2
    while data[pos + 1] != 0xDA:
        marker = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xC4:
            segments.append(data[pos:pos + 2 + length])
            i = 0
            while i < len(body):
                key = (body[i] >> 4, body[i] & 15)
                counts = body[i + 1:i + 17]
                syms = body[i + 17:i + 17 + sum(counts)]
                table, code, k = {}, 0, 0
                for n in range(1, 17):
                    for _ in range(counts[n - 1]):
                        table[syms[k]] = (code, n)
                        code, k = code + 1, k + 1
                    code <<= 1
                codes[key] = table
                i += 17 + sum(counts)
        pos += 2 + length
    return b"".join(segments), codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc, self.n = 0, 0

    def put(self, value: int, length: int):
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    c[0] /= np.sqrt(2)
    return c


def encode_baseline(img: np.ndarray, sampling, *, q: int = 8,
                    interleaved: bool = True) -> bytes:
    """uint8 (H, W, 3) RGB -> a baseline YCbCr JPEG with the given (h, v)
    sampling factor per component, every quantizer `q`; one interleaved
    scan, or one scan per component."""
    h_img, w_img = img.shape[:2]
    x = img.astype(np.float64)
    ycc = np.stack([
        0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
        128 - 0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2],
        128 + 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2],
    ], -1)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcus_x = -(-w_img // (8 * hmax))
    mcus_y = -(-h_img // (8 * vmax))
    full = np.pad(ycc, ((0, mcus_y * 8 * vmax - h_img),
                        (0, mcus_x * 8 * hmax - w_img), (0, 0)), mode="edge")
    dct = _dct_matrix()
    blocks = []
    for ci, (h, v) in enumerate(sampling):
        fh, fv = hmax // h, vmax // v
        p = full[..., ci]
        p = p.reshape(p.shape[0] // fv, fv, p.shape[1] // fh, fh).mean((1, 3))
        b = p.reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8) \
            .transpose(0, 2, 1, 3) - 128.0
        coef = np.einsum("ui,abij,vj->abuv", dct, b, dct)
        blocks.append(np.rint(coef / q).astype(np.int64)
                      .reshape(*coef.shape[:2], 64)[..., _NATURAL])
    dht, codes = _standard_tables()
    out = bytearray(b"\xff\xd8")
    qtable = bytes([0]) + bytes([q] * 64)
    out += b"\xff\xdb" + struct.pack(">H", 2 + len(qtable)) + qtable
    sof = struct.pack(">BHHB", 8, h_img, w_img, 3) + b"".join(
        bytes([ci + 1, (h << 4) | v, 0]) for ci, (h, v) in
        enumerate(sampling))
    out += b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof
    out += dht

    def scan(comps):
        sos = bytes([len(comps)]) + b"".join(
            bytes([ci + 1, 0x00 if ci == 0 else 0x11]) for ci in comps) \
            + bytes([0, 63, 0])
        seg = b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
        bw, pred = _BitWriter(), {ci: 0 for ci in comps}

        def block(ci, blk):
            dc_t = codes[(0, 0 if ci == 0 else 1)]
            ac_t = codes[(1, 0 if ci == 0 else 1)]
            diff = int(blk[0]) - pred[ci]
            pred[ci] = int(blk[0])
            s = _category(diff)
            bw.put(*dc_t[s])
            if s:
                bw.put(diff if diff > 0 else diff + (1 << s) - 1, s)
            run = 0
            for k in range(1, 64):
                a = int(blk[k])
                if a == 0:
                    run += 1
                    continue
                while run > 15:
                    bw.put(*ac_t[0xF0])
                    run -= 16
                s = _category(a)
                bw.put(*ac_t[(run << 4) | s])
                bw.put(a if a > 0 else a + (1 << s) - 1, s)
                run = 0
            if run:
                bw.put(*ac_t[0x00])

        if len(comps) > 1:
            for my in range(mcus_y):
                for mx in range(mcus_x):
                    for ci in comps:
                        h, v = sampling[ci]
                        for dv in range(v):
                            for dh in range(h):
                                block(ci, blocks[ci][my * v + dv,
                                                     mx * h + dh])
        else:
            ci = comps[0]
            h, v = sampling[ci]
            rows = -(-(-(-h_img * v // vmax)) // 8)
            cols = -(-(-(-w_img * h // hmax)) // 8)
            for by in range(rows):
                for bx in range(cols):
                    block(ci, blocks[ci][by, bx])
        return seg + bw.flush()

    if interleaved:
        out += scan([0, 1, 2])
    else:
        for ci in range(3):
            out += scan([ci])
    return bytes(out + b"\xff\xd9")
