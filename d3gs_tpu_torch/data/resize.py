"""Bicubic image resize equal, bit for bit, to Pillow's default
`Image.resize(size)` on 8-bit images (the camera resize of
`d3gs_tpu/data/cameras.py`, which goes through Pillow).

Pillow's two-pass convolution (`src/libImaging/Resample.c`), rule by rule:
- the cubic kernel with a = -0.5, support 2, stretched by the scale when
  downsampling: support = 2 · max(in / out, 1);
- output pixel i centred at (i + 0.5) · in / out; its window runs from
  int(centre - support + 0.5) to int(centre + support + 0.5), clamped to
  the image (C truncation toward zero);
- the taps' weights, evaluated in double precision at
  (j - centre + 0.5) / max(in / out, 1) and summed in order, are divided by
  their sum, then made 8-bit fixed point at PRECISION_BITS = 22 (rounded
  away from zero);
- each output value is (1 << 21) + Σ pixel · weight, shifted right by 22
  and clipped to [0, 255];
- the horizontal pass runs first and the vertical pass second, each skipped
  when its size does not change, with a uint8 image between them.
An image with alpha, (H, W, 4) RGBA or (H, W, 2) LA, goes the way
`Image.resize` sends it (`PIL/Image.py`: it converts RGBA to RGBa and LA to
La, resamples, and converts back; `src/libImaging/Convert.c`):
- each colour channel is premultiplied by alpha with MULDIV255,
  t = c · a + 128, ((t >> 8) + t) >> 8;
- the two passes run on every channel, alpha included;
- the colour comes back as 255 · c / a, truncated and clipped to 255, where
  alpha is neither 0 nor 255 (there it stays as resampled).
So a pixel of alpha 0 loses its colour: (100, 150, 200, 0) resamples as
(0, 0, 0, 0). A size that does not change returns a copy, as Pillow does.
It runs on the host in numpy, where the JAX package resizes.
"""
from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2
_A = -0.5
_SUPPORT = 2.0


def _bicubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    near = ((_A + 2.0) * x - (_A + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * _A
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int):
    """-> (xmin (out,), int64 fixed-point weights (out, ksize)) of one axis
    (Resample.c: precompute_coeffs, normalize_coeffs_8bpc)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    ss = 1.0 / filterscale
    k = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):          # the taps in order: ww sums as C does
        w = np.where(x < xmax, _bicubic(((x + xmin) - center + 0.5) * ss),
                     0.0)
        k[:, x] = w
        ww = ww + w
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    scaled = k * (1 << PRECISION_BITS)
    fixed = np.trunc(np.where(scaled < 0, scaled - 0.5, scaled + 0.5))
    return xmin, fixed.astype(np.int64)


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit convolution pass along `axis` (0 rows, 1 columns)."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    extra = (slice(None),) + (None,) * (src.ndim - 1)
    for x in range(k.shape[1]):
        idx = np.minimum(xmin + x, in_size - 1)   # weight 0 past the window
        acc += src[idx] * k[:, x][extra]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int32) * b + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) gray, (H, W, 2) LA, (H, W, 3) RGB or (H, W, 4) RGBA ->
    (size[1], size[0], ...) uint8, as `PIL.Image.fromarray(img).resize(
    size)` (size is (width, height)); LA and RGBA with premultiplied
    alpha."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize: expected uint8, got {img.dtype}")
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (2, 3, 4))):
        raise ValueError(f"resize: gray, LA, RGB or RGBA only, got shape "
                         f"{img.shape}")
    width, height = size
    if (height, width) == img.shape[:2]:
        return img.copy()
    alpha = img.ndim == 3 and img.shape[2] in (2, 4)
    out = img
    if alpha:
        out = np.concatenate([_muldiv255(img[..., :-1], img[..., -1:]),
                              img[..., -1:]], -1)
    if width != img.shape[1]:
        out = _pass(out, width, 1)
    if height != img.shape[0]:
        out = _pass(out, height, 0)
    if alpha:
        a = out[..., -1:].astype(np.int32)
        color = out[..., :-1]
        undo = np.minimum(255 * color.astype(np.int32) // np.maximum(a, 1),
                          255).astype(np.uint8)
        out[..., :-1] = np.where((a == 0) | (a == 255), color, undo)
    return out
