"""Tile blend of the binned records: the CUDA kernel and its plain version.

Counterpart of `d3gs_tpu/ops/pallas_blend.py::blend_records_pallas`
(forward). Semantics, per 16x16 tile t and pixel p, over the tile's sorted
duplicates [starts[t], starts[t+1]) with Gaussian id order[rank_sorted[m]]:

    alpha_k = min(0.99, opa_k·e^power_k), 0 if power_k > 0 or < 1/255
    log T_k = Σ_{j<=k} log1p(-alpha_j),  include_k = e^(log T_k) >= 1e-4
    w_k     = T_{k-1}·alpha_k·include_k
    image   = Σ w_k rgb_k + T_final·bg,  depth = Σ w_k depth_k,
    alpha   = 1 - T_final   (T_final = T after the last included record)

`blend_records` runs the hand-written kernel (`csrc/blend_fwd.cu`) for CUDA
tensors and the plain PyTorch version, `blend_forward_torch`, for CPU
tensors. It never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .binning import RecordBins
from .projection import TILE
from .rasterize import RECORD_FIELDS, RECORD_WIDTH

P = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

# kernel launches of `blend_records` on CUDA tensors since import (or since
# a caller last reset it); the plain version does not count
launches = 0


class BlendOutput(NamedTuple):
    image: torch.Tensor       # (H, W, 3) composed with bg
    depth: torch.Tensor       # (H, W)
    alpha: torch.Tensor       # (H, W) 1 - T_final
    t_final: torch.Tensor     # (H, W) T after the last included record
    log_t: torch.Tensor       # (H, W) log T_final, underflow-free
    n_walked: torch.Tensor    # (H, W) int32 records walked (the failing one
    #                           included); the backward's replay length


def blend_records(records: torch.Tensor, bins: RecordBins, bg: torch.Tensor,
                  *, tiles_x: int, tiles_y: int, width: int, height: int):
    """-> (image (H,W,3), depth (H,W), alpha (H,W))."""
    out = blend_forward(records, bins, bg, tiles_x=tiles_x, tiles_y=tiles_y,
                        width=width, height=height)
    return out.image, out.depth, out.alpha


def blend_forward(records: torch.Tensor, bins: RecordBins, bg: torch.Tensor,
                  *, tiles_x: int, tiles_y: int, width: int,
                  height: int) -> BlendOutput:
    """The full forward: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if records.is_cuda:
        return blend_forward_cuda(records, bins, bg, tiles_x=tiles_x,
                                  tiles_y=tiles_y, width=width, height=height)
    if records.device.type == "cpu":
        return blend_forward_torch(records, bins, bg, tiles_x=tiles_x,
                                   tiles_y=tiles_y, width=width, height=height)
    raise ValueError(f"blend: unsupported device {records.device}")


def _assemble(x: torch.Tensor, tiles_x: int, tiles_y: int, width: int,
              height: int) -> torch.Tensor:
    """(T, P[, C]) per-tile pixels -> (H, W[, C]) image."""
    c = x.shape[2:]
    x = x.reshape(tiles_y, tiles_x, TILE, TILE, *c).transpose(1, 2)
    return x.reshape(tiles_y * TILE, tiles_x * TILE, *c)[:height, :width]


def blend_forward_torch(records: torch.Tensor, bins: RecordBins,
                        bg: torch.Tensor, *, tiles_x: int, tiles_y: int,
                        width: int, height: int,
                        tile_chunk: int = 16) -> BlendOutput:
    """Plain PyTorch version: chunks of tiles, each padded to its longest
    list, with the whole depth recurrence as one cumsum over the list."""
    dev = records.device
    num_tiles = tiles_x * tiles_y
    starts = bins.starts.long()
    counts = starts[1:] - starts[:-1]
    gid = bins.order.long()[bins.rank_sorted.long()]
    rec = records[:, :RECORD_FIELDS]
    pix = torch.arange(P, device=dev)
    lx, ly = (pix % TILE).float(), (pix // TILE).float()

    img = records.new_zeros((num_tiles, P, 3))
    dep = records.new_zeros((num_tiles, P))
    log_t = records.new_zeros((num_tiles, P))
    walked = torch.zeros((num_tiles, P), dtype=torch.int32, device=dev)
    for c0 in range(0, num_tiles, tile_chunk):
        tiles = torch.arange(c0, min(c0 + tile_chunk, num_tiles), device=dev)
        cnt = counts[tiles]
        k_max = int(cnt.max())
        if k_max == 0:
            continue
        k = torch.arange(k_max, device=dev)
        live = k[None, :] < cnt[:, None]                       # (Tc, K)
        idx = torch.where(live, starts[tiles][:, None] + k[None, :], 0)
        r = rec[gid[idx]]                                      # (Tc, K, 10)
        ox = ((tiles % tiles_x) * TILE).float()[:, None, None]
        oy = ((tiles // tiles_x) * TILE).float()[:, None, None]
        dx = r[..., 0:1] - (ox + lx)                           # (Tc, K, P)
        dy = r[..., 1:2] - (oy + ly)
        ca, cb, cc = r[..., 2:3], r[..., 3:4], r[..., 4:5]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        raw = r[..., 8:9] * torch.exp(power)
        bad = (power > 0.0) | (raw < ALPHA_MIN) | ~live[..., None]
        alpha = torch.where(bad, 0.0, raw.clamp_max(ALPHA_MAX))
        lo = torch.log1p(-alpha)
        cs = torch.cumsum(lo, dim=1)                           # log T after
        inc = torch.exp(cs) >= T_EPS
        w = torch.where(inc, torch.exp(cs - lo) * alpha, 0.0)
        img[tiles] = torch.einsum("tkp,tkc->tpc", w, r[..., 5:8])
        dep[tiles] = torch.einsum("tkp,tk->tp", w, r[..., 9])
        # include is a prefix of the list (log T only falls), so log T_final
        # is the smallest included prefix sum
        log_t[tiles] = torch.where(inc, cs, 0.0).amin(dim=1)
        fail = (live[..., None] & ~inc).int()
        first = fail.argmax(dim=1)
        walked[tiles] = torch.where(fail.amax(dim=1) > 0, first + 1,
                                    cnt[:, None]).int()
    t_final = torch.exp(log_t)
    img = img + t_final[..., None] * bg
    asm = lambda x: _assemble(x, tiles_x, tiles_y, width, height)  # noqa: E731
    return BlendOutput(image=asm(img), depth=asm(dep), alpha=asm(1.0 - t_final),
                       t_final=asm(t_final), log_t=asm(log_t),
                       n_walked=asm(walked))


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int]          # records, row stride
             + [ctypes.c_void_p] * 4                  # order, rank, starts, bg
             + [ctypes.c_int] * 4                     # tiles_x/y, width, height
             + [ctypes.c_void_p] * 6                  # outputs
             + [ctypes.c_void_p])                     # stream


def _kernel():
    fn = _build.load("blend_fwd").d3gs_blend_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"blend: {name} must be a contiguous {dtype} tensor "
                         f"on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"blend: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")


def blend_forward_cuda(records: torch.Tensor, bins: RecordBins,
                       bg: torch.Tensor, *, tiles_x: int, tiles_y: int,
                       width: int, height: int) -> BlendOutput:
    """Launch `csrc/blend_fwd.cu` on the current stream; raises if the
    kernel cannot be built or launched."""
    global launches
    dev = records.device
    n = records.shape[0]
    num_tiles = tiles_x * tiles_y
    if not (0 < width <= tiles_x * TILE and 0 < height <= tiles_y * TILE):
        raise ValueError("blend: image size does not match the tile grid")
    _check("records", records, torch.float32, (n, RECORD_WIDTH), dev)
    _check("order", bins.order, torch.int32, (n,), dev)
    _check("rank_sorted", bins.rank_sorted, torch.int32,
           (bins.rank_sorted.shape[0],), dev)
    _check("starts", bins.starts, torch.int32, (num_tiles + 1,), dev)
    _check("bg", bg, torch.float32, (3,), dev)

    image = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    depth, alpha, t_final, log_t = (
        torch.empty((height, width), dtype=torch.float32, device=dev)
        for _ in range(4))
    walked = torch.empty((height, width), dtype=torch.int32, device=dev)
    out = BlendOutput(image=image, depth=depth, alpha=alpha,
                      t_final=t_final, log_t=log_t, n_walked=walked)
    launch(records, bins, bg, out, tiles_x=tiles_x, tiles_y=tiles_y)
    launches += 1
    return out


def launch(records, bins, bg, out: BlendOutput, *, tiles_x: int,
           tiles_y: int) -> None:
    """One launch of the kernel into preallocated outputs, without the
    checks of `blend_forward_cuda` (which calls it) and uncounted."""
    height, width = out.depth.shape
    dev = records.device
    with torch.cuda.device(dev):
        err = _kernel()(
            records.data_ptr(), records.stride(0), bins.order.data_ptr(),
            bins.rank_sorted.data_ptr(), bins.starts.data_ptr(),
            bg.data_ptr(), tiles_x, tiles_y, width, height,
            out.image.data_ptr(), out.depth.data_ptr(), out.alpha.data_ptr(),
            out.t_final.data_ptr(), out.log_t.data_ptr(),
            out.n_walked.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: cudaError {err}")
