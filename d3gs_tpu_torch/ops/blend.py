"""Tile blend of the binned records: the CUDA kernel and its plain version.

Counterpart of `d3gs_tpu/ops/pallas_blend.py::blend_records_pallas`
(forward). Semantics, per 16x16 tile t and pixel p, over the tile's sorted
duplicates [starts[t], starts[t+1]) with Gaussian id order[rank_sorted[m]]:

    alpha_k = min(0.99, opa_k·e^power_k), 0 if power_k > 0 or < 1/255
    log T_k = Σ_{j<=k} log1p(-alpha_j),  include_k = e^(log T_k) >= 1e-4
    w_k     = T_{k-1}·alpha_k·include_k
    image   = Σ w_k rgb_k + T_final·bg,  depth = Σ w_k depth_k,
    alpha   = 1 - T_final   (T_final = T after the last included record)

The backward (counterpart of `_bwd_kernel` and `_core_bwd`) walks each
pixel's included records back to front from its last included one,
anchored on the forward's log T_final:

    L_k      = log T after k,  T_before_k = exp(L_k - log1p(-alpha_k))
    w_k      = T_before_k·alpha_k,  gw_k = g_img·rgb_k (+ g_depth·depth_k)
    S_k      = Σ_{included m > k} gw_m·w_m
    g_tf     = Σ_c g_img_c·bg_c − g_alpha          (image = acc + T_final·bg)
    g_alpha_k = gw_k·T_before_k − (S_k + g_tf·T_final)/(1 − alpha_k)
    g_power_k = g_alpha_k·alpha_k, 0 where alpha was clamped or skipped

and sums the per-pixel partials of mean2d, conic, rgb, opacity and depth
into the (N, 16) gradient of the records in the original Gaussian order
(channels 10-15 zero).

`blend_records` (autograd through `BlendFunction`) runs the hand-written
kernels (`csrc/blend_fwd.cu`, `csrc/blend_bwd.cu`) for CUDA tensors and the
plain PyTorch versions, `blend_forward_torch` and `blend_backward_torch`,
for CPU tensors. It never falls back from one to the other. Both kernels
read each duplicate's Gaussian from `sorted_gids` (order[rank_sorted]),
which `BlendFunction` computes once for the pair, and skip, per 16x2
pixel strip, the records that `warp_rows_hit` rules out.

`tile_y0` (the JAX package's argument of the same name) blends a strip of
tile rows [tile_y0, tile_y0 + tiles_y) of a taller image, binned with the
same offset (`bin_splats_records(..., tile_y0=...)`): the records keep
image coordinates, the pixel centres are placed at the image rows, and the
outputs, `height` = the strip's rows, start at the strip's first row. The
tile-row-sharded render (`parallel/sharded.py`) blends one strip per rank.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import tracing
from . import _build
from .binning import RecordBins
from .projection import TILE
from .rasterize import RECORD_FIELDS, RECORD_WIDTH

P = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def launch_counts() -> dict[str, int]:
    """Kernel launches on CUDA tensors since the port's counters were last
    drained (`tracing.drain`): `blend_fwd`, `blend_bwd`; the plain
    versions do not count."""
    c = tracing.counters()
    return {k: c.get("launches." + k, 0) for k in ("blend_fwd", "blend_bwd")}


def sorted_gids(bins: RecordBins) -> torch.Tensor:
    """(M,) int32 Gaussian id of each sorted duplicate: order[rank_sorted],
    the gather both kernels would otherwise repeat per record."""
    return bins.order[bins.rank_sorted.long()]


def warp_rows_hit(rec: torch.Tensor, x0, y0) -> torch.Tensor:
    """The kernels' per-warp cull (`csrc/blend_common.cuh::rows_hit`) in
    f32 PyTorch. For records `rec` (..., >= 9 fields) and 16x2 pixel
    strips with top-left pixel (x0, y0) (tensors or numbers broadcasting
    against rec[..., 0]): False only where the record's alpha, as the
    kernels evaluate it, is below 1/255 at every pixel x0..x0+15 of rows
    y0 and y0 + 1. alpha >= 1/255 means Q = a dx² + 2b dx dy + c dy² <=
    tau = 2 ln(255 opa), on each row an interval of x; tau is widened for
    the rounding of Q (which grows with the conic's condition number,
    bounded by (a + c)² / det) and the interval by 1e-2 px plus 1e-5 of
    its coordinates. Not an ellipse, or NaN: True."""
    mx, my, a, b, c, opa = (rec[..., i] for i in (0, 1, 2, 3, 4, 8))
    det = a * c - b * b
    inv_a = 1.0 / a
    cond = (a + c) * (a + c) / det
    tau = (2.0 * torch.log(opa / ALPHA_MIN) * (1.0 + 1e-5 + 1e-6 * cond)
           + 1e-4)
    hit = torch.zeros_like(mx, dtype=torch.bool)
    for row in (0, 1):
        dy = my - (y0 + row)
        d = tau - det * dy * dy * inv_a
        half = torch.sqrt(d * inv_a)
        cx = mx + b * dy * inv_a
        m = 1e-2 + 1e-5 * (cx.abs() + half)
        hit = hit | (~(d < 0.0) & ~(cx + half + m < x0)
                     & ~(cx - half - m > x0 + 15.0))
    ellipse = (a > 0.0) & (det > 0.0)
    return ~(opa < ALPHA_MIN) & (hit | ~ellipse)


class BlendOutput(NamedTuple):
    image: torch.Tensor       # (H, W, 3) composed with bg
    depth: torch.Tensor       # (H, W)
    alpha: torch.Tensor       # (H, W) 1 - T_final
    t_final: torch.Tensor     # (H, W) T after the last included record
    log_t: torch.Tensor       # (H, W) log T_final, underflow-free
    n_walked: torch.Tensor    # (H, W) int32 records walked (the failing one
    #                           included)
    last_contrib: torch.Tensor  # (H, W) int32 index + 1 (in the tile's list)
    #                           of the last included record, 0 if none: where
    #                           the backward starts


def blend_records(records: torch.Tensor, bins: RecordBins, bg: torch.Tensor,
                  *, tiles_x: int, tiles_y: int, width: int, height: int,
                  depth_grad: bool = True, tile_y0: int = 0):
    """-> (image (H,W,3), depth (H,W), alpha (H,W)), differentiable in
    `records` and `bg`. With depth_grad=False the backward treats the
    depth cotangent as zero and skips its math (the photometric trainers'
    setting, as in the JAX package)."""
    with tracing.span("render.blend"):
        return BlendFunction.apply(records, bg, bins, tiles_x, tiles_y,
                                   width, height, depth_grad, tile_y0)


class BlendFunction(torch.autograd.Function):
    """The tile blend under autograd: `blend_forward` forward,
    `blend_backward` backward. Binning is not differentiable and its
    output rides along as a constant."""

    @staticmethod
    def forward(ctx, records, bg, bins, tiles_x, tiles_y, width, height,
                depth_grad, tile_y0):
        grid = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=width,
                    height=height, tile_y0=tile_y0)
        # one gather of the duplicates' Gaussian ids serves both kernels
        gid = sorted_gids(bins) if records.is_cuda else None
        out = blend_forward(records, bins, bg, gid=gid, **grid)
        ctx.save_for_backward(records, bg, out.t_final, out.last_contrib)
        ctx.bins, ctx.gid, ctx.grid = bins, gid, grid
        ctx.depth_grad = depth_grad
        return out.image, out.depth, out.alpha

    @staticmethod
    def backward(ctx, g_image, g_depth, g_alpha):
        # autograd hands zeros for an output the loss does not use, and may
        # hand expanded (stride-0) gradients, hence .contiguous()
        records, bg, t_final, last_contrib = ctx.saved_tensors
        fwd = BlendOutput(image=None, depth=None, alpha=None,
                          t_final=t_final, log_t=None, n_walked=None,
                          last_contrib=last_contrib)
        with tracing.span("blend.bwd"):
            g_rec = blend_backward(
                records, ctx.bins, bg, fwd, g_image.contiguous(),
                g_depth.contiguous(), g_alpha.contiguous(),
                depth_grad=ctx.depth_grad, gid=ctx.gid, **ctx.grid)
            g_bg = (g_image * t_final[..., None]).sum(dim=(0, 1))
        return g_rec, g_bg, None, None, None, None, None, None, None


def blend_forward(records: torch.Tensor, bins: RecordBins, bg: torch.Tensor,
                  *, tiles_x: int, tiles_y: int, width: int, height: int,
                  tile_y0: int = 0,
                  gid: torch.Tensor | None = None) -> BlendOutput:
    """The full forward: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors. `gid`: `sorted_gids(bins)` if the caller has it (the
    kernel's input; the plain version gathers its own)."""
    grid = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=width, height=height,
                tile_y0=tile_y0)
    if records.is_cuda:
        return blend_forward_cuda(records, bins, bg, **grid, gid=gid)
    if records.device.type == "cpu":
        return blend_forward_torch(records, bins, bg, **grid)
    raise ValueError(f"blend: unsupported device {records.device}")


def _assemble(x: torch.Tensor, tiles_x: int, tiles_y: int, width: int,
              height: int) -> torch.Tensor:
    """(T, P[, C]) per-tile pixels -> (H, W[, C]) image."""
    c = x.shape[2:]
    x = x.reshape(tiles_y, tiles_x, TILE, TILE, *c).transpose(1, 2)
    return x.reshape(tiles_y * TILE, tiles_x * TILE, *c)[:height, :width]


def blend_forward_torch(records: torch.Tensor, bins: RecordBins,
                        bg: torch.Tensor, *, tiles_x: int, tiles_y: int,
                        width: int, height: int, tile_y0: int = 0,
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
    last = torch.zeros((num_tiles, P), dtype=torch.int32, device=dev)
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
        oy = ((tiles // tiles_x + tile_y0) * TILE).float()[:, None, None]
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
        contrib = inc & (alpha > 0.0)
        last[tiles] = torch.where(contrib, k[None, :, None] + 1,
                                  0).amax(dim=1).int()
    t_final = torch.exp(log_t)
    img = img + t_final[..., None] * bg
    asm = lambda x: _assemble(x, tiles_x, tiles_y, width, height)  # noqa: E731
    return BlendOutput(image=asm(img), depth=asm(dep), alpha=asm(1.0 - t_final),
                       t_final=asm(t_final), log_t=asm(log_t),
                       n_walked=asm(walked), last_contrib=asm(last))


def _tiles(x: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """(H, W[, C]) image -> (T, P[, C]) per-tile pixels, zero past the
    image edge (inverse of `_assemble`)."""
    h, w = x.shape[:2]
    c = x.shape[2:]
    pad = x.new_zeros((tiles_y * TILE, tiles_x * TILE, *c))
    pad[:h, :w] = x
    pad = pad.reshape(tiles_y, TILE, tiles_x, TILE, *c).transpose(1, 2)
    return pad.reshape(tiles_x * tiles_y, P, *c)


def blend_backward(records: torch.Tensor, bins: RecordBins, bg: torch.Tensor,
                   fwd: BlendOutput, g_image: torch.Tensor,
                   g_depth: torch.Tensor, g_alpha: torch.Tensor, *,
                   tiles_x: int, tiles_y: int, width: int, height: int,
                   depth_grad: bool = True, tile_y0: int = 0,
                   gid: torch.Tensor | None = None) -> torch.Tensor:
    """Gradient of the (N, 16) records: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors (`gid` as in `blend_forward`)."""
    args = (records, bins, bg, fwd, g_image, g_depth, g_alpha)
    grid = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=width,
                height=height, depth_grad=depth_grad, tile_y0=tile_y0)
    if records.is_cuda:
        return blend_backward_cuda(*args, **grid, gid=gid)
    if records.device.type == "cpu":
        return blend_backward_torch(*args, **grid)
    raise ValueError(f"blend: unsupported device {records.device}")


def blend_backward_torch(records: torch.Tensor, bins: RecordBins,
                         bg: torch.Tensor, fwd: BlendOutput,
                         g_image: torch.Tensor, g_depth: torch.Tensor,
                         g_alpha: torch.Tensor, *, tiles_x: int,
                         tiles_y: int, width: int, height: int,
                         depth_grad: bool = True, tile_y0: int = 0,
                         tile_chunk: int = 16) -> torch.Tensor:
    """Plain PyTorch version of the backward: chunks of tiles padded to
    their longest list; the included set is every record before the
    pixel's `last_contrib` with a nonzero alpha; the suffix sums are one
    reversed cumsum; the per-record sums go to the Gaussians by
    `index_add_`."""
    dev = records.device
    num_tiles = tiles_x * tiles_y
    starts = bins.starts.long()
    counts = starts[1:] - starts[:-1]
    gid = bins.order.long()[bins.rank_sorted.long()]
    rec = records[:, :RECORD_FIELDS]
    pix = torch.arange(P, device=dev)
    lx, ly = (pix % TILE).float(), (pix // TILE).float()

    tl = lambda x: _tiles(x, tiles_x, tiles_y)  # noqa: E731
    g_img = tl(g_image)                                        # (T, P, 3)
    g_dep = tl(g_depth) if depth_grad else None
    t_fin = tl(fwd.t_final)
    g_tf = (g_img * bg).sum(-1) - tl(g_alpha)
    gtt = g_tf * t_fin                                         # (T, P)
    last = tl(fwd.last_contrib).long()

    grad = records.new_zeros((records.shape[0], RECORD_WIDTH))
    for c0 in range(0, num_tiles, tile_chunk):
        tiles = torch.arange(c0, min(c0 + tile_chunk, num_tiles), device=dev)
        cnt = counts[tiles]
        k_max = int(cnt.max())
        if k_max == 0:
            continue
        k = torch.arange(k_max, device=dev)
        live = k[None, :] < cnt[:, None]                       # (Tc, K)
        idx = torch.where(live, starts[tiles][:, None] + k[None, :], 0)
        g_ids = gid[idx]
        r = rec[g_ids]                                         # (Tc, K, 10)
        ox = ((tiles % tiles_x) * TILE).float()[:, None, None]
        oy = ((tiles // tiles_x + tile_y0) * TILE).float()[:, None, None]
        dx = r[..., 0:1] - (ox + lx)                           # (Tc, K, P)
        dy = r[..., 1:2] - (oy + ly)
        ca, cb, cc = r[..., 2:3], r[..., 3:4], r[..., 4:5]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        raw = r[..., 8:9] * torch.exp(power)
        inc = ((power <= 0.0) & (raw >= ALPHA_MIN) & live[..., None]
               & (k[None, :, None] < last[tiles][:, None, :]))
        alpha = torch.where(inc, raw.clamp_max(ALPHA_MAX), 0.0)
        lo = torch.log1p(-alpha)
        t_before = torch.exp(torch.cumsum(lo, dim=1) - lo)
        w = t_before * alpha
        gi = g_img[tiles]                                      # (Tc, P, 3)
        gw = torch.einsum("tpc,tkc->tkp", gi, r[..., 5:8])
        if depth_grad:
            gw = gw + g_dep[tiles][:, None, :] * r[..., 9:10]
        gww = gw * w
        suffix = torch.flip(torch.cumsum(torch.flip(gww, [1]), 1), [1]) - gww
        g_al = gw * t_before - (suffix + gtt[tiles][:, None, :]) / (1 - alpha)
        g_pow = torch.where(inc & (raw <= ALPHA_MAX), g_al * alpha, 0.0)
        opa = r[..., 8]
        parts = [
            -((ca * dx + cb * dy) * g_pow).sum(-1),
            -((cc * dy + cb * dx) * g_pow).sum(-1),
            (-0.5 * dx * dx * g_pow).sum(-1),
            (-dx * dy * g_pow).sum(-1),
            (-0.5 * dy * dy * g_pow).sum(-1),
            *torch.einsum("tkp,tpc->ctk", w, gi),
            torch.where(opa.abs() > 1e-12, g_pow.sum(-1) / opa, 0.0),
            (torch.einsum("tkp,tp->tk", w, g_dep[tiles]) if depth_grad
             else torch.zeros_like(opa)),
        ]
        part = torch.stack(parts, dim=-1) * live[..., None]    # (Tc, K, 10)
        grad[:, :RECORD_FIELDS].index_add_(0, g_ids.reshape(-1),
                                           part.reshape(-1, RECORD_FIELDS))
    return grad


_FWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int]      # records, row stride
                 + [ctypes.c_void_p] * 3              # gid, starts, bg
                 + [ctypes.c_int] * 5                 # tiles_x/y, width, height,
                 #                                      tile_y0
                 + [ctypes.c_void_p] * 7              # outputs
                 + [ctypes.c_void_p])                 # stream
_BWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int]      # records, row stride
                 + [ctypes.c_void_p] * 3              # gid, starts, bg
                 + [ctypes.c_int] * 5                 # tiles_x/y, width, height,
                 #                                      tile_y0
                 + [ctypes.c_void_p] * 2              # t_final, last
                 + [ctypes.c_void_p] * 3              # g_image, g_depth, g_alpha
                 + [ctypes.c_int]                     # depth_grad
                 + [ctypes.c_void_p, ctypes.c_int]    # grad, row stride
                 + [ctypes.c_void_p])                 # stream


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"blend: {name} must be a contiguous {dtype} tensor "
                         f"on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"blend: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")


def _check_inputs(records, bins, bg, tiles_x, tiles_y, width, height, gid,
                  tile_y0=0):
    """Checks the kernels' inputs; returns `gid`, gathered if None."""
    dev = records.device
    n = records.shape[0]
    if not (0 < width <= tiles_x * TILE and 0 < height <= tiles_y * TILE):
        raise ValueError("blend: image size does not match the tile grid")
    if tile_y0 < 0:
        raise ValueError(f"blend: tile_y0 = {tile_y0} < 0")
    # (n, 16) contiguous from a 16-byte boundary: every row is then aligned
    # for the kernels' 16-byte loads (a misaligned one faults the context)
    _check("records", records, torch.float32, (n, RECORD_WIDTH), dev)
    if records.data_ptr() % 16:
        raise ValueError("blend: records must start on a 16-byte boundary "
                         "(the kernels read each row as 16-byte loads)")
    _check("order", bins.order, torch.int32, (n,), dev)
    _check("rank_sorted", bins.rank_sorted, torch.int32,
           (bins.rank_sorted.shape[0],), dev)
    _check("starts", bins.starts, torch.int32, (tiles_x * tiles_y + 1,), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    if gid is None:
        gid = sorted_gids(bins)
    _check("gid", gid, torch.int32, (bins.rank_sorted.shape[0],), dev)
    return gid


def blend_forward_cuda(records: torch.Tensor, bins: RecordBins,
                       bg: torch.Tensor, *, tiles_x: int, tiles_y: int,
                       width: int, height: int, tile_y0: int = 0,
                       gid: torch.Tensor | None = None) -> BlendOutput:
    """Launch `csrc/blend_fwd.cu` on the current stream; raises if the
    kernel cannot be built or launched. `gid`: `sorted_gids(bins)`,
    gathered here if None."""
    gid = _check_inputs(records, bins, bg, tiles_x, tiles_y, width, height,
                        gid, tile_y0)
    dev = records.device
    image = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    depth, alpha, t_final, log_t = (
        torch.empty((height, width), dtype=torch.float32, device=dev)
        for _ in range(4))
    walked, last = (torch.empty((height, width), dtype=torch.int32,
                                device=dev) for _ in range(2))
    out = BlendOutput(image=image, depth=depth, alpha=alpha,
                      t_final=t_final, log_t=log_t, n_walked=walked,
                      last_contrib=last)
    launch(records, gid, bins.starts, bg, out, tiles_x=tiles_x,
           tiles_y=tiles_y, tile_y0=tile_y0)
    tracing.count("launches.blend_fwd")
    return out


def launch(records, gid, starts, bg, out: BlendOutput, *, tiles_x: int,
           tiles_y: int, tile_y0: int = 0) -> None:
    """One launch of the forward kernel into preallocated outputs, without
    the checks of `blend_forward_cuda` (which calls it) and uncounted."""
    height, width = out.depth.shape
    dev = records.device
    with torch.cuda.device(dev):
        err = _build.entry("blend_fwd", _FWD_ARGTYPES)(
            records.data_ptr(), records.stride(0), gid.data_ptr(),
            starts.data_ptr(), bg.data_ptr(), tiles_x, tiles_y, width,
            height, tile_y0, out.image.data_ptr(), out.depth.data_ptr(),
            out.alpha.data_ptr(), out.t_final.data_ptr(),
            out.log_t.data_ptr(), out.n_walked.data_ptr(),
            out.last_contrib.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: cudaError {err}")


def blend_backward_cuda(records: torch.Tensor, bins: RecordBins,
                        bg: torch.Tensor, fwd: BlendOutput,
                        g_image: torch.Tensor, g_depth: torch.Tensor,
                        g_alpha: torch.Tensor, *, tiles_x: int, tiles_y: int,
                        width: int, height: int, depth_grad: bool = True,
                        tile_y0: int = 0,
                        gid: torch.Tensor | None = None) -> torch.Tensor:
    """Launch `csrc/blend_bwd.cu` on the current stream into a zeroed
    (N, 16) gradient; raises if the kernel cannot be built or launched.
    It reads the forward's t_final and last_contrib; `gid` as in
    `blend_forward_cuda`."""
    gid = _check_inputs(records, bins, bg, tiles_x, tiles_y, width, height,
                        gid, tile_y0)
    dev = records.device
    for name, t in (("t_final", fwd.t_final), ("g_depth", g_depth),
                    ("g_alpha", g_alpha)):
        _check(name, t, torch.float32, (height, width), dev)
    _check("last_contrib", fwd.last_contrib, torch.int32, (height, width),
           dev)
    _check("g_image", g_image, torch.float32, (height, width, 3), dev)
    grad = torch.zeros((records.shape[0], RECORD_WIDTH), dtype=torch.float32,
                       device=dev)
    launch_bwd(records, gid, bins.starts, bg, fwd, g_image, g_depth, g_alpha,
               grad, tiles_x=tiles_x, tiles_y=tiles_y, depth_grad=depth_grad,
               tile_y0=tile_y0)
    tracing.count("launches.blend_bwd")
    return grad


def launch_bwd(records, gid, starts, bg, fwd: BlendOutput, g_image, g_depth,
               g_alpha, grad, *, tiles_x: int, tiles_y: int,
               depth_grad: bool, tile_y0: int = 0) -> None:
    """One launch of the backward kernel, accumulating into `grad` (which
    the caller zeroes), without the checks of `blend_backward_cuda` (which
    calls it) and uncounted."""
    height, width = fwd.t_final.shape
    dev = records.device
    with torch.cuda.device(dev):
        err = _build.entry("blend_bwd", _BWD_ARGTYPES)(
            records.data_ptr(), records.stride(0), gid.data_ptr(),
            starts.data_ptr(), bg.data_ptr(), tiles_x, tiles_y, width,
            height, tile_y0, fwd.t_final.data_ptr(), fwd.last_contrib.data_ptr(),
            g_image.data_ptr(), g_depth.data_ptr(), g_alpha.data_ptr(),
            int(depth_grad), grad.data_ptr(), grad.stride(0),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed: cudaError {err}")
