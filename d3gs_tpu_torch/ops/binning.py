"""Depth-ordered tile binning into one sorted duplicate list.

Counterpart of `d3gs_tpu/ops/binning.py::bin_splats_records`, written the
way a GPU does it: the reference rasterizer's expand-and-radix-sort of
(tile, depth) keys (SURVEY.md §2.3).

  1. stable depth argsort of the Gaussians (uncovered ones last, key inf);
  2. per-Gaussian covered-tile counts in depth order, exclusive cumsum;
  3. ragged expansion with `repeat_interleave`, truncated at the duplicate
     budget — the deepest Gaussians' duplicates drop first;
  4. with `tight_cull`, a mask over the expanded duplicates: a duplicate
     whose largest alpha over its tile's pixels stays under 1/255
     (`tile_max_power`) is keyed past the last tile;
  5. one int64 sort of key = (tile << shift) | depth_rank, so entries group
     by tile and run front to back inside each tile (culled ones last);
  6. per-tile segment starts by `searchsorted`.

The outputs are int32 and equal the JAX package's, field for field, on the
first `starts[-1]` entries of `rank_sorted`; without the cull `rank_sorted`
holds just those, with it also the culled duplicates after them, which no
tile's segment reaches (trimming them would cost a second host sync).
With `tile_y0` the binning covers the tile rows [tile_y0, tile_y0 +
tiles_y) only, the strip one rank blends in the tile-row-sharded render
(`parallel/sharded.py`): overlaps are clipped to the strip and tile keys
count from its first row.
"""
from __future__ import annotations

from typing import NamedTuple

import math

import torch

from .projection import TILE, ProjectedSplats

# a duplicate survives the cull when its largest alpha over the tile,
# opacity · e^pmax, reaches 1/255: pmax + log(opacity) >= log(1/255), the
# threshold in f32 as the JAX package evaluates it
LOG_ALPHA_MIN = float(torch.log(torch.tensor(1.0 / 255.0)))


class RecordBins(NamedTuple):
    """Binning output for the packed-record blend."""
    rank_sorted: torch.Tensor   # (M,) depth rank of each sorted duplicate
    starts: torch.Tensor        # (T+1,) segment start of each tile
    counts: torch.Tensor        # (T,)
    order: torch.Tensor         # (N,) depth order (rank -> gaussian id)
    rank_bounds: torch.Tensor   # (N+1,) exclusive cumsum of the surviving
    #                             duplicate counts per rank (last = M)


def tile_max_power(mux, muy, ca, cb, cc, tx, ty):
    """Largest Gaussian exponent over tile (tx, ty)'s pixel rectangle
    [16·tx, 16·tx + 15] × [16·ty, 16·ty + 15] (tx, ty absolute, f32):
    0 where the mean lies inside it, else the largest of the four edges'
    1-D quadratics, each optimum clamped to its edge. The JAX package's
    `_tile_max_power`, operation for operation, so the same f32 inputs
    give the same bits. A duplicate whose opacity · e^pmax stays under
    1/255 is skipped by every pixel's alpha test and consumes no
    transmittance, so dropping it leaves the blend's output as it was."""
    x0 = tx * TILE
    x1 = x0 + (TILE - 1)
    y0 = ty * TILE
    y1 = y0 + (TILE - 1)

    def power(dx, dy):
        return -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy

    def vedge(xe):
        dx = xe - mux
        dy = torch.clamp(-cb * dx / cc.clamp_min(1e-12), y0 - muy, y1 - muy)
        return power(dx, dy)

    def hedge(ye):
        dy = ye - muy
        dx = torch.clamp(-cb * dy / ca.clamp_min(1e-12), x0 - mux, x1 - mux)
        return power(dx, dy)

    pmax = torch.maximum(torch.maximum(vedge(x0), vedge(x1)),
                         torch.maximum(hedge(y0), hedge(y1)))
    inside = (mux >= x0) & (mux <= x1) & (muy >= y0) & (muy <= y1)
    return torch.where(inside, torch.zeros_like(pmax), pmax)


def bin_splats_records(splats: ProjectedSplats, *, tiles_x: int,
                       tiles_y: int, dup_capacity: int = 0,
                       tile_y0: int = 0,
                       tight_cull: bool = False) -> RecordBins:
    """Sort-based binning of every (tile, Gaussian) overlap inside the
    tile rows [tile_y0, tile_y0 + tiles_y).

    `dup_capacity` is the duplicate budget (0 = 16·N, rounded up to 512 as
    in the JAX package); M = min(total duplicates, budget), less the
    duplicates `tight_cull` drops after the budget's truncation."""
    n = splats.depths.shape[0]
    dev = splats.depths.device
    num_tiles = tiles_x * tiles_y
    if dup_capacity <= 0:
        dup_capacity = 16 * n
    m_cap = ((dup_capacity + 511) // 512) * 512
    shift = max(int(n).bit_length(), 1)

    tmin = splats.tile_min.long()
    tmax = splats.tile_max.long()
    ty_lo = tmin[:, 1].clamp_min(tile_y0)
    ty_hi = tmax[:, 1].clamp_max(tile_y0 + tiles_y)
    bw = tmax[:, 0] - tmin[:, 0]
    bh = (ty_hi - ty_lo).clamp_min(0)
    cnt_u = torch.where(splats.visible, bw * bh, torch.zeros_like(bw))

    depth_key = torch.where(cnt_u > 0, splats.depths,
                            torch.full_like(splats.depths, float("inf")))
    order = torch.argsort(depth_key, stable=True)
    cnt = cnt_u[order]
    ends = torch.cumsum(cnt, 0)
    offsets = ends - cnt
    total = int(ends[-1]) if n else 0
    kept = min(total, m_cap)

    # ragged expand: duplicate m belongs to depth rank src[m]
    rank = torch.arange(n, device=dev)
    src = torch.repeat_interleave(rank, cnt, output_size=total)[:kept]
    j = torch.arange(kept, device=dev) - offsets[src]
    w = bw[order].clamp_min(1)[src]
    tx = tmin[order, 0][src] + j % w
    ty = ty_lo[order][src] + j // w - tile_y0
    key = ((ty * tiles_x + tx) << shift) | src
    if tight_cull:
        g = order[src]
        mu = splats.means2d[g]
        con = splats.conics[g]
        # the tile's absolute row: ty counts from the strip's first row
        pmax = tile_max_power(mu[:, 0], mu[:, 1], con[:, 0], con[:, 1],
                              con[:, 2], tx.float(),
                              (ty + tile_y0).float())
        keep = (pmax + torch.log(splats.opacities[g].clamp_min(1e-30))
                >= LOG_ALPHA_MIN)
        key = torch.where(keep, key, num_tiles << shift)
    key_sorted = torch.sort(key).values
    rank_sorted = key_sorted & ((1 << shift) - 1)
    tile_keys = torch.arange(num_tiles + 1, device=dev) << shift
    starts = torch.searchsorted(key_sorted, tile_keys, side="left")

    # surviving duplicates per rank: position < kept, and kept by the cull
    # (src ascends, so a rank's duplicates are one run of the expansion:
    # a cumsum over the mask counts them without a host sync)
    if tight_cull:
        vcs = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                         torch.cumsum(keep.long(), 0)])
        cnt_surv = vcs[ends.clamp(0, kept)] - vcs[offsets.clamp(0, kept)]
    else:
        cnt_surv = ends.clamp(0, kept) - offsets.clamp(0, kept)
    rank_bounds = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             torch.cumsum(cnt_surv, 0)])
    i32 = torch.int32
    return RecordBins(rank_sorted=rank_sorted.to(i32), starts=starts.to(i32),
                      counts=torch.diff(starts).to(i32), order=order.to(i32),
                      rank_bounds=rank_bounds.to(i32))
