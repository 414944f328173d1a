"""Depth-ordered tile binning into one sorted duplicate list.

Counterpart of `d3gs_tpu/ops/binning.py::bin_splats_records` (without
`tight_cull`), written the way a GPU does it: the reference rasterizer's
expand-and-radix-sort of (tile, depth) keys (SURVEY.md §2.3).

  1. stable depth argsort of the Gaussians (uncovered ones last, key inf);
  2. per-Gaussian covered-tile counts in depth order, exclusive cumsum;
  3. ragged expansion with `repeat_interleave`, truncated at the duplicate
     budget — the deepest Gaussians' duplicates drop first;
  4. one int64 sort of key = (tile << shift) | depth_rank, so entries group
     by tile and run front to back inside each tile;
  5. per-tile segment starts by `searchsorted`.

The outputs are int32 and equal the JAX package's, field for field, on the
first `starts[-1]` entries of `rank_sorted`. With `tile_y0` the binning
covers the tile rows [tile_y0, tile_y0 + tiles_y) only, the strip one rank
blends in the tile-row-sharded render (`parallel/sharded.py`): overlaps are
clipped to the strip and tile keys count from its first row.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import ProjectedSplats


class RecordBins(NamedTuple):
    """Binning output for the packed-record blend."""
    rank_sorted: torch.Tensor   # (M,) depth rank of each sorted duplicate
    starts: torch.Tensor        # (T+1,) segment start of each tile
    counts: torch.Tensor        # (T,)
    order: torch.Tensor         # (N,) depth order (rank -> gaussian id)
    rank_bounds: torch.Tensor   # (N+1,) exclusive cumsum of the surviving
    #                             duplicate counts per rank (last = M)


def bin_splats_records(splats: ProjectedSplats, *, tiles_x: int,
                       tiles_y: int, dup_capacity: int = 0,
                       tile_y0: int = 0) -> RecordBins:
    """Sort-based binning of every (tile, Gaussian) overlap inside the
    tile rows [tile_y0, tile_y0 + tiles_y).

    `dup_capacity` is the duplicate budget (0 = 16·N, rounded up to 512 as
    in the JAX package); M = min(total duplicates, budget)."""
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
    key_sorted = torch.sort(key).values
    rank_sorted = key_sorted & ((1 << shift) - 1)
    tile_keys = torch.arange(num_tiles + 1, device=dev) << shift
    starts = torch.searchsorted(key_sorted, tile_keys, side="left")

    # surviving duplicates per rank: position < kept
    cnt_surv = ends.clamp(0, kept) - offsets.clamp(0, kept)
    rank_bounds = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             torch.cumsum(cnt_surv, 0)])
    i32 = torch.int32
    return RecordBins(rank_sorted=rank_sorted.to(i32), starts=starts.to(i32),
                      counts=torch.diff(starts).to(i32), order=order.to(i32),
                      rank_bounds=rank_bounds.to(i32))
