"""Packed blend records and the render output type (counterpart of
`d3gs_tpu/ops/rasterize.py`'s record layout)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import ProjectedSplats

# packed blend record: [mean2d.x, mean2d.y, conic.a, conic.b, conic.c,
#                       r, g, b, opacity, depth, <6 pad>]
RECORD_WIDTH = 16
RECORD_FIELDS = 10     # live fields; the blend reads only these


def pack_records(splats: ProjectedSplats) -> torch.Tensor:
    """(N, 16) f32 packed per-Gaussian blend record (the JAX package's
    layout, so tests compare like with like)."""
    n = splats.depths.shape[0]
    pad = splats.depths.new_zeros((n, RECORD_WIDTH - RECORD_FIELDS))
    return torch.cat([
        splats.means2d,
        splats.conics,
        splats.colors,
        splats.opacities[:, None],
        splats.depths[:, None],
        pad,
    ], dim=-1).contiguous()


def pack_records_full(splats: ProjectedSplats) -> torch.Tensor:
    """`pack_records` with the binning fields in the pad lanes: 10-11
    tile_min (x, y), 12-13 tile_max (x, y), 14 visible, 15 the cull radius
    (the tile bounds are small integers, exact in f32). One (N, 16) row
    carries all a remote rank needs to bin and blend a Gaussian, so the
    gauss+tile step all-gathers one tensor per camera
    (`parallel/sharded.py`); the kernels read lanes 0-9 only, so the
    gathered tensor feeds them as it is."""
    return torch.cat([
        pack_records(splats)[:, :RECORD_FIELDS],
        splats.tile_min.float(),
        splats.tile_max.float(),
        splats.visible.float()[:, None],
        splats.cull_radius[:, None],
    ], dim=-1).contiguous()


def unpack_records_full(rec: torch.Tensor) -> ProjectedSplats:
    """Inverse of `pack_records_full`. The radii are not carried (the
    densification statistic reads them on the rank that owns the
    Gaussian), so they come back zero."""
    n = rec.shape[0]
    return ProjectedSplats(
        means2d=rec[:, 0:2], depths=rec[:, 9], conics=rec[:, 2:5],
        radii=torch.zeros((n,), dtype=torch.int32, device=rec.device),
        colors=rec[:, 5:8], opacities=rec[:, 8],
        tile_min=rec[:, 10:12].to(torch.int32),
        tile_max=rec[:, 12:14].to(torch.int32),
        visible=rec[:, 14] > 0.5, cull_radius=rec[:, 15])


class RenderOutput(NamedTuple):
    image: torch.Tensor    # (H, W, 3)
    depth: torch.Tensor    # (H, W) expected depth (unnormalized)
    alpha: torch.Tensor    # (H, W) accumulated opacity
    radii: torch.Tensor    # (N,) int32, 0 => not visible
    counts: torch.Tensor   # (T,) per-tile intersection counts
