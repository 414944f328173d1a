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


class RenderOutput(NamedTuple):
    image: torch.Tensor    # (H, W, 3)
    depth: torch.Tensor    # (H, W) expected depth (unnormalized)
    alpha: torch.Tensor    # (H, W) accumulated opacity
    radii: torch.Tensor    # (N,) int32, 0 => not visible
    counts: torch.Tensor   # (T,) per-tile intersection counts
