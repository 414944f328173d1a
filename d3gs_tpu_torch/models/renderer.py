"""Renderer bridge: compose the deformation with the Gaussians and rasterize
(counterpart of `d3gs_tpu/models/renderer.py::render`, the reference's
gaussian_renderer/__init__.py::render()).

Compositions: additive (means = xyz + d_xyz, scales = exp(s)·mod + d_s,
rotations = normalize(q) + d_r, normalized again inside the projection) and
direct (`direct_compute`: d_xyz are absolute positions, the ODE path).
SH→RGB happens here per view direction. Then projection, binning, record
packing and the tile blend (the CUDA kernel on the card).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..data.cameras import Camera
from ..ops.binning import bin_splats_records
from ..ops.blend import blend_records
from ..ops.projection import TILE, project_gaussians
from ..ops.rasterize import RenderOutput, pack_records
from ..ops.sh import eval_sh_upto
from .gaussians import GaussianState


def render(
    gaussians: GaussianState,
    camera: Camera,
    *,
    d_xyz: torch.Tensor | float = 0.0,
    d_rotation: torch.Tensor | float = 0.0,
    d_scaling: torch.Tensor | float = 0.0,
    is_6dof: bool = False,
    direct_compute: bool = False,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    bg: torch.Tensor | None = None,
    antialias: bool = False,
    dup_capacity: int = 0,
) -> RenderOutput:
    if is_6dof:
        raise NotImplementedError(
            "6DoF deformation is not ported yet (ROADMAP.md, Queue 1: "
            "flagship / neural-ODE slice)")
    p = gaussians.params
    if direct_compute and isinstance(d_xyz, torch.Tensor) and d_xyz.ndim >= 2:
        means3d = d_xyz
    elif direct_compute:
        means3d = p.xyz
    else:
        means3d = p.xyz + d_xyz

    scales = gaussians.get_scaling * scaling_modifier + d_scaling
    rotations = gaussians.get_rotation + d_rotation
    opacity = gaussians.get_opacity[:, 0]

    if override_color is not None:
        colors = override_color
    else:
        dirs = means3d - camera.campos[None, :]
        dirs = dirs / torch.linalg.vector_norm(
            dirs, dim=-1, keepdim=True).clamp_min(1e-8)
        colors = eval_sh_upto(gaussians.max_sh_degree,
                              gaussians.active_sh_degree,
                              gaussians.get_features, dirs)
        colors = (colors + 0.5).clamp_min(0.0)

    if bg is None:
        bg = means3d.new_zeros(3)

    width, height = camera.width, camera.height
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE

    splats = project_gaussians(
        means3d, scales, rotations, opacity, colors,
        camera.viewmatrix, camera.projmatrix, camera.tanfovx,
        camera.tanfovy, width, height, antialias=antialias,
        alive=gaussians.alive)
    bins = bin_splats_records(splats, tiles_x=tiles_x, tiles_y=tiles_y,
                              dup_capacity=dup_capacity)
    image, depth, alpha = blend_records(
        pack_records(splats), bins, bg, tiles_x=tiles_x, tiles_y=tiles_y,
        width=width, height=height)
    return RenderOutput(image=image, depth=depth, alpha=alpha,
                        radii=splats.radii, counts=bins.counts)
