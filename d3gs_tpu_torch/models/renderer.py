"""Renderer bridge: compose the deformation with the Gaussians and rasterize
(counterpart of `d3gs_tpu/models/renderer.py::render`, the reference's
gaussian_renderer/__init__.py::render()).

Compositions: additive (means = xyz + d_xyz, scales = exp(s)·mod + d_s,
rotations = normalize(q) + d_r, normalized again inside the projection),
direct (`direct_compute`: d_xyz are absolute positions, the ODE path) and
6DoF (`is_6dof`: d_xyz is a per-Gaussian (N, 4, 4) SE(3) applied to the
canonical means).
SH→RGB happens here per view direction. Then projection, binning, record
packing and the tile blend (the CUDA kernels on the card); `tight_cull`
drops, in the binning, the duplicates no pixel of their tile includes. The
whole path is
differentiable except the binning, which runs without autograd on the
detached splats (JAX's stop_gradient). `means2d_tap`, a zeros (C, 2) tensor
added to the projected centres, receives dL/dmean2d in pixel units: the
densification statistic (the reference's screenspace_points).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..data.cameras import Camera
from ..ops.binning import bin_splats_records
from ..ops.blend import blend_records
from ..ops.projection import TILE, ProjectedSplats, project_gaussians
from ..ops.rasterize import RenderOutput, pack_records
from ..ops.sh import eval_sh_upto
from ..ops.transforms import apply_se3
from .gaussians import GaussianState


def project_splats(
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
    antialias: bool = False,
    means2d_tap: Optional[torch.Tensor] = None,
) -> ProjectedSplats:
    """`render` up to the projection: the deformation composed with the
    Gaussians, SH to RGB, and the EWA projection of every row of
    `gaussians` (all of them, or one rank's rows in the gauss+tile layout
    of `parallel/sharded.py`), the tap added to the projected centres."""
    p = gaussians.params
    is_field = isinstance(d_xyz, torch.Tensor)
    if direct_compute:
        # a scalar 0.0 (warm-up) leaves the canonical means in place
        means3d = d_xyz if is_field and d_xyz.ndim >= 2 else p.xyz
    elif is_6dof and is_field and d_xyz.ndim == 3:
        means3d = apply_se3(d_xyz, p.xyz)
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

    splats = project_gaussians(
        means3d, scales, rotations, opacity, colors,
        camera.viewmatrix, camera.projmatrix, camera.tanfovx,
        camera.tanfovy, camera.width, camera.height, antialias=antialias,
        alive=gaussians.alive)
    if means2d_tap is not None:
        splats = splats._replace(means2d=splats.means2d + means2d_tap)
    return splats


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
    tight_cull: bool = False,
    means2d_tap: Optional[torch.Tensor] = None,
    depth_grad: bool = True,
) -> RenderOutput:
    splats = project_splats(
        gaussians, camera, d_xyz=d_xyz, d_rotation=d_rotation,
        d_scaling=d_scaling, is_6dof=is_6dof, direct_compute=direct_compute,
        scaling_modifier=scaling_modifier, override_color=override_color,
        antialias=antialias, means2d_tap=means2d_tap)
    if bg is None:
        bg = splats.means2d.new_zeros(3)
    width, height = camera.width, camera.height
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    with torch.no_grad():
        bins = bin_splats_records(splats, tiles_x=tiles_x, tiles_y=tiles_y,
                                  dup_capacity=dup_capacity,
                                  tight_cull=tight_cull)
    image, depth, alpha = blend_records(
        pack_records(splats), bins, bg, tiles_x=tiles_x, tiles_y=tiles_y,
        width=width, height=height, depth_grad=depth_grad)
    return RenderOutput(image=image, depth=depth, alpha=alpha,
                        radii=splats.radii, counts=bins.counts)
