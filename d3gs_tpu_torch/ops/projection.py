"""Per-Gaussian preprocessing: frustum cull, EWA projection, conic, tile bbox.

Counterpart of `d3gs_tpu/ops/projection.py` on the scales/rotations path the
renderer uses (the reference rasterizer's `preprocessCUDA`). Plain
elementwise torch over the N axis; conventions are the reference's:
  * view/proj matrices are ROW-VECTOR convention (x_row @ M);
  * frustum cull at view-space z <= 0.2;
  * +0.3 pixel dilation on the 2D covariance diagonal;
  * binning uses the alpha-aware radius min(3, sigma_exact)·σ, while `radii`
    reports the reference's 3σ radius.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .transforms import quat_to_rotmat_cols

TILE = 16  # pixels per tile side


class ProjectedSplats(NamedTuple):
    """Per-Gaussian screen-space quantities, all of length N."""
    means2d: torch.Tensor      # (N, 2) pixel coords
    depths: torch.Tensor       # (N,) view-space z
    conics: torch.Tensor       # (N, 3) inverse 2D covariance, packed (a, b, c)
    radii: torch.Tensor        # (N,) int32 reference 3σ radius, 0 => culled
    colors: torch.Tensor       # (N, 3) RGB
    opacities: torch.Tensor    # (N,) 0 where not visible
    tile_min: torch.Tensor     # (N, 2) int32 inclusive tile bbox min (x, y)
    tile_max: torch.Tensor     # (N, 2) int32 exclusive tile bbox max (x, y)
    visible: torch.Tensor      # (N,) bool
    cull_radius: torch.Tensor  # (N,) exact alpha radius in pixels


def ndc_to_pixel(ndc: torch.Tensor, size: int) -> torch.Tensor:
    """((ndc + 1)·S - 1) / 2, the reference rasterizer's pixel mapping."""
    return ((ndc + 1.0) * size - 1.0) * 0.5


def _tile_index(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 truncation toward zero, saturating like XLA's convert
    (NaN -> 0). Only Gaussians behind the camera reach the saturation, and
    they are culled either way."""
    return torch.nan_to_num(x, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31).long()


def _tile_rect(mx, my, rx, ry, tiles_x, tiles_y):
    """Tile bbox: min by int truncation, exclusive max by floor(...)+1,
    both clipped to the grid — as the JAX package rounds, so that bins
    agree at the left and top edges."""
    tmin_x = _tile_index((mx - rx) / TILE).clamp(0, tiles_x)
    tmin_y = _tile_index((my - ry) / TILE).clamp(0, tiles_y)
    tmax_x = (_tile_index(torch.floor((mx + rx) / TILE)) + 1).clamp(0, tiles_x)
    tmax_y = (_tile_index(torch.floor((my + ry) / TILE)) + 1).clamp(0, tiles_y)
    return tmin_x, tmin_y, tmax_x, tmax_y


def project_gaussians(
    means3d: torch.Tensor,      # (N, 3)
    scales: torch.Tensor,       # (N, 3) ACTIVATED scales
    rotations: torch.Tensor,    # (N, 4) quaternions (normalized inside)
    opacities: torch.Tensor,    # (N,)
    colors: torch.Tensor,       # (N, 3) precomputed RGB
    viewmatrix: torch.Tensor,   # (4, 4) row-vector convention
    projmatrix: torch.Tensor,   # (4, 4) full (view @ proj), row-vector
    tanfovx: float,
    tanfovy: float,
    width: int,
    height: int,
    *,
    antialias: bool = False,
    alive: torch.Tensor | None = None,   # (N,) bool padding mask
) -> ProjectedSplats:
    """EWA-project Gaussians to screen space.

    The 2D covariance comes from the factor A = T·R·diag(s) (2x3):
    a=|A₀|², c=|A₁|², b=A₀·A₁, and by Cauchy-Binet
        det_raw = Σ_{i<j} (A₀ᵢA₁ⱼ − A₀ⱼA₁ᵢ)²  (sum of squares, ≥ 0)
        det     = det_raw + 0.3·(a+c) + 0.09   (≥ 0.09 by construction),
    which does not cancel in f32 the way `a·c − b²` does for large splats."""
    focal_x = width / (2.0 * tanfovx)
    focal_y = height / (2.0 * tanfovy)

    hom = torch.cat([means3d, torch.ones_like(means3d[:, :1])], dim=-1)
    p_view = hom @ viewmatrix
    p_hom = hom @ projmatrix
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]

    tz = p_view[:, 2]
    in_front = tz > 0.2

    # EWA: clamp view-space x/y to 1.3·tanfov (limits Jacobian blowup)
    txtz = (p_view[:, 0] / tz).clamp(-1.3 * tanfovx, 1.3 * tanfovx)
    tytz = (p_view[:, 1] / tz).clamp(-1.3 * tanfovy, 1.3 * tanfovy)
    tx, ty = txtz * tz, tytz * tz

    safe_tz = torch.where(in_front, tz, torch.ones_like(tz))
    j00 = focal_x / safe_tz
    j11 = focal_y / safe_tz
    j02 = -focal_x * tx / (safe_tz * safe_tz)
    j12 = -focal_y * ty / (safe_tz * safe_tz)

    # T = J @ W, W the world→view rotation (column convention)
    Wr = viewmatrix[:3, :3].T
    t00 = j00 * Wr[0, 0] + j02 * Wr[2, 0]
    t01 = j00 * Wr[0, 1] + j02 * Wr[2, 1]
    t02 = j00 * Wr[0, 2] + j02 * Wr[2, 2]
    t10 = j11 * Wr[1, 0] + j12 * Wr[2, 0]
    t11 = j11 * Wr[1, 1] + j12 * Wr[2, 1]
    t12 = j11 * Wr[1, 2] + j12 * Wr[2, 2]

    r00, r01, r02, r10, r11, r12, r20, r21, r22 = quat_to_rotmat_cols(rotations)
    s0, s1, s2 = scales.unbind(-1)
    # A = T R diag(s); A[i,j] = (tᵢ · R[:,j]) sⱼ
    a0 = (t00 * r00 + t01 * r10 + t02 * r20) * s0
    a1 = (t00 * r01 + t01 * r11 + t02 * r21) * s1
    a2 = (t00 * r02 + t01 * r12 + t02 * r22) * s2
    c0 = (t10 * r00 + t11 * r10 + t12 * r20) * s0
    c1 = (t10 * r01 + t11 * r11 + t12 * r21) * s1
    c2 = (t10 * r02 + t11 * r12 + t12 * r22) * s2
    a_raw = a0 * a0 + a1 * a1 + a2 * a2
    c_raw = c0 * c0 + c1 * c1 + c2 * c2
    b = a0 * c0 + a1 * c1 + a2 * c2
    m01 = a0 * c1 - a1 * c0
    m02 = a0 * c2 - a2 * c0
    m12 = a1 * c2 - a2 * c1
    det_raw = m01 * m01 + m02 * m02 + m12 * m12
    a, c = a_raw + 0.3, c_raw + 0.3
    det = det_raw + 0.3 * (a_raw + c_raw) + 0.09
    det_ok = det > 0.0
    inv_det = 1.0 / det
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    if antialias:
        opacities = opacities * torch.sqrt(det_raw.clamp_min(0.0) * inv_det)

    # alpha-aware radius: beyond σ·sqrt(2·ln(255·opa)) alpha < 1/255 at every
    # pixel, so the shrink is output-exact; `radii` keeps the 3σ radius
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt((mid * mid - det).clamp_min(0.1))
    sig = torch.sqrt(lam1)
    sigma_exact = torch.sqrt((2.0 * torch.log(
        opacities.clamp_min(1e-30) * 255.0)).clamp_min(0.0))
    radius = torch.ceil(sigma_exact.clamp_max(3.0) * sig)
    cull_radius = sigma_exact * sig
    # per-axis extents: columns beyond sigma_exact·sqrt(a) (rows: sqrt(c))
    # see alpha < 1/255 everywhere; clamped to the circle radius
    rx = torch.minimum(radius, torch.ceil(sigma_exact * torch.sqrt(a)))
    ry = torch.minimum(radius, torch.ceil(sigma_exact * torch.sqrt(c)))
    radius3 = torch.ceil(3.0 * sig)

    mean2d = torch.stack([ndc_to_pixel(p_proj[:, 0], width),
                          ndc_to_pixel(p_proj[:, 1], height)], dim=-1)

    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    mx, my = mean2d[:, 0], mean2d[:, 1]
    tmin_x, tmin_y, tmax_x, tmax_y = _tile_rect(mx, my, rx, ry,
                                                tiles_x, tiles_y)
    visible = (in_front & det_ok & (tmax_x > tmin_x) & (tmax_y > tmin_y)
               & (radius > 0))
    n3min_x, n3min_y, n3max_x, n3max_y = _tile_rect(mx, my, radius3, radius3,
                                                    tiles_x, tiles_y)
    vis_stats = (in_front & det_ok & (radius3 > 0)
                 & (n3max_x > n3min_x) & (n3max_y > n3min_y))
    if alive is not None:
        visible = visible & alive
        vis_stats = vis_stats & alive
    zero = torch.zeros_like(opacities)
    return ProjectedSplats(
        means2d=mean2d,
        depths=tz,
        conics=conic,
        radii=torch.where(vis_stats, radius3, zero).to(torch.int32),
        colors=colors,
        opacities=torch.where(visible, opacities, zero),
        tile_min=torch.stack([tmin_x, tmin_y], dim=-1).to(torch.int32),
        tile_max=torch.stack([tmax_x, tmax_y], dim=-1).to(torch.int32),
        visible=visible,
        cull_radius=torch.where(visible, cull_radius, zero),
    )
