"""Mask-consistency regularization of the SAM-variant trainer (counterpart
of `d3gs_tpu/train/sam_reg.py`, the reference train_baseline_sam.py).

Per training image a segmentation assigns the Gaussians, projected to
pixels with the camera's full transform (reference :79-99), to masks; for
every mask the variance of the deformation outputs (δx, δr, δs) over its
members is penalized (compute_mask_regularization :45-152, weight 0.5
:272): things on the same object should move rigidly.

Masks enter as a per-image int32 label map (H, W) with labels 1..num_masks
(0 = background / no mask), so membership is one gather and the per-mask
variances are segment sums (`index_add`). Membership is not differentiable
(the pixel index is an integer cast): the term's gradients reach only the
deformation outputs, as in JAX.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..data.image_io import read_label_png


def project_to_pixels(xyz: torch.Tensor, full_proj: torch.Tensor, width: int,
                      height: int):
    """Project points with the camera's full row-vector transform to pixel
    coordinates (reference train_baseline_sam.py:79-99). -> (px (N, 2)
    float, in_frame (N,) bool)."""
    n = xyz.shape[0]
    hom = torch.cat([xyz, xyz.new_ones((n, 1))], dim=1)
    p = hom @ full_proj
    w = p[:, 3:4]
    # a tiny negative w maps to +1e-7, as JAX's where(|w| < 1e-7, 1e-7, w)
    ndc = p[:, :3] / torch.where(w.abs() < 1e-7, torch.full_like(w, 1e-7), w)
    px = ((ndc[:, 0] + 1) * width - 1) * 0.5
    py = ((ndc[:, 1] + 1) * height - 1) * 0.5
    in_frame = ((w[:, 0] > 0) & (px >= 0) & (px < width) & (py >= 0)
                & (py < height))
    return torch.stack([px, py], dim=-1), in_frame


def _segment_sum(x: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    return x.new_zeros((num_segments,) + x.shape[1:]).index_add(0, seg, x)


def _masked_variance(values: torch.Tensor, seg_ids: torch.Tensor,
                     weights: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment variance of `values` (N, D) over the weighted members,
    summed over segments and dims (the reference sums torch.var over each
    mask's members and components). Segments with fewer than two members
    count 0. The order is JAX's, E[x²] − E[x]² in f32, clamped at 0."""
    w = weights
    cnt = _segment_sum(w, seg_ids, num_segments)                    # (S,)
    s1 = _segment_sum(values * w[:, None], seg_ids, num_segments)
    s2 = _segment_sum(values ** 2 * w[:, None], seg_ids, num_segments)
    safe = torch.clamp_min(cnt, 2.0)[:, None]
    mean = s1 / safe
    var = s2 / safe - mean ** 2
    valid = (cnt >= 2.0)[:, None]
    # torch.maximum splits a tie's gradient in halves, as jnp.maximum does
    var = torch.maximum(var, torch.zeros_like(var))
    return torch.where(valid, var, torch.zeros_like(var)).sum()


def mask_regularization(
    labels: torch.Tensor,       # (H, W) int32, 0 = unassigned
    num_masks: int,             # upper bound on the label values
    xyz: torch.Tensor,          # (N, 3) deformed positions
    full_proj: torch.Tensor,    # (4, 4)
    d_xyz, d_rotation, d_scaling,
    alive: torch.Tensor,
    width: int, height: int,
) -> torch.Tensor:
    """Σ_masks Σ_components var(deform outputs of the member Gaussians).
    Only tensor outputs with at least two dimensions count (a kind's scalar
    0.0 outputs are skipped, as in JAX)."""
    with torch.no_grad():       # no gradient crosses the integer cast
        px, in_frame = project_to_pixels(xyz.detach(), full_proj, width,
                                         height)
        # cast (toward zero), then clip, then gather: JAX's order
        xi = px[:, 0].to(torch.int32).clamp(0, width - 1)
        yi = px[:, 1].to(torch.int32).clamp(0, height - 1)
        seg = labels[yi.long(), xi.long()].long()
        member = in_frame & alive & (seg > 0)
        wgt = member.to(torch.float32)

    total = xyz.new_zeros(())
    for comp in (d_xyz, d_rotation, d_scaling):
        if torch.is_tensor(comp) and comp.dim() >= 2:
            vals = comp.reshape(comp.shape[0], -1)
            total = total + _masked_variance(vals, seg, wgt, num_masks + 1)
    return total


def load_label_maps(mask_dir: str, image_names: list[str],
                    num_masks: int = 64) -> dict[str, np.ndarray]:
    """Per-image precomputed label maps: <name>.npy int maps or <name>.png
    (palette indices, 8/16-bit gray, or channel 0 of RGB/RGBA, as JAX reads
    them through PIL). Labels are clipped to [0, num_masks]; images without
    a file are left out."""
    out = {}
    for name in image_names:
        npy = os.path.join(mask_dir, name + ".npy")
        png = os.path.join(mask_dir, name + ".png")
        if os.path.exists(npy):
            lab = np.load(npy)
        elif os.path.exists(png):
            lab = read_label_png(png).astype(np.int64)
        else:
            continue
        out[name] = np.clip(lab, 0, num_masks).astype(np.int32)
    return out


def grid_label_map(height: int, width: int, cells: int = 8) -> np.ndarray:
    """Fallback segmentation: a regular cells × cells grid of labels (a
    weak rigidity prior where no masks are available)."""
    ys = (np.arange(height)[:, None] * cells) // height
    xs = (np.arange(width)[None, :] * cells) // width
    return (ys * cells + xs + 1).astype(np.int32)
