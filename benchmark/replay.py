"""The blend kernels timed again by CUDA events, launch after launch on
the inputs of one traced step or frame, rebuilt with the port's own
functions (the field, `project_splats`, `bin_splats_records`,
`pack_records`, `sorted_gids`, `blend_forward_cuda`). The per-layer
roofline metrics divide by the profiler's kernel times; these times are
what those are held against (PERF.md)."""
from __future__ import annotations

import torch

from d3gs_tpu_torch.models.renderer import project_splats
from d3gs_tpu_torch.ops import blend
from d3gs_tpu_torch.ops.binning import bin_splats_records
from d3gs_tpu_torch.ops.losses import l1_loss, ssim
from d3gs_tpu_torch.ops.projection import TILE
from d3gs_tpu_torch.ops.rasterize import pack_records

from . import program
from .timing import time_ms

REPS = 20


@torch.no_grad()
def _inputs(state, field, cams, pipe):
    xyz = state.params.xyz
    ode = program.is_ode(field)
    if ode:
        ys, _, _ = field.step_multi(xyz, sorted(float(c.fid) for c in cams),
                                    y0=xyz)
        deformed = [(ys[i], 0.0, 0.0) for i in range(len(cams))]
    else:
        deformed = [field.step(xyz, c.fid) for c in cams]
    for cam, (dx, dr, ds) in zip(cams, deformed):
        splats = project_splats(state, cam, d_xyz=dx, d_rotation=dr,
                                d_scaling=ds, direct_compute=ode)
        tx, ty = -(-cam.width // TILE), -(-cam.height // TILE)
        bins = bin_splats_records(splats, tiles_x=tx, tiles_y=ty,
                                  dup_capacity=pipe.dup_capacity)
        yield cam, pack_records(splats), bins, blend.sorted_gids(bins), tx, ty


def forward_s(state, field, cams, bg, pipe) -> list[float]:
    """Seconds per launch of the forward kernel, per camera."""
    out = []
    for cam, rec, bins, gid, tx, ty in _inputs(state, field, cams, pipe):
        fwd = blend.blend_forward_cuda(rec, bins, bg, tiles_x=tx, tiles_y=ty,
                                       width=cam.width, height=cam.height,
                                       gid=gid)
        out.append(1e-3 * time_ms(
            lambda: blend.launch(rec, gid, bins.starts, bg, fwd, tiles_x=tx,
                                 tiles_y=ty), REPS))
    return out


def backward_s(state, field, cams, bg, pipe, cfg: dict) -> list[float]:
    """Seconds per launch of the backward kernel, per camera, on the
    cotangent of that camera's share of the step's loss."""
    lam = cfg["optimization"]["lambda_dssim"]
    out = []
    for cam, rec, bins, gid, tx, ty in _inputs(state, field, cams, pipe):
        fwd = blend.blend_forward_cuda(rec, bins, bg, tiles_x=tx, tiles_y=ty,
                                       width=cam.width, height=cam.height,
                                       gid=gid)
        img = fwd.image.clone().requires_grad_()
        with torch.enable_grad():
            loss = ((1 - lam) * l1_loss(img, cam.image)
                    + lam * (1 - ssim(img, cam.image))) / len(cams)
            (g_img,) = torch.autograd.grad(loss, img)
        zero = torch.zeros_like(fwd.depth)
        grad = torch.zeros((rec.shape[0], rec.shape[1]), device=rec.device)
        out.append(1e-3 * time_ms(
            lambda: blend.launch_bwd(rec, gid, bins.starts, bg, fwd, g_img,
                                     zero, zero, grad, tiles_x=tx,
                                     tiles_y=ty, depth_grad=False), REPS))
    return out
