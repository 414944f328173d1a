"""Sharded render and train steps over a `Mesh` (counterpart of
`d3gs_tpu/parallel/sharded.py`). Every function here runs on every rank of
the mesh, in the same order: the collectives of `comm` pair up across
ranks.

  * `make_sharded_render`: project this rank's Gaussian rows, all-gather
    them as packed records, bin and blend this rank's strip of tile rows
    (the blend kernels at `tile_y0 = shard_rank · tiles_y_local`), gather
    the strips into the frame;
  * `make_sharded_train_step`: the baseline step on that render;
  * `make_flagship_camera_parallel_step`: parameters replicated, the
    camera batch split, one gradient all-reduce;
  * `make_flagship_gauss_tile_step`: Gaussians and tile rows sharded, per
    camera one all-gather of the packed records, the loss on strips with
    halo rows; on a 2D mesh the camera batch also splits over the camera
    groups.

The strips are `strip_h = ceil(tiles_y / S) · 16` rows each; they
concatenate to `S · strip_h` rows, cropped to `height`. Rows past `height`
on the last strips are blended and then masked out of the loss.

Gradients of parameters that every rank holds (all of them in the camera
layout, the deform net's in both) are summed once, by an all-reduce after
the backward; the collectives inside the graph (`comm.psum`,
`comm.gather_replicated`) pass the gradient through without summing it
again, so no rank's share counts twice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..data.cameras import Camera
from ..models import gaussians as G
from ..models.deform.fields import MLP_KINDS, ODE_KINDS
from ..models.renderer import project_splats
from ..ops.binning import bin_splats_records
from ..ops.blend import blend_records
from ..ops.losses import l1_loss, ssim, ssim_map
from ..ops.projection import TILE, project_gaussians
from ..ops.rasterize import pack_records_full, unpack_records_full
from ..train.flagship import (BatchGrads, apply_updates,
                              make_batched_loss_and_grads)
from . import comm
from .mesh import Mesh

SSIM_HALO = 11 // 2      # the SSIM window's half-width


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class StripGrid(NamedTuple):
    tiles_x: int
    tiles_y: int        # tile rows of one strip
    strip_h: int        # its pixel rows
    tile_y0: int        # this rank's first tile row


def strip_grid(width: int, height: int, mesh: Mesh) -> StripGrid:
    tiles_y = _cdiv(_cdiv(height, TILE), mesh.shard)
    return StripGrid(tiles_x=_cdiv(width, TILE), tiles_y=tiles_y,
                     strip_h=tiles_y * TILE,
                     tile_y0=mesh.shard_rank * tiles_y)


def blend_strip(records: torch.Tensor, bg: torch.Tensor, grid: StripGrid, *,
                width: int, dup_capacity: int = 0, depth_grad: bool = True,
                tight_cull: bool = False):
    """Bin and blend this rank's strip from the gathered (N, 16) records of
    `pack_records_full` -> (image (strip_h, W, 3), depth, alpha, counts).
    The records carry the means, conics and opacity `tight_cull` reads."""
    with torch.no_grad():
        bins = bin_splats_records(
            unpack_records_full(records.detach()), tiles_x=grid.tiles_x,
            tiles_y=grid.tiles_y, dup_capacity=dup_capacity,
            tile_y0=grid.tile_y0, tight_cull=tight_cull)
    img, dep, alp = blend_records(
        records, bins, bg, tiles_x=grid.tiles_x, tiles_y=grid.tiles_y,
        width=width, height=grid.strip_h, depth_grad=depth_grad,
        tile_y0=grid.tile_y0)
    return img, dep, alp, bins.counts


def make_frame_fn(mesh: Mesh, *, width: int, height: int, pipe_cfg):
    """-> frame_fn(splats, bg) -> (image (H, W, 3), depth (H, W), alpha
    (H, W), counts): this rank's projected rows all-gathered as packed
    records, its strip binned and blended, the strips gathered into the
    whole frame on every rank (counts: its strip's tiles')."""
    grid = strip_grid(width, height, mesh)

    def frame_fn(splats, bg):
        records = comm.all_gather(pack_records_full(splats),
                                  mesh.shard_group)
        img, dep, alp, counts = blend_strip(
            records, bg, grid, width=width,
            dup_capacity=pipe_cfg.dup_capacity,
            depth_grad=pipe_cfg.depth_grad, tight_cull=pipe_cfg.tight_cull)
        strip = torch.cat([img, dep[..., None], alp[..., None]], dim=-1)
        frame = comm.gather_replicated(strip, mesh.shard_group)[:height]
        return frame[..., :3], frame[..., 3], frame[..., 4], counts

    return frame_fn


def make_sharded_render(mesh: Mesh, *, width: int, height: int, pipe_cfg):
    """-> render_fn(means3d, scales, rotations, colors, opacities, alive,
    camera, bg, means2d_tap) -> (image (H, W, 3), depth (H, W), alpha
    (H, W), radii, counts), the JAX function's signature. The per-Gaussian
    inputs are this rank's rows; the image, depth and alpha are the whole
    frame on every rank; radii are this rank's rows', counts its strip's
    tiles'."""
    frame_fn = make_frame_fn(mesh, width=width, height=height,
                             pipe_cfg=pipe_cfg)

    def render_fn(means3d, scales, rotations, colors, opacities, alive,
                  camera: Camera, bg, means2d_tap):
        splats = project_gaussians(
            means3d, scales, rotations, opacities, colors, camera.viewmatrix,
            camera.projmatrix, camera.tanfovx, camera.tanfovy, width, height,
            antialias=pipe_cfg.antialias, alive=alive)
        splats = splats._replace(means2d=splats.means2d + means2d_tap)
        img, dep, alp, counts = frame_fn(splats, bg)
        return img, dep, alp, splats.radii, counts

    return render_fn


class ShardedAux(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    radii: torch.Tensor


def _leaf_params(state: G.GaussianState):
    """Fresh leaves of the parameters, and the state that holds them."""
    params = G.GaussianParams(*(p.detach().requires_grad_()
                                for p in state.params))
    return params, dataclasses.replace(state, params=params)


def make_sharded_train_step(mesh: Mesh, *, opt_cfg, pipe_cfg, width: int,
                            height: int, field=None, is_6dof: bool = False,
                            direct_compute: bool = False):
    """-> step(state, deform_state, camera, iteration, bg) -> (state,
    deform_state, ShardedAux): the baseline train step (`train/step.py`)
    with the state sharded over the mesh's rows and the sharded render;
    the deform gradients are all-reduced over every rank."""
    frame_fn = make_frame_fn(mesh, width=width, height=height,
                             pipe_cfg=pipe_cfg)
    lam = opt_cfg.lambda_dssim
    deform_params = list(field.net.parameters()) if field is not None else []

    def step(state: G.GaussianState, deform_state, camera: Camera,
             iteration, bg):
        params, st = _leaf_params(state)
        tap = torch.zeros((state.capacity, 2), device=bg.device,
                          requires_grad=True)
        if field is not None:
            dx, dr, ds = field.step(params.xyz.detach(), camera.fid)
        else:
            dx, dr, ds = 0.0, 0.0, 0.0
        splats = project_splats(
            st, camera, d_xyz=dx, d_rotation=dr, d_scaling=ds,
            is_6dof=is_6dof, direct_compute=direct_compute,
            antialias=pipe_cfg.antialias, means2d_tap=tap)
        img, _, _, counts = frame_fn(splats, bg)
        radii = splats.radii
        ll1 = l1_loss(img, camera.image)
        loss = (1.0 - lam) * ll1 + lam * (1.0 - ssim(img, camera.image))
        grads = torch.autograd.grad(loss, [*params, *deform_params, tap],
                                    allow_unused=True, materialize_grads=True)
        n = len(params)
        d_grads = list(grads[n:-1])
        comm.all_reduce_(d_grads)
        r = BatchGrads(loss=loss.detach(), l1=ll1.detach(),
                       params=G.GaussianParams(*grads[:n]), deform=d_grads,
                       tap=grads[-1], radii=radii, tile_overflow=counts.max(),
                       dup_total=counts.sum())
        state, deform_state, _ = apply_updates(
            state, deform_state, r, iteration, opt_cfg=opt_cfg, field=field,
            update_gaussians=True, update_deform=field is not None)
        return state, deform_state, ShardedAux(loss=r.loss, l1=r.l1,
                                               radii=radii)

    return step


def _split(items: list, parts: int, index: int) -> list:
    """The `index`-th of `parts` equal contiguous blocks of `items`."""
    if len(items) % parts:
        raise ValueError(f"{len(items)} cameras do not split over {parts} "
                         f"ranks: pad the batch (BatchPicker(pad_to=...))")
    n = len(items) // parts
    return items[index * n:(index + 1) * n]


def make_flagship_camera_parallel_step(
        mesh: Mesh, *, opt_cfg, pipe_cfg, model_cfg, field,
        use_deform: bool = True, update_gaussians: bool = True,
        update_deform: bool = True):
    """-> step(state, deform_state, cams, iteration, bg, wts=None) ->
    (state, deform_state, StepAux): the flagship step with the Gaussians
    and the deform net replicated and the (fid-sorted) camera batch split
    into contiguous blocks of k / D, one per rank. Each rank takes the
    single-device forward and backward of its cameras with the loss
    divided by the whole batch's weight sum; then one all-reduce sums the
    Gaussian, deform and tap gradients, and the radii and tile counts are
    max-reduced, so every rank takes the same Adam step. The ODE kinds
    integrate each rank's window from its own first fid, as the JAX step
    does."""
    loss_and_grads = make_batched_loss_and_grads(
        opt_cfg=opt_cfg, pipe_cfg=pipe_cfg, model_cfg=model_cfg,
        field=field, use_deform=use_deform)

    def step(state: G.GaussianState, deform_state, cams: list[Camera],
             iteration, bg, wts=None):
        w = [1.0] * len(cams) if wts is None else [float(x) for x in wts]
        mine = _split(list(range(len(cams))), mesh.size, mesh.rank)
        r = loss_and_grads(state, [cams[i] for i in mine], bg,
                           [w[i] for i in mine], wsum=sum(w))
        grads = [g.contiguous() for g in (*r.params, *r.deform, r.tap)]
        comm.all_reduce_(grads)
        n, nd = len(r.params), len(r.deform)
        sums = comm.psum(torch.stack([r.loss, r.l1.to(r.loss.dtype),
                                      r.dup_total.to(r.loss.dtype)]))
        maxes = comm.pmax(torch.cat([r.radii.int(),
                                     r.tile_overflow.int().reshape(1)]))
        r = BatchGrads(loss=sums[0], l1=sums[1],
                       params=G.GaussianParams(*grads[:n]),
                       deform=grads[n:n + nd], tap=grads[-1],
                       radii=maxes[:-1], tile_overflow=maxes[-1],
                       dup_total=sums[2])
        return apply_updates(state, deform_state, r, iteration,
                             opt_cfg=opt_cfg, field=field,
                             update_gaussians=update_gaussians,
                             update_deform=update_deform)

    return step


def make_flagship_gauss_tile_step(
        mesh: Mesh, *, opt_cfg, pipe_cfg, model_cfg, field, width: int,
        height: int, use_deform: bool = True, update_gaussians: bool = True,
        update_deform: bool = True):
    """-> step(state, deform_state, cams, iteration, bg, wts=None) ->
    (state, deform_state, StepAux) with `state` this rank's rows
    (`shard_gaussian_state`). Per camera of this rank's camera group (all
    k on a 1D mesh, a contiguous k / C block on a (C x S) mesh): the
    deformation and projection of the local rows, one all-gather of their
    packed records over the row, the binning and blend of this rank's
    strip. The loss is summed strip by strip: each strip is extended by
    SSIM_HALO rows of its neighbours' render (zeros beyond the outer
    strips: the blur's zero padding) and of the ground truth, which every
    rank holds whole, and the rows past `height` are masked; the per-camera
    partial sums are psum'd over the row. The backward's reduce-scatter
    returns each rank its rows' record gradients from every strip. On a
    2D mesh the Gaussian and tap gradients are then summed over the
    column and the radii max-reduced there; the deform gradients are
    summed over every rank. Any k works on a 1D mesh; on a 2D one k must
    divide by C."""
    grid = strip_grid(width, height, mesh)
    if grid.strip_h < SSIM_HALO:
        raise ValueError(f"image strips of {grid.strip_h} rows are thinner "
                         f"than the SSIM halo ({SSIM_HALO}); use fewer ranks "
                         f"for {height}-row images")
    lam = opt_cfg.lambda_dssim
    kind = field.spec.kind
    direct = opt_cfg.direct_compute and kind in ODE_KINDS and use_deform
    per_camera = use_deform and kind in MLP_KINDS
    deform_params = list(field.net.parameters()) if use_deform else []
    up, down = mesh.neighbours()
    rows = mesh.shard_rank * grid.strip_h + torch.arange(grid.strip_h)
    npix = float(height * width * 3)

    def strip_losses(imgs, cams):
        """-> (k, 2) per-camera [Σ |im - gt|, Σ ssim] over this strip."""
        dev = imgs.device
        rmask = (rows < height).to(dev, imgs.dtype)[None, :, None, None]
        im = imgs * rmask
        # the ground truth of the strip and its halo rows, zero past the
        # image's rows and beyond the outer strips
        y0, h = mesh.shard_rank * grid.strip_h, SSIM_HALO
        full = torch.stack([c.image for c in cams])
        pad = full.new_zeros((full.shape[0], h, width, 3))
        tall = torch.cat([pad, full, pad.new_zeros(
            (full.shape[0], grid.strip_h * mesh.shard - height + h,
             width, 3))], dim=1)
        gte = tall[:, y0:y0 + grid.strip_h + 2 * h]
        gt = gte[:, h:h + grid.strip_h]
        top, bottom = comm.halo_rows(im, h, up, down)
        ime = torch.cat([top, im, bottom], dim=1)
        sums = []
        for c in range(im.shape[0]):
            m = ssim_map(ime[c], gte[c])[h:-h]
            sums.append(torch.stack([(im[c] - gt[c]).abs().sum(),
                                     (m * rmask[0]).sum()]))
        return torch.stack(sums)

    def step(state: G.GaussianState, deform_state, cams: list[Camera],
             iteration, bg, wts=None):
        w_all = [1.0] * len(cams) if wts is None else [float(x) for x in wts]
        mine = _split(list(range(len(cams))), mesh.cam, mesh.cam_rank)
        cams_l = [cams[i] for i in mine]
        w = [w_all[i] for i in mine]
        params, st = _leaf_params(state)
        tap = torch.zeros((state.capacity, 2), device=bg.device,
                          requires_grad=True)
        xyz = params.xyz.detach()
        if use_deform and not per_camera:
            staged = field.step_multi(xyz, sorted(float(c.fid)
                                                  for c in cams_l), y0=xyz)
        imgs, radii, top, dups = [], None, None, 0
        for i, cam in enumerate(cams_l):
            if per_camera:
                dx, dr, ds = field.step(xyz, cam.fid)
            elif use_deform:
                dx, dr, ds = (s[i] for s in staged)
            else:
                dx, dr, ds = 0.0, 0.0, 0.0
            splats = project_splats(
                st, cam, d_xyz=dx, d_rotation=dr, d_scaling=ds,
                is_6dof=model_cfg.is_6dof, direct_compute=direct,
                antialias=pipe_cfg.antialias, means2d_tap=tap)
            records = comm.all_gather(pack_records_full(splats),
                                      mesh.shard_group)
            img, _, _, counts = blend_strip(
                records, bg, grid, width=width,
                dup_capacity=pipe_cfg.dup_capacity,
                depth_grad=pipe_cfg.depth_grad,
                tight_cull=pipe_cfg.tight_cull)
            imgs.append(img)
            radii = splats.radii if radii is None else torch.maximum(
                radii, splats.radii)
            top = counts.max() if top is None else torch.maximum(
                top, counts.max())
            dups = dups + counts.sum()
        sums = comm.psum(strip_losses(torch.stack(imgs), cams_l),
                         mesh.shard_group) / npix
        losses = (1.0 - lam) * sums[:, 0] + lam * (1.0 - sums[:, 1])
        wt = torch.tensor(w, dtype=losses.dtype, device=losses.device)
        wsum = sum(w_all)
        loss = (wt * losses).sum() / wsum
        grads = torch.autograd.grad(loss, [*params, *deform_params, tap],
                                    allow_unused=True, materialize_grads=True)
        n = len(params)
        g_rows = [g.contiguous() for g in (*grads[:n], grads[-1])]
        d_grads = [g.contiguous() for g in grads[n:-1]]
        scal = torch.stack([loss.detach(),
                            (wt * sums[:, 0].detach()).sum() / wsum])
        if mesh.cam > 1:
            # the camera groups' shares of the rows' gradients and of the
            # loss; the rows' largest radius over every camera
            comm.all_reduce_(g_rows, mesh.cam_group)
            radii = comm.pmax(radii, mesh.cam_group)
            scal = comm.psum(scal, mesh.cam_group)
        comm.all_reduce_(d_grads)
        counts = comm.pmax(top.reshape(1))[0], comm.psum(
            dups.reshape(1))[0]
        r = BatchGrads(loss=scal[0], l1=scal[1],
                       params=G.GaussianParams(*g_rows[:n]), deform=d_grads,
                       tap=g_rows[-1], radii=radii, tile_overflow=counts[0],
                       dup_total=counts[1])
        return apply_updates(state, deform_state, r, iteration,
                             opt_cfg=opt_cfg, field=field,
                             update_gaussians=update_gaussians,
                             update_deform=update_deform and use_deform)

    return step
