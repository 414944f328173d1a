"""The train step shared by the trainers (counterpart of
`d3gs_tpu/train/step.py`).

One step: deform MLP forward → render (projection, binning, the blend
kernel) → (1−λ)·L1 + λ·(1−SSIM) → one backward (`torch.autograd.grad` over
the six Gaussian parameters, the deform parameters and the screen-space tap)
→ masked Gaussian Adam with the scheduled learning rates → deform Adam →
densification statistics. Densify, opacity reset and the SH ramp run on the
host cadence through `densify_fns`. The warm-up phase is the same step
without a deformation (reference train.py:144,224-236).

The deformation enters through
    deform_fn(xyz, fid, iteration, generator) -> (dx, dr, ds)
differentiable in `deform_params`; xyz is detached, as the JAX step feeds
the MLP stop_gradient(xyz). A regularizer enters through
    extra_loss_fn(out, (dx, dr, ds), camera, state, aux_data) -> scalar
added to the photometric loss before the backward (the SAM-variant
trainer's mask consistency); `state` carries the live parameters the
gradients are taken with, `aux_data` is its per-camera side input.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from .. import tracing
from ..data.cameras import Camera
from ..models import gaussians as G
from ..models.renderer import render
from ..ops.losses import l1_loss, ssim


class StepAux(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    radii: torch.Tensor
    tile_overflow: torch.Tensor   # largest per-tile count (diagnostics)
    dup_total: torch.Tensor       # surviving tile duplicates


class StepGrads(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    params: G.GaussianParams      # d loss / d the six Gaussian parameters
    deform: list                  # d loss / d deform_params
    tap: torch.Tensor             # (C, 2) d loss / d mean2d, pixel units
    out: object                   # the RenderOutput


def make_loss_and_grads(*, opt_cfg, pipe_cfg, is_6dof: bool = False,
                        deform_fn: Optional[Callable] = None,
                        deform_params: Sequence[torch.Tensor] = (),
                        extra_loss_fn: Optional[Callable] = None):
    """-> loss_and_grads(state, camera, iteration, generator, bg,
    aux_data=None) -> StepGrads: the forward and the one backward of a
    train step."""
    lam = opt_cfg.lambda_dssim
    depth_grad = pipe_cfg.depth_grad
    deform_params = list(deform_params)

    def loss_and_grads(state: G.GaussianState, camera: Camera, iteration,
                       generator, bg, aux_data=None) -> StepGrads:
        params = G.GaussianParams(*(p.detach().requires_grad_()
                                    for p in state.params))
        st = dataclasses.replace(state, params=params)
        tap = torch.zeros((state.capacity, 2), device=bg.device,
                          requires_grad=True)
        if deform_fn is not None:
            dx, dr, ds = deform_fn(params.xyz.detach(), camera.fid,
                                   iteration, generator)
        else:
            dx, dr, ds = 0.0, 0.0, 0.0
        out = render(st, camera,
                     d_xyz=dx, d_rotation=dr, d_scaling=ds, is_6dof=is_6dof,
                     bg=bg, means2d_tap=tap, dup_capacity=pipe_cfg.dup_capacity,
                     tight_cull=pipe_cfg.tight_cull,
                     antialias=pipe_cfg.antialias, depth_grad=depth_grad)
        with tracing.span("loss"):
            ll1 = l1_loss(out.image, camera.image)
            loss = ((1.0 - lam) * ll1
                    + lam * (1.0 - ssim(out.image, camera.image)))
            if extra_loss_fn is not None:
                loss = loss + extra_loss_fn(out, (dx, dr, ds), camera, st,
                                            aux_data)
        inputs = [*params, *deform_params, tap]
        with tracing.span("backward"):
            if tracing.enabled():
                mark_field_backward(dx)
            grads = torch.autograd.grad(loss, inputs, allow_unused=True,
                                        materialize_grads=True)
        n = len(params)
        return StepGrads(loss=loss.detach(), l1=ll1.detach(),
                         params=G.GaussianParams(*grads[:n]),
                         deform=list(grads[n:-1]), tap=grads[-1], out=out)

    return loss_and_grads


def make_train_step(*, opt_cfg, pipe_cfg, is_6dof: bool = False,
                    deform_fn: Optional[Callable] = None,
                    deform_params: Sequence[torch.Tensor] = (),
                    deform_update_fn: Optional[Callable] = None,
                    extra_loss_fn: Optional[Callable] = None):
    """-> step(state, deform_state, camera, iteration, generator, bg,
    aux_data=None) -> (state, deform_state, StepAux). Pass deform_fn=None
    for the warm-up phase; deform_update_fn(deform_state, grads, iteration)
    steps the deform parameters and returns the new deform_state;
    `extra_loss_fn` and `aux_data` as in `make_loss_and_grads`."""
    loss_and_grads = make_loss_and_grads(
        opt_cfg=opt_cfg, pipe_cfg=pipe_cfg, is_6dof=is_6dof,
        deform_fn=deform_fn, deform_params=deform_params,
        extra_loss_fn=extra_loss_fn)

    def step(state: G.GaussianState, deform_state, camera: Camera, iteration,
             generator, bg, aux_data=None):
        with tracing.span("train.step", iteration=iteration, cameras=1,
                          gaussians=state.capacity):
            r = loss_and_grads(state, camera, iteration, generator, bg,
                               aux_data)
            with torch.no_grad(), tracing.span("adam"):
                with tracing.span("adam.gaussians"):
                    lrs = G.group_learning_rates(opt_cfg, iteration,
                                                 state.spatial_lr_scale)
                    params, opt = G.adam_step(state.params, r.params,
                                              state.opt, lrs,
                                              mask=state.alive)
                    state = G.add_densification_stats(
                        dataclasses.replace(state, params=params, opt=opt),
                        r.tap, r.out.radii)
                if deform_fn is not None and deform_update_fn is not None:
                    with tracing.span("adam.deform"):
                        deform_state = deform_update_fn(
                            deform_state, r.deform, iteration)
            counts = r.out.counts
            aux = StepAux(loss=r.loss, l1=r.l1, radii=r.out.radii,
                          tile_overflow=counts.max(), dup_total=counts.sum())
            return state, deform_state, aux

    return step


def mark_field_backward(out) -> None:
    """Open the span `backward.deform` under the running `backward` when
    autograd has the whole gradient of the field's output `out` (a hook
    that leaves the gradient as it is): from there on the backward runs
    through the field (an ODE's recompute and vector-Jacobian products).
    Nothing for an output without a gradient."""
    if isinstance(out, torch.Tensor) and out.requires_grad:
        out.register_hook(lambda g: tracing.mark("backward.deform"))


def make_eval_render(*, pipe_cfg, is_6dof: bool = False,
                     direct_compute: bool = False,
                     deform_fn: Optional[Callable] = None):
    """No-grad render for the PSNR evaluation (training_report semantics,
    train.py:355-422): the deformation without time noise;
    `direct_compute` renders it as absolute positions (the ODE kinds)."""

    @torch.no_grad()
    def eval_render(state: G.GaussianState, use_deform: bool,
                    camera: Camera, bg):
        if deform_fn is not None and use_deform:
            dx, dr, ds = deform_fn(state.params.xyz, camera.fid, 10 ** 9,
                                   None)
        else:
            dx, dr, ds = 0.0, 0.0, 0.0
        return render(state, camera, d_xyz=dx, d_rotation=dr, d_scaling=ds,
                      is_6dof=is_6dof, direct_compute=direct_compute,
                      bg=bg, dup_capacity=pipe_cfg.dup_capacity,
                      tight_cull=pipe_cfg.tight_cull,
                      antialias=pipe_cfg.antialias)

    return eval_render


def densify_fns(opt_cfg):
    """-> (densify(state, generator, max_screen_size, extent), reset_opacity,
    oneup_sh_degree) with the config baked in."""

    def densify(state, generator, max_screen_size, extent, noise=None):
        return G.densify_and_prune(
            state, max_grad=opt_cfg.densify_grad_threshold, min_opacity=0.005,
            extent=extent, max_screen_size=max_screen_size,
            percent_dense=opt_cfg.percent_dense, noise=noise,
            generator=generator)

    return densify, G.reset_opacity, G.oneup_sh_degree
