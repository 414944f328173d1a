"""The port as the harness drives it: its state, field, cameras and step
built from the benchmark's own tensors, through the port's public entry
points (`train/step.py::make_train_step`, `train/flagship.py::
make_batched_step` and `BatchPicker`, `models/deform` and
`models/renderer.py::render`).

The tests replace `make_step` or `render_frame` here to break the timed
path underneath a run."""
from __future__ import annotations

import random

import torch

import d3gs_tpu_torch.train.flagship as flagship
from d3gs_tpu_torch import config as C
from d3gs_tpu_torch.data.cameras import Camera
from d3gs_tpu_torch.models import gaussians as G
from d3gs_tpu_torch.models.deform.fields import (ODE_KINDS,
                                                 create_deform_field)
from d3gs_tpu_torch.models.renderer import render
from d3gs_tpu_torch.train.flagship import (BatchPicker, make_batched_step,
                                           pick_field_spec)
from d3gs_tpu_torch.train.baseline import subsample_stack
from d3gs_tpu_torch.train.step import make_train_step

from .scene import PARAM_NAMES


def configs(cfg: dict):
    """(ModelParams, OptimizationParams, PipelineParams) of a
    configuration file."""
    return (C.ModelParams(**cfg["model"]),
            C.OptimizationParams(**cfg["optimization"]),
            C.PipelineParams(dup_capacity=cfg["dup_capacity"]))


def gaussian_state(params: dict, alive: torch.Tensor, sh_degree: int,
                   spatial_lr_scale: float) -> G.GaussianState:
    """The trainers' state of the given parameters (cloned), all SH bands
    active, zero statistics and Adam moments."""
    p = G.GaussianParams(*(params[k].clone() for k in PARAM_NAMES))
    zeros = lambda: torch.zeros(alive.shape[0], device=alive.device)  # noqa
    z = lambda: G.GaussianParams(*(torch.zeros_like(x) for x in p))  # noqa
    return G.GaussianState(
        params=p, alive=alive.clone(), active_sh_degree=sh_degree,
        max_sh_degree=sh_degree, grad_accum=zeros(), denom=zeros(),
        max_radii2d=zeros(), opt=G.AdamState(z(), z(), 0),
        spatial_lr_scale=spatial_lr_scale)


def layers(field) -> list:
    """The field's nn.Linear layers in creation order."""
    return list(field.net.flax_layers().values())


def deform_field(model, opt, weights, device):
    """The trainers' field of the configuration, its weights set to the
    benchmark's (weight, bias) pairs, in creation order."""
    field = create_deform_field(pick_field_spec(model, opt), seed=0,
                                device=device, opt_cfg=opt)
    lins = layers(field)
    if len(lins) != len(weights):
        raise ValueError(f"field has {len(lins)} layers, the benchmark "
                         f"made {len(weights)}")
    with torch.no_grad():
        for lin, (w, b) in zip(lins, weights):
            if lin.weight.shape != w.shape or lin.bias.shape != b.shape:
                raise ValueError(f"layer {tuple(lin.weight.shape)} against "
                                 f"the benchmark's {tuple(w.shape)}")
            lin.weight.copy_(w)
            lin.bias.copy_(b)
    return field


def field_tensors(field) -> list[torch.Tensor]:
    """weight, bias of each layer, in creation order."""
    return [t for lin in layers(field) for t in (lin.weight, lin.bias)]


def field_moments(field, deform_state) -> list[torch.Tensor]:
    """The deform Adam's first moments, in `field_tensors` order."""
    index = {id(p): i for i, p in enumerate(field.net.parameters())}
    return [deform_state.m[index[id(t)]] for t in field_tensors(field)]


def camera(view, image: torch.Tensor) -> Camera:
    return Camera(viewmatrix=view.viewmatrix, projmatrix=view.projmatrix,
                  campos=view.campos, fid=view.fid, image=image,
                  width=view.width, height=view.height, fovx=view.fovx,
                  fovy=view.fovy)


def is_ode(field) -> bool:
    return field.spec.kind in ODE_KINDS


def make_step(cfg: dict, model, opt, pipe, field):
    """-> step(state, deform_state, cams, iteration, bg) -> (state,
    deform_state, StepAux, frames): the baseline trainer's step for
    cfg["trainer"] == "baseline" (one camera), the flagship's batched step
    otherwise. `frames` holds each rendered frame's per-tile duplicate
    counts (the binning's counter), which the flagship sums over its
    cameras in `StepAux.dup_total`: the budget is a frame's."""
    if cfg["trainer"] == "baseline":
        one = make_train_step(
            opt_cfg=opt, pipe_cfg=pipe,
            deform_fn=lambda xyz, fid, it, gen: field.step(xyz, fid),
            deform_params=list(field.net.parameters()),
            deform_update_fn=field.update)

        def baseline(state, ds, cams, it, bg):
            state, ds, aux = one(state, ds, cams[0], it, None, bg)
            return state, ds, aux, [aux.dup_total]
        return baseline
    batched = make_batched_step(opt_cfg=opt, pipe_cfg=pipe, model_cfg=model,
                                field=field, update_gaussians=True,
                                update_deform=True, use_deform=True)

    def step(state, ds, cams, it, bg):
        frames = []
        real = flagship.render

        def render(*args, **kwargs):
            out = real(*args, **kwargs)
            frames.append(out.counts)
            return out
        flagship.render = render
        try:
            state, ds, aux = batched(state, ds, cams, it, bg)
        finally:
            flagship.render = real
        return state, ds, aux, frames
    return step


def training_stack(cfg: dict, opt, views: list) -> list:
    """The views the trainer ever picks from: the baseline trainer's stack
    template and a `spread_out_sequence` flagship's stack are the views
    sorted by time and subsampled to `sequence_length`; otherwise all."""
    if cfg["trainer"] == "baseline" or opt.spread_out_sequence:
        return subsample_stack(views, opt.sequence_length)
    return sorted(views, key=lambda v: v.fid)


def picker(cfg: dict, opt, cams: list, seed: int):
    """-> pick() -> the next batch of cameras, sorted by time: the
    baseline trainer's draw without replacement from its stack (its
    `Random(seed)`), or the flagship's `BatchPicker`."""
    if cfg["trainer"] == "baseline":
        rng = random.Random(seed)
        stack: list = []

        def pick():
            if not stack:
                stack.extend(cams)
            return [stack.pop(rng.randint(0, len(stack) - 1))]
        return pick
    return BatchPicker(cams, k=opt.num_cams_per_iter,
                       sequence_length=opt.sequence_length,
                       spread_out=opt.spread_out_sequence, seed=seed)


@torch.no_grad()
def render_frame(state, field, cam, bg, pipe, events=None):
    """One viewer frame: the field at the camera's time (for the ODE kinds
    the integral from 0, rendered as absolute positions), then the render;
    with `events` (start, mid, end CUDA events) recorded around the two."""
    if events:
        events[0].record()
    dx, dr, ds = field.step(state.params.xyz, cam.fid)
    if events:
        events[1].record()
    out = render(state, cam, d_xyz=dx, d_rotation=dr, d_scaling=ds,
                 direct_compute=is_ode(field), bg=bg,
                 dup_capacity=pipe.dup_capacity)
    if events:
        events[2].record()
    return out
