"""The paper-faithful deformable-3DGS training loop (counterpart of
`d3gs_tpu/train/baseline.py`, the reference's train_baseline.py:34-208).

One random camera per iteration from a time-sorted, uniformly subsampled
`sequence_length` stack (stdlib `random.Random(seed)`, so both packages pick
the same cameras), a static warm-up before `warm_up`, AST time noise for
non-Blender scenes, the SH ramp every 1000 iterations, and, after each
step, report → save → densify / prune / opacity reset on the host cadence,
with the padded buffer grown when densification fills 90 % of it.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field as dfield
from random import Random

import numpy as np
import torch

from ..config import ModelParams, OptimizationParams, PipelineParams
from ..data.cameras import Camera
from ..data.scene import save_gaussians_ply
from ..models import gaussians as G
from ..models.deform.fields import (DeformFieldSpec, create_deform_field,
                                    save_deform_weights)
from ..ops.losses import psnr
from ..ops.schedules import linear_noise
from .step import densify_fns, make_eval_render, make_train_step


@dataclass
class TrainResult:
    state: G.GaussianState
    field: object
    deform_state: object
    best_psnr: float = 0.0
    best_iteration: int = 0
    losses: list = dfield(default_factory=list)
    test_psnrs: dict = dfield(default_factory=dict)
    densify_events: list = dfield(default_factory=list)


def subsample_stack(cams: list[Camera], sequence_length: int) -> list[Camera]:
    """Time-sort then uniformly subsample to sequence_length
    (train_baseline.py:81-90)."""
    stack = sorted(cams, key=lambda c: float(c.fid))
    total = len(stack)
    if sequence_length >= total or sequence_length <= 0:
        return stack
    if sequence_length == 1:
        return [stack[0]]
    step = (total - 1) / (sequence_length - 1)
    return [stack[int(round(i * step))] for i in range(sequence_length)]


def train_baseline(
    *,
    gaussians: G.GaussianState,
    train_cams: list[Camera],
    test_cams: list[Camera],
    cameras_extent: float,
    model_cfg: ModelParams,
    opt_cfg: OptimizationParams,
    pipe_cfg: PipelineParams,
    test_iterations=(),
    save_iterations=(),
    model_path: str = "",
    seed: int = 0,
    log_every: int = 50,
    tb_writer=None,
    progress: bool = True,
    live_hook=None,
) -> TrainResult:
    """Train `gaussians` and a fresh deform field (torch.Generator(seed)
    for its weights, the AST noise and the split noise). `tb_writer` and
    `live_hook` are not ported and raise if set."""
    if tb_writer is not None or live_hook is not None:
        raise NotImplementedError(
            "tb_writer / live_hook (tensorboard, viewer) are not ported "
            "(ROADMAP.md, Queue 1: side trainers and tools)")
    rng = Random(seed)
    dev = gaussians.alive.device
    gen = torch.Generator().manual_seed(seed)

    spec = DeformFieldSpec(kind="baseline", is_blender=model_cfg.is_blender,
                           is_6dof=model_cfg.is_6dof, D=model_cfg.D,
                           W=model_cfg.W, multires=model_cfg.multires,
                           compute_dtype=model_cfg.deform_dtype)
    field = create_deform_field(spec, seed=seed, device=dev, opt_cfg=opt_cfg)
    deform_state = field.init_state()
    bg = torch.full((3,), 1.0 if model_cfg.white_background else 0.0,
                    device=dev)

    stack_template = subsample_stack(train_cams, opt_cfg.sequence_length)
    time_interval = 1.0 / max(len(stack_template), 1)

    def deform_fn(xyz, fid, iteration, generator):
        t = fid
        if not model_cfg.is_blender and generator is not None:
            # AST noise (train_baseline.py:112-115)
            t = fid + float(torch.randn((), generator=generator)) \
                * time_interval * linear_noise(
                    iteration, lr_init=0.1, lr_final=1e-15,
                    lr_delay_mult=0.01, max_steps=20000)
        return field.step(xyz, t)

    warm_step = make_train_step(opt_cfg=opt_cfg, pipe_cfg=pipe_cfg)
    deform_step = make_train_step(
        opt_cfg=opt_cfg, pipe_cfg=pipe_cfg, is_6dof=model_cfg.is_6dof,
        deform_fn=deform_fn, deform_params=list(field.net.parameters()),
        deform_update_fn=field.update)
    eval_render = make_eval_render(pipe_cfg=pipe_cfg,
                                   is_6dof=model_cfg.is_6dof,
                                   deform_fn=deform_fn)
    state = gaussians
    result = TrainResult(state=state, field=field, deform_state=deform_state)
    viewpoint_stack: list[Camera] = []
    ema_loss = 0.0
    t0 = time.perf_counter()

    for iteration in range(1, opt_cfg.iterations + 1):
        if iteration % 1000 == 0:
            state = G.oneup_sh_degree(state)
        if not viewpoint_stack:
            viewpoint_stack = list(stack_template)
        cam = viewpoint_stack.pop(rng.randint(0, len(viewpoint_stack) - 1))
        if iteration < opt_cfg.warm_up:
            state, _, aux = warm_step(state, None, cam, iteration, gen, bg)
        else:
            state, deform_state, aux = deform_step(state, deform_state, cam,
                                                   iteration, gen, bg)

        if iteration % log_every == 0 or iteration == 1:
            loss_val = float(aux.loss)
            ema_loss = 0.4 * loss_val + 0.6 * ema_loss
            result.losses.append((iteration, loss_val))
            if progress:
                print(f"[train {iteration}/{opt_cfg.iterations}] loss "
                      f"{ema_loss:.4f} points {state.num_alive} "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)

        if iteration in test_iterations:
            psnrs = [float(psnr(eval_render(
                state, iteration >= opt_cfg.warm_up, tc, bg).image.clamp(0, 1),
                tc.image)) for tc in (test_cams or train_cams[:5])]
            mean_psnr = float(np.mean(psnrs))
            result.test_psnrs[iteration] = mean_psnr
            if progress:
                print(f"[ITER {iteration}] evaluating test: PSNR "
                      f"{mean_psnr:.4f}", flush=True)
            if mean_psnr > result.best_psnr:
                result.best_psnr = mean_psnr
                result.best_iteration = iteration

        if iteration in save_iterations and model_path:
            save_checkpoint(model_path, iteration, state, field)

        # densify / reset AFTER report and save (reference order,
        # train_baseline.py:157-182): an eval at a reset iteration sees
        # the state before the reset
        if iteration < opt_cfg.densify_until_iter:
            state = densify_cadence(state, iteration, opt_cfg=opt_cfg,
                                    model_cfg=model_cfg, gen=gen,
                                    cameras_extent=cameras_extent,
                                    events=result.densify_events)

    result.state = state
    result.deform_state = deform_state
    return result


def save_checkpoint(model_path: str, iteration: int, state: G.GaussianState,
                    field) -> None:
    """point_cloud/iteration_N/point_cloud.ply and deform/iteration_N/
    deform.npz, in the layouts both packages read."""
    pc_dir = os.path.join(model_path, "point_cloud", f"iteration_{iteration}")
    os.makedirs(pc_dir, exist_ok=True)
    save_gaussians_ply(os.path.join(pc_dir, "point_cloud.ply"), state)
    save_deform_weights(model_path, iteration, field)


def densify_cadence(state: G.GaussianState, iteration: int, *, opt_cfg,
                    model_cfg, gen: torch.Generator, cameras_extent: float,
                    events: list) -> G.GaussianState:
    """The host cadence of both trainers before densify_until_iter: grow
    the buffer when densification fills 90 % of it, densify and prune every
    densification_interval after densify_from_iter (appending (iteration,
    alive, capacity before, alive, capacity after) to `events`), and reset
    the opacities on their interval."""
    densify, reset_opacity, _ = densify_fns(opt_cfg)
    if (iteration > opt_cfg.densify_from_iter
            and iteration % opt_cfg.densification_interval == 0):
        before = (state.num_alive, state.capacity)
        if (before[0] > 0.9 * state.capacity
                and state.capacity < model_cfg.max_gaussians):
            state = G.grow_capacity(state, min(
                G.round_capacity(state.capacity * 2),
                G.round_capacity(model_cfg.max_gaussians)))
        size_thresh = (20.0 if iteration > opt_cfg.opacity_reset_interval
                       else 0.0)
        state = densify(state, gen, size_thresh, cameras_extent)
        events.append((iteration, *before, state.num_alive, state.capacity))
        if state.num_alive == 0:
            print(f"WARNING: all gaussians pruned at iteration {iteration} "
                  f"(size/opacity thresholds wiped the scene; consider a "
                  f"shorter warm_up or a later opacity_reset_interval)")
    if (iteration % opt_cfg.opacity_reset_interval == 0
            or (model_cfg.white_background
                and iteration == opt_cfg.densify_from_iter)):
        state = reset_opacity(state)
    return state
