"""The paper-faithful deformable-3DGS training loop (counterpart of
`d3gs_tpu/train/baseline.py`, the reference's train_baseline.py:34-208).

One random camera per iteration from a time-sorted, uniformly subsampled
`sequence_length` stack (stdlib `random.Random(seed)`, so both packages pick
the same cameras), a static warm-up before `warm_up`, AST time noise for
non-Blender scenes, the SH ramp every 1000 iterations, and, after each
step, report → save → densify / prune / opacity reset on the host cadence,
with the padded buffer grown when densification fills 90 % of it.

AST (annealing smooth training) is public: `ast_time` is the time the field
sees, `make_deform_fn` the trainers' `deform_fn` that evaluates the field
there and counts `deform.ast` for each jittered evaluation.
`train_baseline` and the benchmark's real-scene loop
(`benchmark/loops/train_real.py`) share it.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field as dfield
from random import Random

import numpy as np
import torch

from .. import tracing
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


def ast_time(fid, iteration, generator, time_interval: float,
             is_blender: bool):
    """The time the field sees in a training step (train_baseline.py:
    112-115): `fid` itself for Blender scenes and without a generator (the
    evaluation renders), else fid + N(0, 1) · time_interval ·
    linear_noise(iteration), the noise annealed linearly from 0.1 to 1e-15
    over 20,000 iterations, one draw from `generator` a call."""
    if is_blender or generator is None:
        return fid
    return fid + float(torch.randn((), generator=generator)) \
        * time_interval * linear_noise(
            iteration, lr_init=0.1, lr_final=1e-15, lr_delay_mult=0.01,
            max_steps=20000)


def make_deform_fn(field, model_cfg, time_interval: float):
    """-> deform_fn(xyz, fid, iteration, generator) -> (dx, dr, ds) of
    `make_train_step` / `make_eval_render`: `field.step` at `ast_time`
    (`time_interval` is one over the training stack's length), counting
    `deform.ast` once for each evaluation whose time was jittered."""

    def deform_fn(xyz, fid, iteration, generator):
        if not model_cfg.is_blender and generator is not None:
            tracing.count("deform.ast")
        return field.step(xyz, ast_time(fid, iteration, generator,
                                        time_interval, model_cfg.is_blender))

    return deform_fn


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
    extra_loss_fn=None,
    aux_data_fn=None,
    live_hook=None,
) -> TrainResult:
    """Train `gaussians` and a fresh deform field (torch.Generator(seed)
    for its weights, the AST noise and the split noise).

    `extra_loss_fn` / `aux_data_fn(camera)` add a per-camera
    differentiable regularizer to the deform-phase loss (the SAM-variant
    trainer's mask consistency, `train_baseline_sam`). `tb_writer` (a
    SummaryWriter or anything with its add_scalar / add_histogram /
    add_image) gets the losses, point count and iter_time at each log
    point and the test PSNR, opacity histogram and first five eval renders
    at each test iteration. `live_hook(state, deform_state, field,
    iteration)` fires at each log point with the live training state (the
    viewer renders from it)."""
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
    deform_fn = make_deform_fn(field, model_cfg,
                               1.0 / max(len(stack_template), 1))
    warm_step = make_train_step(opt_cfg=opt_cfg, pipe_cfg=pipe_cfg)
    deform_step = make_train_step(
        opt_cfg=opt_cfg, pipe_cfg=pipe_cfg, is_6dof=model_cfg.is_6dof,
        deform_fn=deform_fn, deform_params=list(field.net.parameters()),
        deform_update_fn=field.update, extra_loss_fn=extra_loss_fn)
    eval_render = make_eval_render(pipe_cfg=pipe_cfg,
                                   is_6dof=model_cfg.is_6dof,
                                   deform_fn=deform_fn)
    state = gaussians
    result = TrainResult(state=state, field=field, deform_state=deform_state)
    viewpoint_stack: list[Camera] = []
    ema_loss = 0.0
    t0 = time.perf_counter()
    timer = IterTimer()

    for iteration in range(1, opt_cfg.iterations + 1):
        if iteration % 1000 == 0:
            state = G.oneup_sh_degree(state)
        if not viewpoint_stack:
            viewpoint_stack = list(stack_template)
        cam = viewpoint_stack.pop(rng.randint(0, len(viewpoint_stack) - 1))
        if iteration < opt_cfg.warm_up:
            state, _, aux = warm_step(state, None, cam, iteration, gen, bg)
        else:
            aux_data = aux_data_fn(cam) if aux_data_fn is not None else None
            state, deform_state, aux = deform_step(state, deform_state, cam,
                                                   iteration, gen, bg,
                                                   aux_data)

        if iteration % log_every == 0 or iteration == 1:
            loss_val = float(aux.loss)
            ema_loss = 0.4 * loss_val + 0.6 * ema_loss
            result.losses.append((iteration, loss_val))
            if tb_writer is not None:
                log_scalars(tb_writer, iteration, loss_val, state,
                            timer(iteration), l1=float(aux.l1))
            if progress:
                print(f"[train {iteration}/{opt_cfg.iterations}] loss "
                      f"{ema_loss:.4f} points {state.num_alive} "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
            if live_hook is not None:
                live_hook(state, deform_state, field, iteration)

        if iteration in test_iterations:
            mean_psnr, eval_imgs = evaluate(
                eval_render, state, iteration >= opt_cfg.warm_up,
                test_cams or train_cams[:5], bg)
            result.test_psnrs[iteration] = mean_psnr
            if tb_writer is not None:
                log_evaluation(tb_writer, iteration, mean_psnr, state,
                               eval_imgs, first=iteration == min(
                                   test_iterations))
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


class IterTimer:
    """Milliseconds per iteration since the last call (the reference's
    iter_time scalar, train.py:360), amortized over the iterations
    between log points."""

    def __init__(self):
        self.t0, self.last = time.perf_counter(), 0

    def __call__(self, iteration: int) -> float:
        now = time.perf_counter()
        ms = (now - self.t0) / max(iteration - self.last, 1) * 1e3
        self.t0, self.last = now, iteration
        return ms


def log_scalars(tb_writer, iteration: int, loss: float,
                state: G.GaussianState, iter_ms: float,
                l1: float | None = None) -> None:
    """The log point's scalars under the JAX trainers' tags (the flagship
    trainer logs no l1)."""
    tb_writer.add_scalar("train_loss_patches/total_loss", loss, iteration)
    if l1 is not None:
        tb_writer.add_scalar("train_loss_patches/l1_loss", l1, iteration)
    tb_writer.add_scalar("total_points", state.num_alive, iteration)
    tb_writer.add_scalar("iter_time", iter_ms, iteration)


def evaluate(eval_render, state: G.GaussianState, use_deform: bool,
             cams: list[Camera], bg) -> tuple[float, list]:
    """-> (mean PSNR over `cams`, [(camera, render)] of the first five)."""
    psnrs, eval_imgs = [], []
    for tc in cams:
        image = eval_render(state, use_deform, tc, bg).image
        psnrs.append(float(psnr(image.clamp(0, 1), tc.image)))
        if len(eval_imgs) < 5:
            eval_imgs.append((tc, image))
    return float(np.mean(psnrs)), eval_imgs


def log_evaluation(tb_writer, iteration: int, mean_psnr: float,
                   state: G.GaussianState, eval_imgs: list,
                   first: bool) -> None:
    """A test iteration's tensorboard record (reference training_report,
    train.py:400-419): the PSNR, the live opacities' histogram and the
    eval renders, with their ground truth at the first test iteration."""
    tb_writer.add_scalar("test/psnr", mean_psnr, iteration)
    if state.num_alive:   # a histogram of an empty array raises
        tb_writer.add_histogram(
            "scene/opacity_histogram",
            state.get_opacity[state.alive].cpu().numpy(), iteration)
    for vi, (tc, image) in enumerate(eval_imgs):
        tb_writer.add_image(f"test_view_{vi}/render",
                            image.clamp(0, 1).cpu().numpy(), iteration,
                            dataformats="HWC")
        if first:
            tb_writer.add_image(f"test_view_{vi}/ground_truth",
                                tc.image.cpu().numpy(), iteration,
                                dataformats="HWC")


def save_checkpoint(model_path: str, iteration: int, state: G.GaussianState,
                    field) -> None:
    """point_cloud/iteration_N/point_cloud.ply and deform/iteration_N/
    deform.npz, in the layouts both packages read."""
    pc_dir = os.path.join(model_path, "point_cloud", f"iteration_{iteration}")
    os.makedirs(pc_dir, exist_ok=True)
    save_gaussians_ply(os.path.join(pc_dir, "point_cloud.ply"), state)
    save_deform_weights(model_path, iteration, field)


def densify_due(iteration: int, opt_cfg, model_cfg) -> bool:
    """Whether `densify_cadence` changes the state at `iteration` (a
    densify pass or an opacity reset)."""
    return ((iteration > opt_cfg.densify_from_iter
             and iteration % opt_cfg.densification_interval == 0)
            or iteration % opt_cfg.opacity_reset_interval == 0
            or (model_cfg.white_background
                and iteration == opt_cfg.densify_from_iter))


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
