"""Trajectory distillation: teach an ODE field a pretrained baseline MLP's
trajectories without rendering (counterpart of `d3gs_tpu/train/distill.py`,
the reference train_synth_gau.py::training() :47-238).

The teacher (a baseline deform MLP and its Gaussians) is frozen. Each
iteration draws a window start s ~ U[0, data_size - batch_time) from a
`torch.Generator` (reference get_batch, train_synth_gau.py:37-45), with
times batch_t = (s + arange(batch_time))·max_fid / data_size in float32,
rolls the teacher out to absolute positions true_y = xyz + d_xyz, anchors
the student ODE at true_y[0], integrates it through the window with the
student's solver, and takes an L1 step on the trajectories. Every row of
the Gaussian buffer takes part, dead ones included, as in the JAX package.
The periodic PSNR evaluation renders the student's positions.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..models import gaussians as G
from ..models.deform.fields import DeformFieldSpec, create_deform_field
from ..ops.losses import psnr
from .baseline import TrainResult
from .step import make_eval_render


def window_times(s: int, batch_time: int, data_size: int,
                 max_fid: float = 1.0) -> list[float]:
    """batch_t of the window starting at s, rounded as the JAX step rounds
    it: float32(s + j) · float32(max_fid / data_size)."""
    norm = np.float32(max_fid / data_size)
    return [float(np.float32(s + j) * norm) for j in range(batch_time)]


def make_distill_step(*, teacher_field, student_field, data_size: int,
                      batch_time: int, max_fid: float = 1.0):
    """-> (loss_and_grads(xyz, s) -> (loss, grads), step(state, xyz,
    generator, iteration) -> (state, loss)): one distillation step, its
    window drawn from `generator`."""
    params = list(student_field.net.parameters())

    def loss_and_grads(xyz: torch.Tensor, s: int):
        batch_t = window_times(s, batch_time, data_size, max_fid)
        with torch.no_grad():
            true_y = torch.stack([xyz + teacher_field.step(xyz, t)[0]
                                  for t in batch_t])
        pred = student_field.step_multi(true_y[0], batch_t, y0=true_y[0])[0]
        loss = (pred - true_y).abs().mean()
        return loss.detach(), torch.autograd.grad(loss, params)

    def step(state, xyz: torch.Tensor, generator: torch.Generator,
             iteration: int):
        s = int(torch.randint(0, data_size - batch_time, (),
                              generator=generator))
        loss, grads = loss_and_grads(xyz, s)
        return student_field.update(state, grads, iteration), loss

    return loss_and_grads, step


def train_distill(
    *,
    gaussians: G.GaussianState,
    teacher_field,
    model_cfg,
    opt_cfg,
    pipe_cfg,
    test_cams=(),
    data_size: int = 150,
    batch_time: int = 10,
    iterations: int = 2000,
    test_iterations=(),
    seed: int = 0,
    log_every: int = 50,
    progress: bool = True,
) -> TrainResult:
    """Distill the teacher's trajectories into a fresh ODE student
    (weights from torch.Generator(seed)); the Gaussians stay frozen
    (reference :77-86). Progress is printed, not drawn."""
    dev = gaussians.alive.device
    spec = DeformFieldSpec(
        kind="simple_start" if model_cfg.use_torch_ode else "ode",
        is_blender=model_cfg.is_blender, D=model_cfg.D, W=model_cfg.W,
        multires=model_cfg.multires, use_linear=model_cfg.use_linear,
        use_emb=model_cfg.use_emb, output_scale=model_cfg.output_scale,
        solver=model_cfg.ode_solver, rtol=opt_cfg.rtol, atol=opt_cfg.atol)
    student = create_deform_field(spec, seed=seed, device=dev,
                                  opt_cfg=opt_cfg)
    state = student.init_state()
    gen = torch.Generator().manual_seed(seed)
    xyz = gaussians.params.xyz.detach()
    _, step = make_distill_step(teacher_field=teacher_field,
                                student_field=student, data_size=data_size,
                                batch_time=batch_time)
    eval_render = make_eval_render(
        pipe_cfg=pipe_cfg, direct_compute=True,
        deform_fn=lambda x, fid, it, g: student.step(x, fid, y0=x))
    bg = torch.full((3,), 1.0 if model_cfg.white_background else 0.0,
                    device=dev)
    result = TrainResult(state=gaussians, field=student, deform_state=state)
    t0 = time.perf_counter()
    for iteration in range(1, iterations + 1):
        state, loss = step(state, xyz, gen, iteration)
        if iteration % log_every == 0 or iteration == 1:
            result.losses.append((iteration, float(loss)))
            if progress:
                print(f"[distill {iteration}/{iterations}] loss "
                      f"{float(loss):.5f} {time.perf_counter() - t0:.1f} s",
                      flush=True)
        if iteration in test_iterations and test_cams:
            psnrs = [float(psnr(eval_render(gaussians, True, tc,
                                            bg).image.clamp(0, 1), tc.image))
                     for tc in test_cams]
            m = float(np.mean(psnrs))
            result.test_psnrs[iteration] = m
            if progress:
                print(f"[ITER {iteration}] evaluating test: PSNR {m:.4f}",
                      flush=True)
            if m > result.best_psnr:
                result.best_psnr, result.best_iteration = m, iteration
    result.deform_state = state
    return result
