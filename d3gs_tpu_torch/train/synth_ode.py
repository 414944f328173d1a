"""Synthetic-trajectory ODE fitting harness (counterpart of
`d3gs_tpu/train/synth_ode.py`, the reference train_synth_ode.py /
ode_demo_torchode*.py).

Fit a neural-ODE deformation net to an analytic 3D trajectory whose ground
truth is known exactly: the cheap correctness oracle of the ODE stack.
Each step draws per-sample windows of the curve (per-sample (N, T) time
grids, torchode's parallel-IVP semantics), integrates them, and takes a
constant-rate Adam step on the L1 trajectory loss.
"""
from __future__ import annotations

import math

import torch

from ..models.deform.fields import DeformFieldSpec, create_deform_field


# --- analytic trajectory generators (reference train_synth_ode.py:16-51) ---

def _unit_time(num_points, like):
    return torch.linspace(0, 1, num_points, dtype=like.dtype,
                          device=like.device)[:, None]


def linear_trajectory(start, end, num_points):
    t = _unit_time(num_points, start)
    return start[None] + (end - start)[None] * t


def sine_wave_trajectory(start, end, num_points, freq=2.0,
                         amps=(0.1, 0.05, 0.02)):
    t = _unit_time(num_points, start)
    base = start[None] + (end - start)[None] * t
    waves = torch.cat([a * torch.sin(2 * math.pi * freq * t) for a in amps],
                      dim=1)
    return base + waves


def quadratic_trajectory(start, end, num_points):
    t = _unit_time(num_points, start)
    return start[None] + (end - start)[None] * t ** 2


GENERATORS = {"linear": linear_trajectory, "sine": sine_wave_trajectory,
              "quadratic": quadratic_trajectory}


def sample_windows(generator: torch.Generator, trajectory: torch.Tensor,
                   batch_size: int, window: int):
    """Random per-sample windows (reference get_batch:96-101): each sample
    starts at its own index, so the grids differ per sample.
    trajectory (T_total, D) -> (y0 (B, D), ts (B, W), y (W, B, D))."""
    t_total = trajectory.shape[0]
    starts = torch.randint(0, t_total - window, (batch_size,),
                           generator=generator).to(trajectory.device)
    steps = torch.arange(window, device=trajectory.device)
    ts = (starts[:, None] + steps[None, :]).to(torch.float32) / t_total
    y = trajectory[starts[None, :] + steps[:, None]]
    return trajectory[starts], ts, y


def harness_adam(params, grads, m, v, count: int, lr: float) -> None:
    """The harness's Adam with a constant rate (eps 1e-8; the reference
    uses plain Adam, scene/deform_model.py:39-40), in place."""
    c1, c2 = 1 - 0.9 ** count, 1 - 0.999 ** count
    with torch.no_grad():
        for p, g, mi, vi in zip(params, grads, m, v):
            mi.mul_(0.9).add_(0.1 * g)
            vi.mul_(0.999).add_(0.001 * g * g)
            p.sub_(lr * (mi / c1) / (torch.sqrt(vi / c2) + 1e-8))


def window_loss(field, y0, ts, y_true) -> torch.Tensor:
    """L1 between the field's integral of each window and the curve."""
    ys = field.step_multi(y0, ts, y0=y0)[0]                 # (W, B, D)
    return (ys - y_true).abs().mean()


def train_synth_ode(
    *,
    trajectory: torch.Tensor,    # (T, 3) ground-truth trajectory
    iterations: int = 500,
    batch_size: int = 16,
    window: int = 10,
    kind: str = "simple",
    lr: float = 1e-3,
    n_substeps: int = 4,
    seed: int = 0,
    log_every: int = 50,
):
    """Fit the ODE field to one analytic trajectory on its device; returns
    (field, losses). The batch carries windows of the same curve."""
    spec = DeformFieldSpec(kind=kind, n_substeps=n_substeps)
    field = create_deform_field(spec, seed=seed, device=trajectory.device)
    gen = torch.Generator().manual_seed(seed)
    params = list(field.net.parameters())
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses = []
    for it in range(iterations):
        y0, ts, y_true = sample_windows(gen, trajectory, batch_size, window)
        loss = window_loss(field, y0, ts, y_true)
        grads = torch.autograd.grad(loss, params)
        harness_adam(params, grads, m, v, it + 1, lr)
        if it % log_every == 0 or it == iterations - 1:
            losses.append((it, float(loss.detach())))
    return field, losses


@torch.no_grad()
def rollout(field, y0: torch.Tensor, num_points: int) -> torch.Tensor:
    """Full-sequence rollout from t = 0 (reference render_synth_ode.py)."""
    ts = torch.linspace(0.0, 1.0, num_points)
    ys = field.step_multi(y0[None], ts, y0=y0[None])[0]
    return ys[:, 0]
