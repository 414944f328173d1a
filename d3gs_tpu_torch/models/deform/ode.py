"""Neural-ODE integration (counterpart of `d3gs_tpu/models/deform/ode.py`).

A fixed-step RK4 on the evaluation grid with `n_substeps` RK4 steps per grid
segment, as in the JAX package (the reference integrates adaptively with
torchdiffeq / torchode, scene/deform_model.py:26-30,61-78,196-198):

  * vectorized over the N Gaussians: each stage is one (N, ·) evaluation of
    the dynamics net, dense matmuls;
  * each RK4 substep runs under `torch.utils.checkpoint`, so the autograd
    graph keeps only the (N, D) state entering each substep and the
    backward re-runs one substep's four evaluations at a time. Without it,
    k = 10 cameras at 43,132 Gaussians keep ~144 evaluations × 9 layers ×
    256 × 4 B × N ≈ 57 GB of activations; with it about 1.6 GB;
  * time grids are a shared (T,) grid (host numbers: the time arithmetic
    runs in float32 on the host, and a zero-length segment returns its
    state untouched) or per-sample (N, T) grids (torchode's parallel-IVP
    semantics: each sample integrates through its own times).

The adaptive Dopri5 solver of the JAX package (`odeint_adaptive`) is not
ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def _rk4_step(f: Callable, y: torch.Tensor, t, dt):
    """One RK4 step; t and dt are numbers or per-sample (N, 1) tensors."""
    k1 = f(t, y)
    k2 = f(t + dt * 0.5, y + 0.5 * dt * k1)
    k3 = f(t + dt * 0.5, y + 0.5 * dt * k2)
    k4 = f(t + dt, y + dt * k3)
    return y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _substep(f: Callable, y: torch.Tensor, t, dt) -> torch.Tensor:
    """One RK4 step, checkpointed when autograd records."""
    if torch.is_grad_enabled():
        return checkpoint(_rk4_step, f, y, t, dt, use_reentrant=False,
                          preserve_rng_state=False)
    return _rk4_step(f, y, t, dt)


def _host_f32(t) -> torch.Tensor | None:
    """t as a 0-d float32 CPU tensor if it is a host scalar (a number or a
    0-d CPU tensor), else None."""
    if isinstance(t, torch.Tensor):
        if t.device.type != "cpu" or t.ndim != 0:
            return None
        return t.to(torch.float32)
    return torch.tensor(float(t), dtype=torch.float32)


def integrate_segment(f: Callable, y: torch.Tensor, t0, t1,
                      n_substeps: int) -> torch.Tensor:
    """Integrate y from t0 to t1 with n_substeps RK4 steps. t0 and t1 are
    host scalars (t0 == t1 returns y itself) or per-sample (N, 1) tensors
    on y's device."""
    h0, h1 = _host_f32(t0), _host_f32(t1)
    if h0 is not None and h1 is not None:
        if bool(h0 == h1):
            return y
        dt = (h1 - h0) / n_substeps
        for i in range(n_substeps):
            y = _substep(f, y, float(h0 + dt * i), float(dt))
        return y
    dt = (t1 - t0) / n_substeps
    for i in range(n_substeps):
        y = _substep(f, y, t0 + dt * i, dt)
    return y


def odeint_grid(f: Callable, y0: torch.Tensor, ts, *,
                n_substeps: int = 4) -> torch.Tensor:
    """Integrate dy/dt = f(t, y) through the evaluation grid.

    f: dynamics, f(t, y) -> dy/dt; t a number or an (N, 1) tensor.
    y0: (N, D) state at ts[..., 0].
    ts: (T,) shared grid (a sequence of numbers or a tensor, read on the
        host), or an (N, T) tensor of per-sample grids on y0's device.
    Returns ys (T, N, D) with ys[0] = y0."""
    if isinstance(ts, torch.Tensor) and ts.ndim == 2:
        if ts.shape[0] != y0.shape[0]:
            raise ValueError("per-sample ts must be (N, T) with N matching "
                             "y0")
        bounds = [ts[:, j:j + 1].to(y0.dtype) for j in range(ts.shape[1])]
    else:
        bounds = torch.as_tensor(ts, dtype=torch.float32).cpu().unbind(0)
    ys = [y0]
    for t0, t1 in zip(bounds[:-1], bounds[1:]):
        ys.append(integrate_segment(f, ys[-1], t0, t1, n_substeps))
    return torch.stack(ys)


def odeint_from_zero(f: Callable, y0: torch.Tensor, t, *,
                     n_substeps: int = 8) -> torch.Tensor:
    """Integrate from t = 0 to the single time t (a host scalar); returns
    y(t). Replaces the reference's per-render `odeint_adjoint(f, xyz,
    [0, t])` with its t = 0 shortcut (deform_model.py:189-198): at t = 0 the
    zero-length segment returns y0 itself."""
    return integrate_segment(f, y0, 0.0, t, n_substeps)
