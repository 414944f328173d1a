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
  * a substep of the 8x256 `DeformNetworkODE` on a CUDA f32 state with host
    times runs as one kernel launch (`ops/ode_rk4.py::engages`): directly
    without autograd, else through `_FusedRK4`, which keeps the same
    (N, D) state as the checkpoint does and whose backward is one call of
    the step's fused vector-Jacobian product (`ode_rk4.rk4_step_vjp`);
  * time grids are a shared (T,) grid (host numbers: the time arithmetic
    runs in float32 on the host, and a zero-length segment returns its
    state untouched) or per-sample (N, T) grids (torchode's parallel-IVP
    semantics: each sample integrates through its own times).

`odeint_adaptive` / `odeint_adaptive_from_zero` port the JAX package's
adaptive path, which wraps `jax.experimental.ode.odeint`: Dopri5 with that
solver's own controller and dense output, and adjoint gradients. See the
section "Adaptive Dopri5" below.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ... import tracing
from ...ops import ode_rk4


def _count_step() -> None:
    """Count a step's 4 evaluations under `ode.evals.forward` while
    autograd records, `ode.evals.nograd` while it does not, and
    `ode.evals.recompute` when a step runs again inside autograd's
    backward."""
    if torch._C._current_graph_task_id() != -1:
        tracing.count("ode.evals.recompute", 4)
    elif torch.is_grad_enabled():
        tracing.count("ode.evals.forward", 4)
    else:
        tracing.count("ode.evals.nograd", 4)


def _count_fused() -> None:
    """Count a fused step (or its backward's recompute): `_count_step`,
    and its 4 evaluations under `ode.evals.fused` besides."""
    _count_step()
    tracing.count("ode.evals.fused", 4)


def _rk4_step(f: Callable, y: torch.Tensor, t, dt):
    """One RK4 step; t and dt are numbers or per-sample (N, 1) tensors.
    Counted by `_count_step`."""
    _count_step()
    k1 = f(t, y)
    k2 = f(t + dt * 0.5, y + 0.5 * dt * k1)
    k3 = f(t + dt * 0.5, y + 0.5 * dt * k2)
    k4 = f(t + dt, y + dt * k3)
    return y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


class _FusedRK4(torch.autograd.Function):
    """A fused RK4 step under autograd, with the contract of
    `checkpoint(_rk4_step, ..., use_reentrant=False)`: the forward runs
    `ops/ode_rk4.py::rk4_step` and keeps only y; the backward recomputes
    the step and returns the vector-Jacobian products of y and of every
    parameter of the net (the inputs after y) by `ode_rk4.rk4_step_vjp`,
    counted as a fused recompute (`_count_fused`)."""

    @staticmethod
    def forward(ctx, net, t, dt, y, *params):
        ctx.net, ctx.t, ctx.dt = net, t, dt
        ctx.save_for_backward(y)
        return ode_rk4.rk4_step(net, y, t, dt)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        _count_fused()
        gy, grads = ode_rk4.rk4_step_vjp(ctx.net, y, ctx.t, ctx.dt, g,
                                         need[1:])
        return (None, None, None, gy if need[0] else None, *grads)


def _substep(f: Callable, y: torch.Tensor, t, dt) -> torch.Tensor:
    """One RK4 step: fused where `ode_rk4.engages` (`_count_fused`), else
    `_rk4_step`, checkpointed when autograd records."""
    if ode_rk4.engages(f, y, t, dt):
        _count_fused()
        if torch.is_grad_enabled():
            return _FusedRK4.apply(f, t, dt, y, *f.parameters())
        return ode_rk4.rk4_step(f, y, t, dt)
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


# ---------------------------------------------------------------------------
# Adaptive Dopri5
# ---------------------------------------------------------------------------
#
# A port of what `jax.experimental.ode.odeint` computes, which the JAX
# package's `odeint_adaptive` wraps (not a generic Dopri5: another
# controller takes other steps, and the two would agree only to the
# tolerance):
#
#   * the Dopri5 tableau with FSAL (`runge_kutta_step`), the Hairer-Norsett-
#     Wanner first step (`initial_step_size`, order 4), the error norm
#     `mean_error_ratio` (an RMS over the whole ravelled state), the step
#     controller `optimal_step_size` (safety 0.9, ifactor 10, dfactor 0.2,
#     order 5) and dense output through `interp_fit_dopri`: output times are
#     interpolated, not stepped to;
#   * the loop: while t < target and dt > 0 (no step cap), accept when the
#     error ratio is <= 1, dt clipped at 0; a rejected step keeps the state
#     and takes the new dt;
#   * adjoint gradients (`_odeint_rev`): the augmented state (y, y_bar,
#     t0_bar, args_bar) integrates backwards one output segment at a time,
#     each segment a fresh solve with its own first step, and the error norm
#     runs over all of it, the parameter adjoint included. `args_bar` holds
#     what `custom_derivatives.closure_convert` hoists when the JAX package's
#     trainers call the solver under `jit`: every parameter of the dynamics
#     net and the `simple_start` anchor. (Called eagerly, JAX hoists only
#     the values it differentiates, so an undifferentiated anchor would drop
#     out of its norm.) No activation is kept across the forward solve: the
#     backward holds the augmented state and one evaluation's activations.
#
# Scalars of the controller (t, dt, the error ratio) are float32 tensors on
# the state's device, computed as JAX computes them. The host reads t and dt
# once per loop iteration (one transfer) to decide whether to go on; these
# reads and the steps and evaluations are counted by `tracing.count`, under
# `ode.adaptive.<forward|backward>.<field of SolveCounts>` and the reads
# under `host_reads.ode.adaptive.<forward|backward>` (`solve_counts`).
#
# Lanes. A shared (T,) grid is one controller for the whole state. Per-
# sample (N, T) grids give each row its own controller, as `jax.vmap` of the
# solver does: the rows step in lockstep through target index j, each row's
# update is masked once it has reached its own target, and each iteration
# evaluates the net once over all N rows. In the backward each row carries
# its own adjoint of every parameter, an (N, P) buffer as under `vmap`
# (per-row vector-Jacobian products through `torch.func.vmap` of
# `torch.func.vjp`): this path is meant for batch sizes like the synthetic
# harness's (16 rows; N·P·4 bytes per copy of the state). JAX has the same
# limit.

_F32 = torch.float32
# Dopri5 Butcher tableau of jax.experimental.ode.runge_kutta_step
_ALPHA = [1 / 5, 3 / 10, 4 / 5, 8 / 9, 1., 1., 0]
_BETA = [[1 / 5, 0, 0, 0, 0, 0, 0], [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
         [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
         [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
         [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0],
         [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]]
_C_SOL = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]
_C_ERROR = [35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085,
            125 / 192 - 451 / 720, -2187 / 6784 - -12231 / 42400,
            11 / 84 - 649 / 6300, -1. / 60.]
# interp_fit_dopri's midpoint weights
_C_MID = [6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2,
          -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
          -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2]
_STRICT_EPS = 1e-6        # _strict_increase's repair of duplicate times
_FROM_ZERO_MIN_T = 1e-6   # odeint_adaptive_from_zero's least horizon


@dataclasses.dataclass
class SolveCounts:
    """What the adaptive solves of one direction cost since the counters
    were last drained. `iterations`: loop iterations (one batched step of
    every lane); `accepted` / `rejected`: lane-steps (a shared grid has one
    lane); `evals`: batched evaluations of the dynamics net (in the
    backward each a forward and a vector-Jacobian product, besides one
    forward per output time for its t_bar term); `reads`: device-to-host
    transfers."""
    solves: int = 0
    iterations: int = 0
    accepted: int = 0
    rejected: int = 0
    evals: int = 0
    reads: int = 0


def _site(direction: str) -> str:
    return "ode.adaptive." + direction


def solve_counts(direction: str) -> SolveCounts:
    """The facility's counters of the `forward` or `backward` solves."""
    c = tracing.counters()
    site = _site(direction)
    fields = [f.name for f in dataclasses.fields(SolveCounts)
              if f.name != "reads"]
    return SolveCounts(reads=c.get("host_reads." + site, 0),
                       **{k: c.get(f"{site}.{k}", 0) for k in fields})


class _Lanes:
    """Each state component has a leading lane axis (per-sample: N lanes)
    or none (shared: one lane over everything)."""

    def __init__(self, n: int | None):
        self.per_sample = n is not None
        self.n = n if self.per_sample else 1

    def bc(self, v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A per-lane (R,) value broadcast against a component."""
        if self.per_sample:
            return v.reshape((self.n,) + (1,) * (like.ndim - 1))
        return v.reshape(())

    def sumsq(self, xs) -> torch.Tensor:
        """Per-lane sum of squares over the components -> (R,)."""
        return sum(x.reshape(self.n, -1).square().sum(1) if self.per_sample
                   else x.square().sum().reshape(1) for x in xs)

    def count(self, xs) -> int:
        return sum(x.numel() for x in xs) // self.n

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Per-lane dot product of two components -> (R,)."""
        return ((a * b).reshape(self.n, -1).sum(1) if self.per_sample
                else (a * b).sum().reshape(1))

    def time(self, t: torch.Tensor) -> torch.Tensor:
        """(R,) lane times as the net's time input: 0-d or (N, 1)."""
        return t.reshape(self.n, 1) if self.per_sample else t.reshape(())


def _comb(coef: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Σ_j coef[j]·ks[j] over the leading axis (`jnp.dot(coef, k)`), summed
    in order with one rounding per term, as XLA's dot accumulates it
    (`addcmul` is a fused multiply-add): the error estimate cancels to a
    few ulp of the stages, so the summation order decides the step sizes."""
    acc = ks[0] * coef[0]
    for j in range(1, coef.shape[0]):
        acc = torch.addcmul(acc, ks[j], coef[j])
    return acc


class _Tableau:
    def __init__(self, device):
        t = lambda a: torch.tensor(a, dtype=_F32, device=device)  # noqa: E731
        self.alpha, self.beta = t(_ALPHA), t(_BETA)
        self.c_sol, self.c_error, self.c_mid = t(_C_SOL), t(_C_ERROR), t(_C_MID)


def _initial_step_size(fun, t0, y0, f0, rtol, atol, lanes, order=4):
    """jax.experimental.ode.initial_step_size, per lane (Hairer, Norsett,
    Wanner, Solving ODEs I, II.4)."""
    scale = [atol + y.abs() * rtol for y in y0]
    d0 = lanes.sumsq([y / s for y, s in zip(y0, scale)]).sqrt()
    d1 = lanes.sumsq([f / s for f, s in zip(f0, scale)]).sqrt()
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    y1 = [y + lanes.bc(h0, y) * f for y, f in zip(y0, f0)]
    f1 = fun(y1, t0 + h0)
    d2 = lanes.sumsq([(a - b) / s for a, b, s in zip(f1, f0, scale)]
                     ).sqrt() / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15),
                     torch.clamp_min(h0 * 1e-3, 1e-6),
                     (0.01 / torch.maximum(d1, d2)) ** (1. / (order + 1.)))
    return torch.minimum(100. * h0, h1)


def _rk_step(fun, tab, y0, f0, t0, dt, lanes):
    """jax.experimental.ode.runge_kutta_step: -> (y1, f1, error, ks) with
    ks[c] the (7, ...) stages of component c."""
    ks = [torch.empty((7,) + f.shape, dtype=f.dtype, device=f.device)
          for f in f0]
    for k, f in zip(ks, f0):
        k[0] = f
    for i in range(1, 7):
        ti = t0 + dt * tab.alpha[i - 1]
        yi = [y + lanes.bc(dt, y) * _comb(tab.beta[i - 1, :i], k[:i])
              for y, k in zip(y0, ks)]
        for k, f in zip(ks, fun(yi, ti)):
            k[i] = f
    y1 = [lanes.bc(dt, y) * _comb(tab.c_sol, k) + y for y, k in zip(y0, ks)]
    err = [lanes.bc(dt, y) * _comb(tab.c_error, k) for y, k in zip(y0, ks)]
    return y1, [k[-1] for k in ks], err, ks


def _mean_error_ratio(err, y0, y1, rtol, atol, lanes) -> torch.Tensor:
    ratio = [e / (atol + rtol * torch.maximum(a.abs(), b.abs()))
             for e, a, b in zip(err, y0, y1)]
    return (lanes.sumsq(ratio) / lanes.count(ratio)).sqrt()


def _optimal_step_size(last_step, ratio, safety=0.9, ifactor=10.0,
                       dfactor=0.2, order=5.0):
    dfactor = torch.where(ratio < 1, 1.0, dfactor)
    factor = torch.minimum(torch.full_like(ratio, ifactor), torch.maximum(
        ratio ** (-1.0 / order) * safety, dfactor))
    return torch.where(ratio == 0, last_step * ifactor, last_step * factor)


def _interp_fit(tab, y0, y1, ks, dt, lanes):
    """interp_fit_dopri + fit_4th_order_polynomial: -> per component the
    coefficients (a, b, c, d, e) of the step's quartic in the relative
    time."""
    out = []
    for y, z, k in zip(y0, y1, ks):
        h = lanes.bc(dt, y)
        y_mid = y + h * _comb(tab.c_mid, k)
        dy0, dy1 = k[0], k[-1]
        a = -2. * h * dy0 + 2. * h * dy1 - 8. * y - 8. * z + 16. * y_mid
        b = 5. * h * dy0 - 3. * h * dy1 + 18. * y + 14. * z - 32. * y_mid
        c = -4. * h * dy0 + h * dy1 - 11. * y - 5. * z + 16. * y_mid
        out.append([a, b, c, h * dy0, y])
    return out


def _polyval(coeffs, r):
    v = coeffs[0]
    for c in coeffs[1:]:
        v = v * r + c
    return v


def _read(t: torch.Tensor, site: str) -> np.ndarray:
    with tracing.host_read(site):
        return t.cpu().numpy()


def _dopri5(fun, y0: list, ts: np.ndarray, lanes: _Lanes, rtol: float,
            atol: float, site: str) -> list:
    """Integrate the components y0 (at ts[:, 0]) through the (R, T) float32
    grid `ts`, strictly increasing along T; -> for each target index j >= 1
    the list of components at ts[:, j] (dense output). Counted under
    `site` (`_site(direction)`)."""
    dev = y0[0].device
    tab = _Tableau(dev)
    t_dev = torch.from_numpy(np.ascontiguousarray(ts)).to(dev)
    tracing.count(site + ".solves")
    t = t_dev[:, 0]
    f = fun(y0, t)
    dt = _initial_step_size(fun, t, y0, f, rtol, atol, lanes).clamp_min(0.)
    tracing.count(site + ".evals", 2)
    y, last_t = y0, t
    coeffs = [[c] * 5 for c in y0]
    t_h, dt_h = _read(torch.stack([t, dt]), site)
    outs = []
    for j in range(1, ts.shape[1]):
        target, target_h = t_dev[:, j], ts[:, j]
        while ((t_h < target_h) & (dt_h > 0)).any():
            active = (t < target) & (dt > 0)
            y1, f1, err, ks = _rk_step(fun, tab, y, f, t, dt, lanes)
            tracing.count(site + ".evals", 6)
            ratio = _mean_error_ratio(err, y, y1, rtol, atol, lanes)
            fit = _interp_fit(tab, y, y1, ks, dt, lanes)
            new_dt = _optimal_step_size(dt, ratio).clamp_min(0.)
            acc = active & (ratio <= 1.)
            keep = lambda new, old: torch.where(  # noqa: E731
                lanes.bc(acc, new), new, old)
            y = [keep(a, b) for a, b in zip(y1, y)]
            f = [keep(a, b) for a, b in zip(f1, f)]
            coeffs = [[keep(a, b) for a, b in zip(cn, co)]
                      for cn, co in zip(fit, coeffs)]
            last_t = torch.where(acc, t, last_t)
            t = torch.where(acc, t + dt, t)
            dt = torch.where(active, new_dt, dt)
            t_h, dt_h, acc_h, act_h = _read(
                torch.stack([t, dt, acc.to(_F32), active.to(_F32)]), site)
            tracing.count(site + ".iterations")
            tracing.count(site + ".accepted", int(acc_h.sum()))
            tracing.count(site + ".rejected", int((act_h > acc_h).sum()))
        r = (target - last_t) / (t - last_t)
        outs.append([_polyval(cs, lanes.bc(r, cs[0])) for cs in coeffs])
    return outs


class _Dynamics:
    """f(t, y) or f(t, y, anchor), with the parameters of f (an nn.Module)
    swappable for `torch.func`."""

    def __init__(self, f: Callable, anchor: torch.Tensor | None):
        self.f, self.anchor = f, anchor
        named = (list(f.named_parameters())
                 if isinstance(f, torch.nn.Module) else [])
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]

    def __call__(self, t, y, anchor=None, params: dict | None = None):
        args = (t, y) if self.anchor is None else (t, y, anchor)
        if params is None:
            return self.f(*args)
        return torch.func.functional_call(self.f, params, args)


def _augmented(dyn: _Dynamics, lanes: _Lanes, anchor):
    """The adjoint system in negative time s = -t (`_odeint_rev`'s
    aug_dynamics): state (y, y_bar, t0_bar, *params_bar[, anchor_bar]) ->
    (-f(y, t), y_bar·∂f/∂y, y_bar·∂f/∂t, y_bar·∂f/∂params[, y_bar·∂f/∂anchor]),
    per lane."""
    params = {n: p.detach() for n, p in zip(dyn.names, dyn.params)}
    has_anchor = anchor is not None

    if not lanes.per_sample:
        def fun(state, s):
            y, y_bar = state[0], state[1]
            with torch.enable_grad():
                y_ = y.detach().requires_grad_()
                t_ = (-s).reshape(()).detach().requires_grad_()
                p_ = {n: p.detach().requires_grad_()
                      for n, p in params.items()}
                a_ = anchor.detach().requires_grad_() if has_anchor else None
                out = dyn(t_, y_, a_, p_ if p_ else None)
                wrt = [y_, t_, *p_.values()] + ([a_] if has_anchor else [])
                grads = torch.autograd.grad(out, wrt, y_bar,
                                            allow_unused=True)
            grads = [torch.zeros_like(w) if g is None else g
                     for g, w in zip(grads, wrt)]
            return [-out.detach(), grads[0], grads[1].reshape(1), *grads[2:]]
        return fun

    from torch.func import vjp, vmap

    def row(y_r, t_r, a_r, yb_r):
        def f_row(y1, t1, p, a1):
            return dyn(t1.reshape(1, 1), y1[None],
                       a1[None] if has_anchor else None, p or None)[0]
        out, back = vjp(f_row, y_r, t_r, params, a_r)
        g_y, g_t, g_p, g_a = back(yb_r)
        return out, g_y, g_t, g_p, g_a

    def fun(state, s):
        y, y_bar = state[0], state[1]
        a = anchor if has_anchor else torch.zeros_like(y)
        out, g_y, g_t, g_p, g_a = vmap(row)(y, -s, a, y_bar)
        return ([-out, g_y, g_t, *(g_p[n] for n in dyn.names)]
                + ([g_a] if has_anchor else []))
    return fun


class _AdjointSolve(torch.autograd.Function):
    """ys (T, N, D) on the repaired grid; gradients by the adjoint method."""

    @staticmethod
    def forward(ctx, cfg, y0, anchor, *params):
        dyn, ts, lanes, rtol, atol = cfg

        def fun(state, t):
            return [dyn(lanes.time(t), state[0], anchor)]
        with torch.no_grad():
            outs = _dopri5(fun, [y0], ts, lanes, rtol, atol,
                           _site("forward"))
            ys = torch.stack([y0] + [o[0] for o in outs])
        ctx.cfg = cfg
        ctx.save_for_backward(ys, *(() if anchor is None else (anchor,)))
        return ys

    @staticmethod
    def backward(ctx, g):
        dyn, ts, lanes, rtol, atol = ctx.cfg
        ys, *saved = ctx.saved_tensors
        anchor = saved[0] if saved else None
        site = _site("backward")
        n_rows = ys.shape[1]
        t_dev = torch.from_numpy(np.ascontiguousarray(ts)).to(ys.device)
        aug = _augmented(dyn, lanes, anchor)
        rows = (n_rows,) if lanes.per_sample else ()
        y_bar = g[-1]
        t0_bar = ys.new_zeros(lanes.n)
        p_bar = [ys.new_zeros(rows + p.shape) for p in dyn.params]
        a_bar = [torch.zeros_like(anchor)] if anchor is not None else []
        for i in range(ys.shape[0] - 1, 0, -1):
            with torch.no_grad():
                f_i = dyn(lanes.time(t_dev[:, i]), ys[i], anchor)
            tracing.count(site + ".evals")
            t0_bar = t0_bar - lanes.dot(f_i, g[i])
            seg = np.stack([-ts[:, i], -ts[:, i - 1]], axis=1)
            (out,) = _dopri5(aug, [ys[i], y_bar, t0_bar, *p_bar, *a_bar],
                             seg, lanes, rtol, atol, site)
            y_bar, t0_bar = out[1] + g[i - 1], out[2]
            p_bar, a_bar = out[3:3 + len(p_bar)], out[3 + len(p_bar):]
        if lanes.per_sample:
            p_bar = [p.sum(0) for p in p_bar]
        return (None, y_bar, a_bar[0] if a_bar else None, *p_bar)


def _strict_increase(ts: np.ndarray, eps: float = _STRICT_EPS) -> np.ndarray:
    """Monotone repair along the last axis, in float32: each entry at least
    eps above its predecessor (the JAX package's `_strict_increase`)."""
    ts = ts.astype(np.float32)
    eps = np.float32(eps)
    out = np.empty_like(ts)
    prev = ts[..., 0] - eps
    for j in range(ts.shape[-1]):
        prev = np.maximum(ts[..., j], prev + eps)
        out[..., j] = prev
    return out


def _first_occurrence(ts: np.ndarray) -> np.ndarray:
    """searchsorted(ts, ts, side="left") along the last axis."""
    if ts.ndim == 1:
        return np.searchsorted(ts, ts, side="left")
    return np.stack([np.searchsorted(r, r, side="left") for r in ts])


def odeint_adaptive(f: Callable, y0: torch.Tensor, ts, *, rtol: float = 1e-3,
                    atol: float = 1e-4,
                    anchor: torch.Tensor | None = None) -> torch.Tensor:
    """Adaptive Dopri5 with adjoint gradients (counterpart of the JAX
    package's `odeint_adaptive`): integrate dy/dt = f(t, y[, anchor])
    through `ts` -> ys (T, N, D) with ys[0] = y0.

    f: the dynamics net (an nn.Module, whose parameters receive gradients
       by the adjoint method) or a function without parameters; t is a 0-d
       tensor (shared grid) or an (N, 1) tensor (per-sample grids).
    ts: a shared (T,) grid (numbers or a tensor) or per-sample (N, T) grids
       (a tensor), non-decreasing along T; read once on the host.
    anchor: the `simple_start` conditioning, (N, 3), mapped per row on
       per-sample grids and differentiable.

    Duplicate times: the solver integrates the grid repaired to strictly
    increasing (`_strict_increase`, 1e-6), and each duplicate's output is
    copied from its first occurrence (bit-equal)."""
    per_sample = isinstance(ts, torch.Tensor) and ts.ndim == 2
    if per_sample and ts.shape[0] != y0.shape[0]:
        raise ValueError("ts must be (T,) shared or (N, T) per-sample with N "
                         "matching y0")
    if isinstance(ts, torch.Tensor):
        if ts.device.type != "cpu":
            with tracing.host_read(_site("forward")):
                host = ts.detach().to(_F32).cpu().numpy()
        else:
            host = ts.detach().to(_F32).numpy()
    else:
        host = np.asarray(ts, dtype=np.float32)
    lanes = _Lanes(y0.shape[0] if per_sample else None)
    grid = _strict_increase(host)
    dyn = _Dynamics(f, anchor)
    cfg = (dyn, grid.reshape(lanes.n, -1), lanes, float(rtol), float(atol))
    ys = _AdjointSolve.apply(cfg, y0, anchor, *dyn.params)
    src = _first_occurrence(host)
    T = host.shape[-1]
    if np.array_equal(src, np.broadcast_to(np.arange(T), src.shape)):
        return ys
    idx = torch.from_numpy(src).to(y0.device)
    if not per_sample:
        return ys.index_select(0, idx)
    return torch.gather(ys, 0, idx.T[..., None].expand(-1, -1, ys.shape[-1]))


def odeint_adaptive_from_zero(f: Callable, y0: torch.Tensor, t, *,
                              rtol: float = 1e-3, atol: float = 1e-4,
                              anchor: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Adaptive integration from 0 to the host scalar t -> y(t) (the JAX
    package's `odeint_adaptive_from_zero`, the reference `odeint_adjoint(f,
    xyz, [0, t])`): the solve runs to max(t, 1e-6), and t <= 0 returns y0.
    JAX integrates that case too and discards the result; the port skips
    the solve, which changes neither the value nor the gradient."""
    t32 = np.float32(float(t))
    if not t32 > 0:
        return y0
    t_eff = max(t32, np.float32(_FROM_ZERO_MIN_T))
    return odeint_adaptive(f, y0, np.array([0.0, t_eff], np.float32),
                           rtol=rtol, atol=atol, anchor=anchor)[-1]
