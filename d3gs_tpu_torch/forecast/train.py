"""Forecaster training and evaluation over exported trajectories
(counterpart of `d3gs_tpu/forecast/train.py`, the reference's
forecast_exp/forecast_test.py windowing and training loop, :11-124, and
forecast_load_and_visualize.py's autoregressive generate + MSE/MAE).

The Adam update is written out as the JAX package writes it (moments
0.9 / 0.999, bias corrections from the step count, eps 1e-8 outside the
square root); `torch.optim.Adam` rounds in another order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .model import TrajectoryForecaster, normalize_window


@dataclasses.dataclass
class ForecastState:
    """Adam moments of the model's parameters, in `parameters()` order."""
    m: list
    v: list
    count: int = 0


def make_windows(traj: np.ndarray, past_len: int = 80, future_len: int = 30,
                 stride: int = 10):
    """(T, N, 3) trajectories -> stacked (past (B, Lp, 3), future (B, Lf,
    3)) windows over all Gaussians (reference TimeSeriesDataset:11-49)."""
    t_total, n, d = traj.shape
    pasts, futures = [], []
    for s in range(0, t_total - past_len - future_len + 1, stride):
        pasts.append(traj[s:s + past_len].transpose(1, 0, 2))
        futures.append(
            traj[s + past_len:s + past_len + future_len].transpose(1, 0, 2))
    past = np.concatenate(pasts, axis=0).astype(np.float32)
    future = np.concatenate(futures, axis=0).astype(np.float32)
    return past, future


def init_state(model: TrajectoryForecaster) -> ForecastState:
    params = list(model.parameters())
    return ForecastState(m=[torch.zeros_like(p) for p in params],
                         v=[torch.zeros_like(p) for p in params])


def make_train_step(model: TrajectoryForecaster, lr: float = 1e-3):
    """-> step(state, past, future) -> (state, loss): teacher-forced MSE in
    the past window's normalized space, one backward, one Adam step of the
    model's parameters (in place)."""
    params = list(model.parameters())

    def step(state: ForecastState, pb: torch.Tensor, fb: torch.Tensor):
        pn, mu, sd = normalize_window(pb)
        fn = (fb - mu) / sd
        fut_in = torch.cat([pn[:, -1:], fn[:, :-1]], dim=1)
        loss = ((model(pn, fut_in) - fn) ** 2).mean()
        grads = torch.autograd.grad(loss, params)
        count = state.count + 1
        c1, c2 = 1 - 0.9 ** count, 1 - 0.999 ** count
        new_m, new_v = [], []
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, state.m, state.v):
                m = 0.9 * m + 0.1 * g
                v = 0.999 * v + 0.001 * g * g
                p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8))
                new_m.append(m)
                new_v.append(v)
        return ForecastState(new_m, new_v, count), loss.detach()

    return step


def train_forecaster(past: np.ndarray, future: np.ndarray, *,
                     d_model: int = 128, epochs: int = 10,
                     batch_size: int = 1024, lr: float = 1e-3, seed: int = 0,
                     log_every: int = 20, progress: bool = True,
                     device: str | torch.device = "cuda"):
    """-> (model, state, losses [(step, loss)]). Weights from
    torch.Generator(seed); the batches are JAX's (a numpy
    default_rng(seed) permutation per epoch, the last partial batch
    dropped). The windows go to `device` once and are batched there."""
    model = TrajectoryForecaster(d_model=d_model, seed=seed).to(device)
    state = init_state(model)
    step = make_train_step(model, lr)
    past_d = torch.as_tensor(past, device=device)
    future_d = torch.as_tensor(future, device=device)
    n = past.shape[0]
    rng = np.random.default_rng(seed)
    losses = []
    steps_per_epoch = max(n // batch_size, 1)
    it = 0
    for epoch in range(epochs):
        perm = torch.as_tensor(rng.permutation(n), device=device)
        for b in range(steps_per_epoch):
            sel = perm[b * batch_size:(b + 1) * batch_size]
            state, loss = step(state, past_d[sel], future_d[sel])
            if it % log_every == 0:
                losses.append((it, float(loss)))
                if progress:
                    print(f"[forecast epoch {epoch}] step {it} loss "
                          f"{losses[-1][1]:.6f}", flush=True)
            it += 1
    return model, state, losses


@torch.no_grad()
def forecast(model: TrajectoryForecaster, past: torch.Tensor,
             future_len: int) -> torch.Tensor:
    """Autoregressive rollout (the reference's model.generate): the decoder
    input starts as the last past point and zeros; pass i places its
    prediction i at decoder position i+1; a last pass predicts the whole
    window. -> (B, future_len, D) positions."""
    pn, mu, sd = normalize_window(past)
    b, d = pn.shape[0], pn.shape[-1]
    fut_in = torch.cat([pn[:, -1:], pn.new_zeros((b, future_len - 1, d))],
                       dim=1)
    positions = torch.arange(future_len, device=pn.device)[None, :, None]
    for i in range(future_len - 1):
        pred = model(pn, fut_in)
        fut_in = torch.where(positions == i + 1, torch.roll(pred, 1, dims=1),
                             fut_in)
    return model(pn, fut_in) * sd + mu


def evaluate_forecaster(model: TrajectoryForecaster, past: np.ndarray,
                        future: np.ndarray, batch: int = 2048,
                        device: str | torch.device | None = None) -> dict:
    """MSE / MAE of the rollout over validation windows, the mean of the
    per-batch means (forecast_load_and_visualize.py)."""
    device = device or next(model.parameters()).device
    mses, maes = [], []
    for s in range(0, past.shape[0], batch):
        pred = forecast(model, torch.as_tensor(past[s:s + batch],
                                               device=device),
                        future.shape[1]).cpu().numpy()
        diff = pred - future[s:s + batch]
        mses.append(np.mean(diff ** 2))
        maes.append(np.mean(np.abs(diff)))
    return {"mse": float(np.mean(mses)), "mae": float(np.mean(maes))}
