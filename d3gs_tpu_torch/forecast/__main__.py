"""CLI: train and evaluate the trajectory forecaster on exported
trajectories (counterpart of the repository's `forecast.py`, the
reference forecast_exp/forecast_test.py + forecast_load_and_visualize.py).

    python -m d3gs_tpu_torch.forecast --trajectories <run>/trajectories.npy \
        [--output_dir forecast_results] [--epochs 10] [--device cpu] ...

Same flags as the JAX CLI, plus `--device`. The Gaussians are subsampled
and the windows split into train / validation with the same
`np.random.default_rng(0)` calls, so the windows are JAX's. Writes
metrics.json (mse, mae of the rollout; naive_mse of repeating the last
past point) and, with `--plot` where matplotlib imports, forecast.png.
Runs on the card (`cuda`) unless `--device cpu` asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .. import resolve_device


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="trajectory forecaster (PyTorch/CUDA port)")
    parser.add_argument("--trajectories", required=True,
                        help="trajectories.npy from sample_trajectories")
    parser.add_argument("--output_dir", default="forecast_results")
    parser.add_argument("--past_len", type=int, default=80)
    parser.add_argument("--future_len", type=int, default=30)
    parser.add_argument("--stride", type=int, default=10)
    parser.add_argument("--d_model", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=1024)
    parser.add_argument("--val_fraction", type=float, default=0.1)
    parser.add_argument("--max_gaussians", type=int, default=5000,
                        help="subsample gaussians for training windows")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from .train import (evaluate_forecaster, forecast, make_windows,
                        train_forecaster)

    traj = np.load(args.trajectories)  # (T, N, 3)
    if traj.shape[1] > args.max_gaussians:
        sel = np.random.default_rng(0).choice(
            traj.shape[1], args.max_gaussians, replace=False)
        traj = traj[:, sel]
    past, future = make_windows(traj, args.past_len, args.future_len,
                                args.stride)
    n = past.shape[0]
    n_val = max(int(n * args.val_fraction), 1)
    perm = np.random.default_rng(0).permutation(n)
    tr, va = perm[n_val:], perm[:n_val]

    model, _, _ = train_forecaster(
        past[tr], future[tr], d_model=args.d_model, epochs=args.epochs,
        batch_size=args.batch_size, device=device)
    metrics = evaluate_forecaster(model, past[va], future[va])
    metrics["naive_mse"] = float(np.mean((past[va][:, -1:, :]
                                          - future[va]) ** 2))
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics, indent=2))

    if args.plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError as e:
            print(f"plotting skipped: {e}")
            return metrics
        pred = forecast(model, torch.as_tensor(past[va][:4], device=device),
                        args.future_len).cpu().numpy()
        fig, axes = plt.subplots(3, 1, figsize=(10, 8))
        for d, ax in enumerate(axes):
            t_past = np.arange(args.past_len)
            t_fut = args.past_len + np.arange(args.future_len)
            ax.plot(t_past, past[va][0, :, d], label="past")
            ax.plot(t_fut, future[va][0, :, d], label="gt")
            ax.plot(t_fut, pred[0, :, d], "--", label="pred")
            ax.set_ylabel("xyz"[d])
        axes[0].legend()
        fig.savefig(os.path.join(args.output_dir, "forecast.png"), dpi=120)
        plt.close(fig)
    return metrics


if __name__ == "__main__":
    main()
