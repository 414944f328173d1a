"""CLI: fit a neural-ODE deformation net to an analytic 3D trajectory
(counterpart of the repository's `train_synth_ode.py`).

    python -m d3gs_tpu_torch.train_synth_ode [--trajectory sine] \
        [--iterations 500] [--kind simple] [--out output/synth_ode] \
        [--device cpu] [--no_plot]

Writes the loss history and the rollout MSE (`losses.json`), the fitted
weights in the JAX package's npz layout (`deform_params.npz`, which
`render_synth_ode` reads), and a rollout plot where matplotlib imports.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from . import resolve_device

START, END = (0.0, 0.0, 0.0), (1.0, 0.5, -0.5)


def trajectory(name: str, num_points: int, device) -> torch.Tensor:
    """The analytic curve of the JAX CLI, from START to END."""
    from .train.synth_ode import GENERATORS
    start = torch.tensor(START, device=device)
    end = torch.tensor(END, device=device)
    return GENERATORS[name](start, end, num_points)


def plot_3d(path: str, curves: dict, title: str) -> None:
    """curves: label -> ((T, 3) array, matplotlib style); skipped where
    matplotlib does not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"plotting skipped: {e}")
        return
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    for label, (xyz, style) in curves.items():
        ax.plot(*xyz.T, style, label=label)
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"plot saved to {path}")


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description="synthetic-trajectory ODE fit "
                                "(PyTorch/CUDA port)")
    p.add_argument("--trajectory", choices=["linear", "sine", "quadratic"],
                   default="sine")
    p.add_argument("--num_points", type=int, default=150)
    p.add_argument("--iterations", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--window", type=int, default=10)
    p.add_argument("--kind", choices=["simple", "simple_start", "ode"],
                   default="simple")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="output/synth_ode")
    p.add_argument("--no_plot", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu on request)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from .models.deform.fields import flax_from_params
    from .train.synth_ode import rollout, train_synth_ode

    traj = trajectory(args.trajectory, args.num_points, device)
    field, losses = train_synth_ode(
        trajectory=traj, iterations=args.iterations,
        batch_size=args.batch_size, window=args.window, kind=args.kind,
        lr=args.lr, seed=args.seed)

    os.makedirs(args.out, exist_ok=True)
    pred = rollout(field, traj[0], args.num_points).cpu().numpy()
    gt = traj.cpu().numpy()
    mse = float(((pred - gt) ** 2).mean())
    with open(os.path.join(args.out, "losses.json"), "w") as f:
        json.dump({"losses": losses, "rollout_mse": mse}, f, indent=2)
    print(f"final loss={losses[-1][1]:.6f}  rollout MSE={mse:.6f}")
    np.savez(os.path.join(args.out, "deform_params.npz"),
             **flax_from_params(field.net))
    if not args.no_plot:
        plot_3d(os.path.join(args.out, "rollout.png"),
                {"ground truth": (gt, "g-"), "learned rollout": (pred, "b--")},
                f"{args.trajectory} trajectory, MSE={mse:.2e}")
    return mse


if __name__ == "__main__":
    main()
