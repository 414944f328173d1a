"""CLI: standalone neural-ODE fitting demos, no Gaussians and no rendering
(counterpart of the repository's `ode_demo.py`, the reference
ode_demo_torchode.py / ode_demo_torchode_3d.py).

    python -m d3gs_tpu_torch.ode_demo [--demo spiral|sine3d] \
        [--iterations 400] [--out output/ode_demo] [--device cpu]

  * `--demo spiral`: fit the classic 2D spiral dy/dt = y³ A (the
    torchdiffeq demo system, reference ode_demo_torchode.py:25-46),
    embedded at z = 0, with a phase / vector-field plot;
  * `--demo sine3d`: fit a 3D sine-modulated trajectory.

Both fit the `simple` dynamics net with the fixed-step integrator that
training uses (`train/synth_ode.py`), then roll the fit out from t = 0.
Writes <demo>_result.json (losses, rollout MSE) and, where matplotlib
imports, <demo>.png. Runs on the card (`cuda`) unless `--device cpu` asks
for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from . import resolve_device


def true_spiral(num_points: int, y0=(2.0, 0.0), a=None, substeps: int = 64,
                device: str | torch.device = "cpu") -> torch.Tensor:
    """Integrate dy/dt = y³ A with substepped RK4 (the reference's true
    system, ode_demo_torchode.py:25-33; the cubic term is stiff near t = 0,
    hence the fine internal step). -> (num_points, 2) float32."""
    if a is None:
        a = [[-0.1, 2.0], [-2.0, -0.1]]
    a = torch.as_tensor(a, dtype=torch.float32, device=device)
    dt = 25.0 / (num_points * substeps)

    def f(y):
        return (y ** 3) @ a

    y = torch.as_tensor(y0, dtype=torch.float32, device=device)
    sixth = torch.tensor(dt / 6.0, device=device)
    ys = [y]
    for _ in range(num_points - 1):
        for _ in range(substeps):
            k1 = f(y)
            k2 = f(y + 0.5 * dt * k1)
            k3 = f(y + 0.5 * dt * k2)
            k4 = f(y + dt * k3)
            # one fused multiply-add, as XLA evaluates the update
            y = torch.addcmul(y, sixth, k1 + 2 * k2 + 2 * k3 + k4)
        ys.append(y)
    return torch.stack(ys)


def _plot(args, field, gt: np.ndarray, pred: np.ndarray) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"plotting skipped: {e}")
        return
    if args.demo == "spiral":
        fig, (ax, ax2) = plt.subplots(1, 2, figsize=(12, 6))
        ax.plot(gt[:, 0], gt[:, 1], "g-", label="true spiral")
        ax.plot(pred[:, 0], pred[:, 1], "b--", label="learned")
        ax.legend()
        ax.set_title("phase portrait")
        # the learned flow's finite-difference velocity at t = 0 on a grid
        # (z = 0 slice), like the reference's streamplot panel
        gx, gy = np.meshgrid(np.linspace(-2.2, 2.2, 21),
                             np.linspace(-2.2, 2.2, 21))
        dev = next(field.net.parameters()).device
        pts = torch.as_tensor(np.stack([gx.ravel(), gy.ravel(),
                                        np.zeros(gx.size)], axis=1),
                              dtype=torch.float32, device=dev)
        dt = 1.0 / args.num_points
        with torch.no_grad():
            d0 = field.step(pts, 0.0, y0=pts)[0].cpu().numpy()
            d1 = field.step(pts, dt, y0=pts)[0].cpu().numpy()
        vel = (d1 - d0) / dt
        ax2.streamplot(gx, gy, vel[:, 0].reshape(gx.shape),
                       vel[:, 1].reshape(gx.shape), density=1.2)
        ax2.set_title("learned vector field (t=0)")
    else:
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
        ax.plot(*gt.T, "g-", label="true")
        ax.plot(*pred.T, "b--", label="learned")
        ax.legend()
    path = os.path.join(args.out, f"{args.demo}.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"plot saved to {path}")


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description="neural-ODE demos (PyTorch/CUDA "
                                "port)")
    p.add_argument("--demo", choices=["spiral", "sine3d"], default="spiral")
    p.add_argument("--num_points", type=int, default=200)
    p.add_argument("--iterations", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--window", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="output/ode_demo")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu on request)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from .train.synth_ode import (rollout, sine_wave_trajectory,
                                  train_synth_ode)

    if args.demo == "spiral":
        xy = true_spiral(args.num_points, device=device)
        traj = torch.cat([xy, xy.new_zeros((args.num_points, 1))], dim=1)
    else:
        traj = sine_wave_trajectory(
            torch.tensor([0.0, 0.0, 0.0], device=device),
            torch.tensor([1.0, 0.5, -0.5], device=device), args.num_points)

    field, losses = train_synth_ode(
        trajectory=traj, iterations=args.iterations,
        batch_size=args.batch_size, window=args.window, kind="simple",
        lr=args.lr, seed=args.seed)

    pred = rollout(field, traj[0], args.num_points).cpu().numpy()
    gt = traj.cpu().numpy()
    mse = float(((pred - gt) ** 2).mean())
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.demo}_result.json"), "w") as f:
        json.dump({"losses": losses, "rollout_mse": mse}, f, indent=2)
    print(f"{args.demo}: final loss={losses[-1][1]:.6f} rollout MSE={mse:.6f}")
    _plot(args, field, gt, pred)
    return mse


if __name__ == "__main__":
    main()
