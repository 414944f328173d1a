"""CLI: roll a fitted synthetic-ODE model out against its analytic ground
truth (counterpart of the repository's `render_synth_ode.py`).

    python -m d3gs_tpu_torch.render_synth_ode --params \
        output/synth_ode/deform_params.npz [--trajectory sine] \
        [--kind simple] [--out output/synth_ode] [--device cpu]

It loads the npz that `train_synth_ode` writes (the JAX package's layout,
so either package's file loads), rolls the field out from t = 0, prints
the MSE against the curve and plots where matplotlib imports.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from . import resolve_device


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description="synthetic-ODE rollout renderer "
                                "(PyTorch/CUDA port)")
    p.add_argument("--trajectory", choices=["linear", "sine", "quadratic"],
                   default="sine")
    p.add_argument("--num_points", type=int, default=150)
    p.add_argument("--kind", choices=["simple", "simple_start", "ode"],
                   default="simple")
    p.add_argument("--params", type=str, required=True,
                   help="npz from train_synth_ode")
    p.add_argument("--out", type=str, default="output/synth_ode")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu on request)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from .models.deform.fields import (DeformFieldSpec, create_deform_field,
                                       params_from_flax)
    from .train.synth_ode import rollout
    from .train_synth_ode import plot_3d, trajectory

    traj = trajectory(args.trajectory, args.num_points, device)
    field = create_deform_field(DeformFieldSpec(kind=args.kind),
                                seed=args.seed, device=device)
    with np.load(args.params) as data:
        field.net.load_state_dict(params_from_flax(dict(data), field.net))
    pred = rollout(field, traj[0], args.num_points).cpu().numpy()
    gt = traj.cpu().numpy()
    mse = float(((pred - gt) ** 2).mean())
    print(f"rollout MSE vs analytic ground truth: {mse:.6f}")
    os.makedirs(args.out, exist_ok=True)
    plot_3d(os.path.join(args.out, "render_rollout.png"),
            {"ground truth": (gt, "g-"), "learned": (pred, "b--")},
            f"{args.trajectory} rollout, MSE={mse:.2e}")
    return mse


if __name__ == "__main__":
    main()
