"""Trajectory export and plots (counterpart of
`d3gs_tpu/render_eval/trajectories.py`: the reference's
sample_trajectories.py and the trajectory-plot blocks of render.py:30-128 /
train_synth_gau.py:263-352)."""
from __future__ import annotations

import os

import numpy as np
import torch

from ..models.deform.fields import ODE_KINDS


@torch.no_grad()
def sample_trajectories(state, field, *, num_timesteps: int = 150,
                        t_max: float = 1.0):
    """Roll the deformation field over a uniform time grid for all alive
    Gaussians -> (T, N_alive, 3) ABSOLUTE positions + (T,) timestamps, as
    numpy (sample_trajectories.py:26-43). ODE kinds integrate from the
    canonical positions; MLP kinds add their offsets to them."""
    xyz = state.params.xyz
    ts = torch.linspace(0.0, t_max, num_timesteps, device=xyz.device)
    if field.spec.kind in ODE_KINDS:
        traj, _, _ = field.step_multi(xyz, ts, y0=xyz)
    else:
        dxs, _, _ = field.step_multi(xyz, ts)
        traj = xyz[None] + dxs
    return traj[:, state.alive].cpu().numpy(), ts.cpu().numpy()


def export_trajectories(out_dir: str, state, field,
                        num_timesteps: int = 150):
    """Write trajectories.npy (T, N, 3) + timestamps.npy, which the
    forecasting pipeline reads."""
    os.makedirs(out_dir, exist_ok=True)
    traj, ts = sample_trajectories(state, field, num_timesteps=num_timesteps)
    np.save(os.path.join(out_dir, "trajectories.npy"), traj)
    np.save(os.path.join(out_dir, "timestamps.npy"), ts)
    return traj, ts


def plot_trajectories(out_path: str, traj: np.ndarray, num_gaussians: int = 10,
                      reference_traj: np.ndarray | None = None,
                      seed: int = 0) -> None:
    """3D curve plot of sampled Gaussian trajectories, optionally overlaid
    with a reference model's (render.py:69-128). Only where matplotlib
    imports (the card's machine has none): otherwise it prints that the
    plot was skipped."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"[trajectories] plot skipped ({e})")
        return

    rng = np.random.default_rng(seed)
    n = traj.shape[1]
    sel = rng.choice(n, min(num_gaussians, n), replace=False)
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    for i in sel:
        ax.plot(traj[:, i, 0], traj[:, i, 1], traj[:, i, 2], alpha=0.8)
        if reference_traj is not None:
            ax.plot(reference_traj[:, i, 0], reference_traj[:, i, 1],
                    reference_traj[:, i, 2], alpha=0.5, linestyle="--")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
