"""CLI: export Gaussian trajectories (T, N, 3) and plot them (counterpart of
the repository's `sample_trajectories.py`, the reference's
sample_trajectories.py:26-110); the export feeds the forecasting pipeline.

    python -m d3gs_tpu_torch.sample_trajectories -m <model_dir>
        [--num_timesteps 150] [--output_dir DIR] [--device cuda|cpu]

The plot (trajectories.png) is written only where matplotlib imports.
"""
from __future__ import annotations

import argparse
import os

from . import config as C
from . import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="export deformable-3DGS trajectories (PyTorch port)")
    C.add_group_args(parser, C.ModelParams, fill_none=True)
    C.add_group_args(parser, C.PipelineParams)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--num_timesteps", default=150, type=int)
    parser.add_argument("--output_dir", default="", type=str)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = C.get_combined_args(parser, argv)
    device = resolve_device(args.device)

    model_cfg = C.extract_group(args, C.ModelParams)
    pipe_cfg = C.extract_group(args, C.PipelineParams)

    from .data.scene import Scene
    from .models.deform.fields import create_deform_field, load_deform_weights
    from .render_eval.trajectories import (export_trajectories,
                                           plot_trajectories)
    from .train.flagship import pick_field_spec

    scene = Scene(model_cfg, load_iteration=args.iteration, shuffle=False,
                  capacity=pipe_cfg.capacity, device=device)
    field = create_deform_field(
        pick_field_spec(model_cfg, C.OptimizationParams()), device=device)
    field = load_deform_weights(model_cfg.model_path, field, args.iteration)

    out_dir = args.output_dir or model_cfg.model_path
    traj, ts = export_trajectories(out_dir, scene.gaussians, field,
                                   num_timesteps=args.num_timesteps)
    plot_trajectories(os.path.join(out_dir, "trajectories.png"), traj)
    print(f"exported {traj.shape} trajectories to {out_dir}")
    return traj, ts


if __name__ == "__main__":
    main()
