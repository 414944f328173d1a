"""CLI: trajectory distillation on the card (counterpart of the repository's
`train_synth_gau.py`): teach an ODE field a pretrained baseline deformation
MLP's trajectories without rendering.

    python -m d3gs_tpu_torch.train_synth_gau -s <data> \
        --base_model_path <baseline run> -m <out> --is_blender \
        [--is_ode | --use_torch_ode] [--ode_solver adaptive] \
        [--distill_iterations N] [--device cpu] ...

The teacher is the baseline run's newest point cloud and its deform npz
(loaded through `params_from_flax`); the student is the `--is_ode` field
(`ode`) or with `--use_torch_ode` the `simple_start` net, integrated with
`--ode_solver`. The PSNR evaluation renders the scene's test cameras. The
student's weights land in `<out>/deform/iteration_N/deform.npz`, the losses
and PSNRs in `<out>/distill_result.json`.
"""
from __future__ import annotations

import argparse
import json
import os

from . import config as C
from . import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description="ODE trajectory distillation "
                                     "(PyTorch/CUDA port)")
    C.add_group_args(parser, C.ModelParams)
    C.add_group_args(parser, C.PipelineParams)
    C.add_group_args(parser, C.OptimizationParams)
    parser.add_argument("--base_model_path", type=str, required=True,
                        help="trained baseline run (teacher)")
    parser.add_argument("--distill_iterations", type=int, default=2000)
    parser.add_argument("--data_size", type=int, default=150,
                        help="virtual trajectory length (window domain)")
    parser.add_argument("--batch_time", type=int, default=10)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[500, 1000, 2000])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    model_cfg = C.extract_group(args, C.ModelParams)
    pipe_cfg = C.extract_group(args, C.PipelineParams)
    opt_cfg = C.extract_group(args, C.OptimizationParams)

    from .data.scene import Scene, load_gaussians_ply, \
        search_for_max_iteration
    from .models.deform.fields import (DeformFieldSpec, create_deform_field,
                                       load_deform_weights,
                                       save_deform_weights)
    from .train.distill import train_distill

    if not model_cfg.model_path:
        model_cfg.model_path = args.base_model_path.rstrip("/") + "_distill"
    scene = Scene(model_cfg, capacity=pipe_cfg.capacity, seed=args.seed,
                  device=device)
    pc = os.path.join(args.base_model_path, "point_cloud")
    it = search_for_max_iteration(pc)
    gaussians = load_gaussians_ply(
        os.path.join(pc, f"iteration_{it}", "point_cloud.ply"),
        sh_degree=model_cfg.sh_degree, spatial_lr_scale=scene.cameras_extent,
        max_gaussians=model_cfg.max_gaussians, capacity=pipe_cfg.capacity,
        device=device)
    teacher = load_deform_weights(args.base_model_path, create_deform_field(
        DeformFieldSpec(kind="baseline", is_blender=model_cfg.is_blender,
                        is_6dof=model_cfg.is_6dof, D=model_cfg.D,
                        W=model_cfg.W, multires=model_cfg.multires),
        device=device))
    os.makedirs(model_cfg.model_path, exist_ok=True)
    C.save_cfg_args(model_cfg.model_path, model_cfg)

    result = train_distill(
        gaussians=gaussians, teacher_field=teacher, model_cfg=model_cfg,
        opt_cfg=opt_cfg, pipe_cfg=pipe_cfg,
        test_cams=scene.get_test_cameras(), data_size=args.data_size,
        batch_time=args.batch_time, iterations=args.distill_iterations,
        test_iterations=set(args.test_iterations), seed=args.seed,
        progress=not args.quiet)

    save_deform_weights(model_cfg.model_path, args.distill_iterations,
                        result.field)
    with open(os.path.join(model_cfg.model_path, "distill_result.json"),
              "w") as f:
        json.dump({"losses": result.losses, "test_psnrs": result.test_psnrs,
                   "best_psnr": result.best_psnr}, f, indent=2)
    print(f"Best PSNR = {result.best_psnr:.2f} "
          f"in Iteration {result.best_iteration}")
    return result


if __name__ == "__main__":
    main()
