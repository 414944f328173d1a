"""CLI: train a deformable-3DGS model with the port (counterpart of the
repository's `train.py --trainer baseline`).

    python -m d3gs_tpu_torch.train -s <data> -m <out> --is_blender --eval \
        [--device cpu] [--iterations N] ...

Same flags and `cfg_args` as the JAX CLI. The Gaussians start from the
dataset's point cloud and train on the card (`cuda`) unless `--device cpu`
asks for the CPU; the checkpoints (`point_cloud/iteration_N/point_cloud.ply`,
`deform/iteration_N/deform.npz`) load in either package's renderer.
"""
from __future__ import annotations

import argparse
import os
import uuid

import torch

from .. import config as C
from .. import resolve_device

_SLICE3 = "(ROADMAP.md, Queue 1: slice 3, the flagship / neural-ODE trainer)"


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="deformable-3DGS trainer (PyTorch/CUDA port)")
    C.add_group_args(parser, C.ModelParams)
    C.add_group_args(parser, C.PipelineParams)
    C.add_group_args(parser, C.OptimizationParams)
    parser.add_argument("--trainer", choices=["baseline", "flagship"],
                        default="baseline")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[5000, 6000, 7000] + list(
                            range(10000, 40001, 1000)))
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7000, 10000, 20000, 30000, 40000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="torch.autograd.set_detect_anomaly")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--configs", type=str, default="",
                        help="python config overlay (configs/*.py)")
    parser.add_argument("--base_model_path", type=str, default="")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)

    if args.trainer != "baseline":
        raise NotImplementedError(f"--trainer {args.trainer} is not ported "
                                  f"yet {_SLICE3}")
    if args.base_model_path:
        raise NotImplementedError(f"--base_model_path is not ported yet "
                                  f"{_SLICE3}")
    device = resolve_device(args.device)
    torch.autograd.set_detect_anomaly(args.detect_anomaly)

    model_cfg = C.extract_group(args, C.ModelParams)
    pipe_cfg = C.extract_group(args, C.PipelineParams)
    opt_cfg = C.extract_group(args, C.OptimizationParams)
    if args.configs:
        C.apply_config_file(args.configs, {"model": model_cfg,
                                           "pipeline": pipe_cfg,
                                           "optimization": opt_cfg})
    if pipe_cfg.mesh_shape:
        raise NotImplementedError(f"--mesh_shape is not ported yet {_SLICE3}; "
                                  "multi-GPU is slice 7")

    if not model_cfg.model_path:
        model_cfg.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
    os.makedirs(model_cfg.model_path, exist_ok=True)
    C.save_cfg_args(model_cfg.model_path, model_cfg)
    print(f"Output folder: {model_cfg.model_path}")

    from ..data.scene import Scene
    from .baseline import train_baseline

    scene = Scene(model_cfg, capacity=pipe_cfg.capacity, seed=args.seed,
                  device=device)
    result = train_baseline(
        gaussians=scene.gaussians, train_cams=scene.get_train_cameras(),
        test_cams=scene.get_test_cameras(),
        cameras_extent=scene.cameras_extent, model_cfg=model_cfg,
        opt_cfg=opt_cfg, pipe_cfg=pipe_cfg,
        test_iterations=set(args.test_iterations),
        save_iterations=set(args.save_iterations + [opt_cfg.iterations]),
        model_path=model_cfg.model_path, seed=args.seed,
        progress=not args.quiet)
    print(f"Best PSNR = {result.best_psnr:.2f} "
          f"in Iteration {result.best_iteration}")
    return result


if __name__ == "__main__":
    main()
