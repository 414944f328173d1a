"""CLI: train a deformable-3DGS model with the port (counterpart of the
repository's `train.py`).

    python -m d3gs_tpu_torch.train -s <data> -m <out> --is_blender --eval \
        [--trainer baseline|flagship] [--base_model_path <run>] \
        [--configs configs/<preset>.py] [--device cpu] [--iterations N] ...

Same flags and `cfg_args` as the JAX CLI. The Gaussians start from the
dataset's point cloud, or with `--base_model_path` from the newest
checkpoint PLY of that run, frozen (`freeze_gaussians`), and train on the
card (`cuda`) unless `--device cpu` asks for the CPU. `--trainer flagship`
runs the k-camera / neural-ODE trainer (`--is_ode`, `--use_torch_ode` pick
the ODE fields). The checkpoints (`point_cloud/iteration_N/point_cloud.ply`,
`deform/iteration_N/deform.npz`) load in either package's renderer.
`--mesh_shape` (multi-GPU) raises.
"""
from __future__ import annotations

import argparse
import os
import uuid

import torch

from .. import config as C
from .. import resolve_device


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
        raise NotImplementedError("--mesh_shape is not ported yet (ROADMAP.md,"
                                  " Queue 1: slice 8, multi-GPU)")

    if not model_cfg.model_path:
        model_cfg.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
    os.makedirs(model_cfg.model_path, exist_ok=True)
    C.save_cfg_args(model_cfg.model_path, model_cfg)
    print(f"Output folder: {model_cfg.model_path}")
    tb_writer = make_tb_writer(model_cfg.model_path)

    from ..data.scene import Scene, load_gaussians_ply, \
        search_for_max_iteration

    scene = Scene(model_cfg, capacity=pipe_cfg.capacity, seed=args.seed,
                  device=device)
    frozen = bool(args.base_model_path)
    if frozen:
        # warm start from the pretrained run's newest point cloud, frozen
        pc = os.path.join(args.base_model_path, "point_cloud")
        it = search_for_max_iteration(pc)
        scene.gaussians = load_gaussians_ply(
            os.path.join(pc, f"iteration_{it}", "point_cloud.ply"),
            sh_degree=model_cfg.sh_degree,
            spatial_lr_scale=scene.cameras_extent,
            max_gaussians=model_cfg.max_gaussians,
            capacity=pipe_cfg.capacity, device=device)
        opt_cfg.freeze_gaussians = True
    common = dict(
        gaussians=scene.gaussians, train_cams=scene.get_train_cameras(),
        test_cams=scene.get_test_cameras(),
        cameras_extent=scene.cameras_extent, model_cfg=model_cfg,
        opt_cfg=opt_cfg, pipe_cfg=pipe_cfg,
        test_iterations=set(args.test_iterations),
        save_iterations=set(args.save_iterations + [opt_cfg.iterations]),
        model_path=model_cfg.model_path, seed=args.seed,
        tb_writer=tb_writer, progress=not args.quiet)
    if args.trainer == "baseline":
        from .baseline import train_baseline
        result = train_baseline(**common)
    else:
        from .flagship import train_flagship
        result = train_flagship(base_model_frozen=frozen, **common)
    if tb_writer is not None:
        tb_writer.close()
    print(f"Best PSNR = {result.best_psnr:.2f} "
          f"in Iteration {result.best_iteration}")
    return result


def make_tb_writer(model_path: str):
    """A tensorboard SummaryWriter on `model_path`, or None (printed) where
    torch.utils.tensorboard does not import (train.py:65-70)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print("Tensorboard not available; not logging progress")
        return None
    return SummaryWriter(model_path)


if __name__ == "__main__":
    main()
