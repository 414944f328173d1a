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

Multi-GPU (the flagship trainer), one process per rank under torchrun:

    torchrun --standalone --nproc_per_node D -m d3gs_tpu_torch.train \
        --trainer flagship ... --mesh_shape D [--mesh_mode camera]
    torchrun --standalone --nproc_per_node C*S -m d3gs_tpu_torch.train \
        --trainer flagship ... --mesh_shape CxS --mesh_mode gauss_tile

The mesh's size must equal torchrun's WORLD_SIZE, or the CLI raises. Rank r
runs on cuda:LOCAL_RANK over NCCL (it raises if that card does not exist);
with `--device cpu` the ranks run on the CPU over gloo. A `CxS` shape is a
(camera groups x shards) mesh in the gauss_tile layout and a 1D mesh of
C*S ranks in the camera layout, as in JAX. The baseline trainer runs on
one device: at `--mesh_shape 1` it prints JAX's note and runs, at a larger
world size it raises. Rank 0 alone writes the model directory.
"""
from __future__ import annotations

import argparse
import math
import os
import uuid

import torch
import torch.distributed as dist

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
    mesh = None
    if pipe_cfg.mesh_shape:
        parts = mesh_parts(pipe_cfg.mesh_shape)
        if args.trainer == "baseline":
            if math.prod(parts) > 1:
                raise ValueError("--mesh_shape applies to --trainer flagship;"
                                 " the baseline trainer runs on one device")
            print("note: --mesh_shape applies to the flagship trainer; "
                  "baseline runs single-device")
        else:
            mesh = init_mesh(parts, pipe_cfg.mesh_mode, device)
            device = mesh.device
    try:
        return _train(args, model_cfg, pipe_cfg, opt_cfg, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def mesh_parts(shape: str) -> list[int]:
    """`--mesh_shape` ("D" or "CxS") as ints; raises unless the product
    equals torchrun's WORLD_SIZE."""
    parts = [int(p) for p in shape.lower().split("x")]
    world = os.environ.get("WORLD_SIZE")
    if world is None or int(world) != math.prod(parts):
        raise ValueError(
            f"--mesh_shape {shape} needs {math.prod(parts)} ranks, but "
            f"WORLD_SIZE is {world}: launch with torchrun --nproc_per_node "
            f"{math.prod(parts)} -m d3gs_tpu_torch.train ...")
    return parts


def init_mesh(parts: list[int], mode: str, device: torch.device):
    """Join the default process group from torchrun's environment (NCCL on
    cuda:LOCAL_RANK, gloo on the CPU) and build the mesh: (C x S) for a
    2D shape in the gauss_tile layout, else 1D over every rank."""
    from ..parallel import mesh as M
    if device.type == "cuda":
        local = int(os.environ["LOCAL_RANK"])
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank on cuda:{local}, but "
                               f"{torch.cuda.device_count()} card(s) are "
                               f"visible")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group(M.backend_for(device), init_method="env://")
    if len(parts) == 2 and mode == "gauss_tile":
        mesh = M.make_mesh_2d(parts[0], parts[1], device)
    else:
        mesh = M.make_mesh(device)
    if mesh.rank == 0:
        print(f"mesh: {'x'.join(map(str, parts))} ({mode}), backend "
              f"{dist.get_backend()}, world size {mesh.size}, rank 0 on "
              f"{device}", flush=True)
    return mesh


def _train(args, model_cfg, pipe_cfg, opt_cfg, device, mesh):
    lead = mesh is None or mesh.rank == 0
    if not model_cfg.model_path:
        model_cfg.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
    os.makedirs(model_cfg.model_path, exist_ok=True)
    tb_writer = None
    if lead:
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
        result = train_flagship(base_model_frozen=frozen, mesh=mesh,
                                **common)
    if tb_writer is not None:
        tb_writer.close()
    if mesh is not None and device.type == "cuda":
        from ..ops import blend as B
        print(f"rank {mesh.rank}: blend kernel launches: forward "
              f"{B.launches}, backward {B.launches_bwd}", flush=True)
    if lead:
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
