"""CLI: sweep the flagship trainer across sequence lengths (counterpart of
the repository's `train_loops.py`, the reference train_loops.py:46-68).

    python -m d3gs_tpu_torch.train_loops -s <data> -m <out> --is_blender \
        [--sequence_lengths 30 40 50 60] [--device cpu] ...

One run per sequence length, each in <out>/seq_<L> (default
./output/sweep) with its cfg_args, an evaluation and a checkpoint at the
last iteration; prints and returns {L: best PSNR}. Trains on the card
(`cuda`) unless `--device cpu` asks for the CPU.
"""
from __future__ import annotations

import argparse
import copy
import os

from . import config as C
from . import resolve_device


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="flagship sequence-length sweep (PyTorch/CUDA port)")
    C.add_group_args(parser, C.ModelParams)
    C.add_group_args(parser, C.PipelineParams)
    C.add_group_args(parser, C.OptimizationParams)
    parser.add_argument("--sequence_lengths", nargs="+", type=int,
                        default=[30, 40, 50, 60])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    model_cfg = C.extract_group(args, C.ModelParams)
    pipe_cfg = C.extract_group(args, C.PipelineParams)
    opt_cfg = C.extract_group(args, C.OptimizationParams)
    base_path = model_cfg.model_path or "./output/sweep"

    from .data.scene import Scene
    from .train.flagship import train_flagship

    results = {}
    for seq_len in args.sequence_lengths:
        m = copy.deepcopy(model_cfg)
        o = copy.deepcopy(opt_cfg)
        o.sequence_length = seq_len
        m.model_path = os.path.join(base_path, f"seq_{seq_len}")
        os.makedirs(m.model_path, exist_ok=True)
        C.save_cfg_args(m.model_path, m)
        scene = Scene(m, capacity=pipe_cfg.capacity, seed=args.seed,
                      device=device)
        res = train_flagship(
            gaussians=scene.gaussians, train_cams=scene.get_train_cameras(),
            test_cams=scene.get_test_cameras(),
            cameras_extent=scene.cameras_extent,
            model_cfg=m, opt_cfg=o, pipe_cfg=pipe_cfg,
            test_iterations={o.iterations}, save_iterations={o.iterations},
            model_path=m.model_path, seed=args.seed,
            progress=not args.quiet)
        results[seq_len] = res.best_psnr
        print(f"sequence_length={seq_len}: best PSNR {res.best_psnr:.2f}")
    print(results)
    return results


if __name__ == "__main__":
    main()
