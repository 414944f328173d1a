"""CLI: the baseline trainer with SAM mask-consistency regularization
(counterpart of the repository's `train_baseline_sam.py`).

    python -m d3gs_tpu_torch.train_baseline_sam -s <data> -m <out> \
        --is_blender [--segmenter auto|sam2|slic|grid | --mask_dir <dir>] \
        [--num_masks 64] [--mask_weight 0.5] [--device cpu] ...

Per training image a segmentation assigns the Gaussians (projected to
pixels) to masks, and the variance of the deformation outputs over each
mask's members is added to the deform-phase loss (reference
train_baseline_sam.py:45-152, weight 0.5 :272). Masks come from
`--mask_dir` (<image_name>.npy or .png label maps), else are generated from
the training images and cached in `<source>/sam_masks_cache/` (SAM2 where
the package and a checkpoint are available, SLIC superpixels otherwise),
or with `--segmenter grid` a regular grid; an image with no mask gets the
grid. The label maps live on the device, one per camera, made once.
Trains on the card (`cuda`) unless `--device cpu` asks for the CPU.
"""
from __future__ import annotations

import argparse
import os
import uuid

import numpy as np
import torch

from . import config as C
from . import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="SAM-regularized deformable-3DGS trainer (PyTorch/CUDA "
                    "port)")
    C.add_group_args(parser, C.ModelParams)
    C.add_group_args(parser, C.PipelineParams)
    C.add_group_args(parser, C.OptimizationParams)
    parser.add_argument("--mask_dir", type=str, default="",
                        help="directory of per-image label maps")
    parser.add_argument("--segmenter", type=str, default="auto",
                        choices=["auto", "sam2", "slic", "grid"],
                        help="mask source when --mask_dir is not given: "
                             "generate + cache from the raw images (sam2 "
                             "when importable, slic superpixels otherwise) "
                             "or a plain grid")
    parser.add_argument("--mask_weight", type=float, default=0.5)
    parser.add_argument("--num_masks", type=int, default=64)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[5000, 6000, 7000] + list(
                            range(10000, 40001, 1000)))
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7000, 10000, 20000, 30000, 40000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    model_cfg = C.extract_group(args, C.ModelParams)
    pipe_cfg = C.extract_group(args, C.PipelineParams)
    opt_cfg = C.extract_group(args, C.OptimizationParams)
    if not model_cfg.model_path:
        model_cfg.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
    os.makedirs(model_cfg.model_path, exist_ok=True)
    C.save_cfg_args(model_cfg.model_path, model_cfg)

    from .data.scene import Scene
    from .train.baseline import train_baseline
    from .train.sam_reg import (grid_label_map, load_label_maps,
                                mask_regularization)

    scene = Scene(model_cfg, capacity=pipe_cfg.capacity, seed=args.seed,
                  device=device)
    train_cams = scene.get_train_cameras()
    names = [c.image_name for c in train_cams]
    if args.mask_dir:
        maps = load_label_maps(args.mask_dir, names, args.num_masks)
        missing = [n for n in names if n not in maps]
        if missing:
            print(f"warning: {len(missing)} images have no mask; "
                  "grid fallback used for those")
    elif args.segmenter != "grid":
        # generate + cache masks from the raw training images, the
        # reference's end-to-end flow (train_baseline_sam.py:177-198)
        from .train.segment import load_or_generate_label_maps
        maps = load_or_generate_label_maps(
            train_cams, model_cfg.source_path, args.num_masks,
            method=args.segmenter, progress=not args.quiet)
    else:
        maps = {}
        print("--segmenter grid: using regular-grid segmentation as a "
              "weak rigidity prior")

    label_cache = {}
    for c in train_cams:
        lab = maps.get(c.image_name)
        if lab is None:
            lab = grid_label_map(c.height, c.width,
                                 cells=int(np.sqrt(args.num_masks)))
        label_cache[id(c)] = torch.as_tensor(lab, dtype=torch.int32,
                                              device=device)
    num_masks, weight = args.num_masks, args.mask_weight

    def extra_loss(out, deform_out, camera, state, labels):
        dx, dr, ds = deform_out
        xyz = state.params.xyz
        deformed = xyz + dx if torch.is_tensor(dx) else xyz
        return weight * mask_regularization(
            labels, num_masks, deformed, camera.projmatrix, dx, dr, ds,
            state.alive, camera.width, camera.height)

    result = train_baseline(
        gaussians=scene.gaussians, train_cams=train_cams,
        test_cams=scene.get_test_cameras(),
        cameras_extent=scene.cameras_extent,
        model_cfg=model_cfg, opt_cfg=opt_cfg, pipe_cfg=pipe_cfg,
        test_iterations=set(args.test_iterations),
        save_iterations=set(args.save_iterations + [opt_cfg.iterations]),
        model_path=model_cfg.model_path, seed=args.seed,
        progress=not args.quiet, extra_loss_fn=extra_loss,
        aux_data_fn=lambda cam: label_cache[id(cam)])
    print(f"Best PSNR = {result.best_psnr:.2f} "
          f"in Iteration {result.best_iteration}")
    return result


if __name__ == "__main__":
    main()
