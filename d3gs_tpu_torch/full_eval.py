"""CLI: chain train -> render -> metrics over scene lists with the port
(counterpart of the repository's `full_eval.py`, the reference's
full_eval.py:15-77), in-process.

    python -m d3gs_tpu_torch.full_eval --dnerf_path <root> [--scenes lego]
        [--mipnerf360 <root>] [--tanksandtemples <root>]
        [--deepblending <root>] [--iterations N] [--output_path ./eval]
        [--skip_training] [--skip_rendering] [--skip_metrics]
        [--device cuda|cpu]

Two scene collections, as in the JAX CLI: the reference's static-3DGS
lists (MipNeRF-360 outdoor/indoor with the images_4/images_2 resolution
pyramids, Tanks&Temples, Deep Blending) and the D-NeRF dynamic scenes.
Those COLMAP sets are usually JPEG, which the port decodes
(`data/jpeg.py`).
"""
from __future__ import annotations

import argparse
import os

from . import resolve_device

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump",
                             "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]
dnerf_scenes = ["bouncingballs", "hellwarrior", "hook", "jumpingjacks",
                "lego", "mutant", "standup", "trex"]


def main(argv=None) -> list[str]:
    parser = argparse.ArgumentParser(
        description="train, render and score scene lists (PyTorch port)")
    parser.add_argument("--dnerf_path", type=str, default="")
    parser.add_argument("--mipnerf360", "-m360", type=str, default="")
    parser.add_argument("--tanksandtemples", "-tat", type=str, default="")
    parser.add_argument("--deepblending", "-db", type=str, default="")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--scenes", nargs="*", default=None,
                        help="subset filter by scene name")
    parser.add_argument("--iterations", type=int, default=40_000)
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    # (source, scene, extra train flags) per collection, reference flags
    # (full_eval.py:41-52: images_4 outdoor, images_2 indoor)
    jobs = []
    if args.dnerf_path:
        for s in dnerf_scenes:
            jobs.append((os.path.join(args.dnerf_path, s), s,
                         ["--is_blender", "--white_background"]))
    if args.mipnerf360:
        for s in mipnerf360_outdoor_scenes:
            jobs.append((os.path.join(args.mipnerf360, s), s,
                         ["-i", "images_4"]))
        for s in mipnerf360_indoor_scenes:
            jobs.append((os.path.join(args.mipnerf360, s), s,
                         ["-i", "images_2"]))
    if args.tanksandtemples:
        for s in tanks_and_temples_scenes:
            jobs.append((os.path.join(args.tanksandtemples, s), s, []))
    if args.deepblending:
        for s in deep_blending_scenes:
            jobs.append((os.path.join(args.deepblending, s), s, []))
    if args.scenes is not None:
        jobs = [j for j in jobs if j[1] in args.scenes]
    if not jobs:
        parser.error("give at least one dataset root (--dnerf_path / "
                     "--mipnerf360 / --tanksandtemples / --deepblending)")

    from . import metrics as metrics_cli
    from . import render as render_cli
    from .train.__main__ import main as train_main
    dev = ["--device", args.device]
    model_paths = []
    for src, scene, extra in jobs:
        mp = os.path.join(args.output_path, scene)
        model_paths.append(mp)
        if not args.skip_training:
            train_main(["-s", src, "-m", mp, "--eval", "--quiet",
                        "--iterations", str(args.iterations)] + extra + dev)
        if not args.skip_rendering:
            render_cli.main(["-m", mp, "--skip_train", "--mode", "render"]
                            + dev)
    if not args.skip_metrics:
        metrics_cli.main(["-m"] + model_paths + dev)
    return model_paths


if __name__ == "__main__":
    main()
