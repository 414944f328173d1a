"""CLI: offline rendering of a trained model on the card (counterpart of the
repository's `render.py`).

    python -m d3gs_tpu_torch.render -m <model_dir>
        [--mode render|time|view|pose|all|original] [--trajectories]
        [--benchmark] [--device cuda|cpu]

`--mode render` renders every train/test view of the model's latest (or
`--iteration`) checkpoint at the view's time and writes renders/, depth/
and gt/ PNGs. The other modes render the first test view's time sweep
(`time`, 150 frames), the wander path around it (`view`, 60), a spherical
orbit with time sweeping (`all`, 150), a lerp between the first and last
test poses (`pose`, 150) and the piecewise lerp through every test pose
with time sweeping (`original`, 150), each into test/<mode dir>/renders
and depth (`render_eval/render_modes.py`). `--trajectories` then writes
trajectories.npy (T, N, 3) and timestamps.npy to the model directory and
plots trajectories.png where matplotlib imports. `--benchmark` times frames
of the first test view with CUDA events after a warm-up and prints FPS and
Mrays/s; it needs the card.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from . import config as C
from . import resolve_device

BENCH_WARMUP = 5
BENCH_FRAMES = 50


def benchmark(render_at, state, field, view, bg, *, warmup=BENCH_WARMUP,
              frames=BENCH_FRAMES) -> dict:
    """Render-only frame time of `view` on the card, from CUDA events around
    `frames` frames after `warmup` frames; the time sweeps over [0, 1]."""
    from .render_eval.render_modes import camera_with_fid
    if view.device.type != "cuda":
        raise ValueError("--benchmark times the card; it cannot run with "
                         "--device cpu")
    cams = [camera_with_fid(view, i / max(frames - 1, 1))
            for i in range(frames)]
    for cam in cams[:warmup]:
        render_at(state, field, cam, bg)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for cam in cams:
        render_at(state, field, cam, bg)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / frames
    result = {"frame_ms": ms, "fps": 1000.0 / ms,
              "mrays_per_s": view.width * view.height / ms / 1e3,
              "frames": warmup + frames, "width": view.width,
              "height": view.height}
    print(f"render-only: {result['fps']:.1f} FPS, "
          f"{result['mrays_per_s']:.1f} Mrays/s @ {view.width}x{view.height} "
          f"on {torch.cuda.get_device_name(view.device)}")
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="deformable-3DGS renderer (PyTorch/CUDA port)")
    C.add_group_args(parser, C.ModelParams, fill_none=True)
    C.add_group_args(parser, C.PipelineParams)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--mode", default="render",
                        choices=["render", "time", "view", "all", "pose",
                                 "original"])
    parser.add_argument("--trajectories", action="store_true",
                        help="also export + plot Gaussian trajectories")
    parser.add_argument("--benchmark", action="store_true",
                        help="render-only FPS benchmark on the card")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = C.get_combined_args(parser, argv)
    device = resolve_device(args.device)

    model_cfg = C.extract_group(args, C.ModelParams)
    pipe_cfg = C.extract_group(args, C.PipelineParams)

    from .data.scene import Scene
    from .models.deform.fields import (ODE_KINDS, create_deform_field,
                                       load_deform_weights)
    from .render_eval import render_modes as RM
    from .train.flagship import pick_field_spec

    scene = Scene(model_cfg, load_iteration=args.iteration, shuffle=False,
                  capacity=pipe_cfg.capacity, device=device)
    state = scene.gaussians
    iteration = scene.loaded_iter

    spec = pick_field_spec(model_cfg, C.OptimizationParams())
    field = create_deform_field(spec, device=device)
    field = load_deform_weights(model_cfg.model_path, field, args.iteration)

    bg = torch.full((3,), 1.0 if model_cfg.white_background else 0.0,
                    device=device)
    render_at = RM.make_render_fn(state, field, pipe_cfg,
                                  is_6dof=model_cfg.is_6dof,
                                  direct_compute=spec.kind in ODE_KINDS)

    train_views = scene.get_train_cameras()
    test_views = scene.get_test_cameras() or train_views[:5]
    mp = model_cfg.model_path
    result = {"iteration": iteration, "views": 0}
    common = (mp, "test", iteration)
    t0 = time.perf_counter()
    if args.mode == "render":
        if not args.skip_train:
            RM.render_split(mp, "train", iteration, train_views, state, field,
                            render_at, bg)
            result["views"] += len(train_views)
        if not args.skip_test:
            RM.render_split(mp, "test", iteration, test_views, state, field,
                            render_at, bg)
            result["views"] += len(test_views)
    elif args.mode == "time":
        result["frames"] = RM.interpolate_time(*common, test_views, state,
                                               field, render_at, bg)
    elif args.mode == "view":
        R, T = RM.reference_rt(test_views[0])
        result["frames"] = RM.interpolate_view(*common, test_views, state,
                                               field, render_at, bg, R, T)
    elif args.mode == "pose":
        result["frames"] = RM.interpolate_poses(*common, test_views, state,
                                                field, render_at, bg)
    elif args.mode == "all":
        result["frames"] = RM.interpolate_all(*common, test_views, state,
                                              field, render_at, bg)
    else:
        result["frames"] = RM.interpolate_view_original(
            *common, test_views, state, field, render_at, bg)
    if args.mode != "render":
        result["seconds"] = time.perf_counter() - t0

    if args.benchmark:
        result["benchmark"] = benchmark(render_at, state, field,
                                        test_views[0], bg)

    if args.trajectories:
        from .render_eval.trajectories import (export_trajectories,
                                               plot_trajectories)
        t0 = time.perf_counter()
        traj, _ = export_trajectories(mp, state, field)
        result["trajectories"] = {"shape": list(traj.shape),
                                  "seconds": time.perf_counter() - t0}
        plot_trajectories(os.path.join(mp, "trajectories.png"), traj)
    return result


if __name__ == "__main__":
    main()
