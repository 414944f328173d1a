"""Quality A/B of the deform MLP's compute dtype, float32 against bfloat16
(counterpart of `tools/exp_r5_mlp_quality.py`).

    python -m d3gs_tpu_torch.tools.exp_r5_mlp_quality [--device cpu] \
        [--iterations 2000] [--size 300]

A synthetic dynamic scene: 800 chunky Gaussians (a copy of
`tests/test_train_static.py::gt_state`) moved by a non-rigid warp of the
time (a translation and a bend, so the MLP has real work), rendered at 16
train and 4 test views on a radius-4 orbit. Each arm trains the baseline
trainer from the same noisy copy of the cloud with the same seeds, the
deform MLP in that dtype, and reports its best test PSNR; the schedule
(warm-up, densify window, evaluations) scales with `--iterations` and is
the JAX tool's at 2000. Prints both PSNRs, their delta and each arm's
wall time.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from .. import config as C
from .. import resolve_device
from ..data.cameras import camera_from_matrices
from ..models import gaussians as G
from ..models.renderer import render
from ..ops.camera_math import world_to_view

N_GT = 800
CAP = 4096
N_TRAIN, N_TEST = 16, 4


def gt_state(dev, n: int = N_GT, cap: int = CAP, seed: int = 0):
    """tests/test_train_static.py::gt_state: n points N(0, 0.6²), scales
    0.12, opacity logit 2."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    cols = rng.uniform(0.2, 1.0, size=(n, 3)).astype(np.float32)
    st = G.create_from_pcd(pts, cols, sh_degree=1, capacity=cap, device=dev)
    live = torch.arange(cap, device=dev)[:, None] < n
    p = st.params
    return dataclasses.replace(st, params=p._replace(
        scaling=torch.where(live, math.log(0.12), p.scaling),
        opacity=torch.where(live, 2.0, p.opacity))), pts


def make_camera(angle: float, size: int, dev, radius: float = 4.0):
    """tests/test_train_static.py::make_camera: on a radius-4 orbit about
    the y axis, looking at the origin, 60° FoV."""
    R = np.array([[math.cos(angle), 0, math.sin(angle)], [0, 1, 0],
                  [-math.sin(angle), 0, math.cos(angle)]])
    V = world_to_view(R, np.array([0.0, 0.0, radius])).T
    fov = math.radians(60)
    return camera_from_matrices(V, fov, fov, fid=0.0,
                                image=np.zeros((size, size, 3), np.float32),
                                device=dev)


def warp(xyz: torch.Tensor, fid: float) -> torch.Tensor:
    """Non-rigid ground-truth motion: translation + a bend."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    dx = 0.25 * fid + 0.15 * fid * torch.sin(2.0 * y)
    dy = 0.12 * fid * torch.cos(2.0 * x)
    return xyz + torch.stack([dx, dy, 0.05 * fid * z], dim=-1)


@torch.no_grad()
def make_dataset(dev, size: int):
    gt, pts = gt_state(dev)
    bg = torch.zeros(3, device=dev)

    def cam_at(k, n, phase=0.0):
        fid = k / max(n - 1, 1)
        shifted = dataclasses.replace(gt, params=gt.params._replace(
            xyz=warp(gt.params.xyz, fid)))
        cam = make_camera(phase + k * 2 * math.pi / n, size, dev)
        cam = dataclasses.replace(cam, fid=fid)
        return dataclasses.replace(cam, image=render(shifted, cam,
                                                     bg=bg).image)

    return (pts, [cam_at(k, N_TRAIN) for k in range(N_TRAIN)],
            [cam_at(k, N_TEST, phase=0.37) for k in range(N_TEST)])


def run_arm(dtype: str, pts, train_cams, test_cams, dev, iterations: int):
    from ..train.baseline import train_baseline
    rng = np.random.default_rng(1)
    noisy = pts + rng.normal(scale=0.04, size=pts.shape).astype(np.float32)
    cols = rng.uniform(0.2, 1.0, size=pts.shape).astype(np.float32)
    st = G.create_from_pcd(noisy, cols, sh_degree=1, capacity=CAP,
                           spatial_lr_scale=4.0, device=dev)
    scale = iterations / 2000
    it = lambda x: max(1, round(x * scale))  # noqa: E731
    model_cfg = C.ModelParams(is_blender=True, sh_degree=1,
                              deform_dtype=dtype)
    opt_cfg = C.OptimizationParams(
        iterations=iterations, warm_up=it(300), sequence_length=N_TRAIN,
        densify_from_iter=it(500), densify_until_iter=it(1500),
        densification_interval=it(100), opacity_reset_interval=10_000,
        position_lr_max_steps=iterations, deform_lr_max_steps=iterations)
    t0 = time.perf_counter()
    result = train_baseline(
        gaussians=st, train_cams=train_cams, test_cams=test_cams,
        cameras_extent=4.0, model_cfg=model_cfg, opt_cfg=opt_cfg,
        pipe_cfg=C.PipelineParams(),
        test_iterations={it(1000), it(1500), iterations}, seed=0,
        progress=False, log_every=max(1, iterations // 4))
    seconds = time.perf_counter() - t0
    print(f"deform_dtype={dtype:9s} best_psnr={result.best_psnr:.3f} "
          f"(test PSNRs {result.test_psnrs}) in {seconds:.1f} s", flush=True)
    return result.best_psnr, seconds


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    parser.add_argument("--iterations", type=int, default=2000)
    parser.add_argument("--size", type=int, default=300,
                        help="image side in pixels")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    pts, train_cams, test_cams = make_dataset(dev, args.size)
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[dtype], out[f"{dtype}_seconds"] = run_arm(
            dtype, pts, train_cams, test_cams, dev, args.iterations)
    out["delta_db"] = out["bfloat16"] - out["float32"]
    print(f"delta (bf16 - f32): {out['delta_db']:+.3f} dB", flush=True)
    return out


if __name__ == "__main__":
    main()
