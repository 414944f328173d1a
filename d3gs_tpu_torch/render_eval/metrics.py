"""Offline metric harness: PSNR / SSIM / LPIPS over render dumps
(counterpart of `d3gs_tpu/render_eval/metrics.py`, the reference's
metrics.py:26-98).

Reads the renders/ and gt/ folders that the render CLI writes, computes
per-view and mean metrics on `device`, and writes results.json and
per_view.json in the same layout and keys. LPIPS runs when its VGG weights
load (`lpips.load_params`: LPIPS_WEIGHTS or ./lpips_vgg.npz) and is null
otherwise; the JAX package's fallback to the pip `lpips` package is not
ported (that package is on neither machine the port runs on).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import resolve_device
from ..data.image_io import read_image
from ..ops.losses import psnr as psnr_fn, ssim as ssim_fn
from . import lpips as lpips_mod


def _read_images(renders_dir: str, gt_dir: str):
    names = sorted(os.listdir(renders_dir))
    renders, gts = [], []
    for fname in names:
        for d, out in ((renders_dir, renders), (gt_dir, gts)):
            img = read_image(os.path.join(d, fname)).astype(np.float32) / 255.0
            out.append(img[..., :3])
    return renders, gts, names


def _try_lpips(device):
    """-> f(a, b) -> float LPIPS of two (H, W, 3) tensors, or None without
    weights. An explicitly set LPIPS_WEIGHTS that fails to load raises."""
    params = lpips_mod.load_params(device=device)
    if params is None:
        return None
    return lambda a, b: float(lpips_mod.lpips(params, a, b))


@torch.no_grad()
def evaluate_dir(method_dir: str, device: str | torch.device = "cuda"):
    """Evaluate one ours_<iter> directory -> (means, per-view dict)."""
    device = resolve_device(device)
    renders, gts, names = _read_images(os.path.join(method_dir, "renders"),
                                       os.path.join(method_dir, "gt"))
    lp = _try_lpips(device)
    if lp is None:
        print("metrics: no LPIPS weights (set LPIPS_WEIGHTS) — reporting "
              "LPIPS as null")
    per_view = {"PSNR": {}, "SSIM": {}, "LPIPS": {}}
    psnrs, ssims, lpipss = [], [], []
    for r, g, n in zip(renders, gts, names):
        r = torch.from_numpy(r).to(device)
        g = torch.from_numpy(g).to(device)
        p = float(psnr_fn(r, g))
        s = float(ssim_fn(r, g))
        psnrs.append(p)
        ssims.append(s)
        per_view["PSNR"][n] = p
        per_view["SSIM"][n] = s
        if lp is not None:
            l = lp(r, g)  # noqa: E741
            lpipss.append(l)
            per_view["LPIPS"][n] = l
    out = {
        "PSNR": float(np.mean(psnrs)) if psnrs else None,
        "SSIM": float(np.mean(ssims)) if ssims else None,
        "LPIPS": float(np.mean(lpipss)) if lpipss else None,
    }
    return out, per_view


def evaluate_model_paths(model_paths: list[str],
                         device: str | torch.device = "cuda") -> dict:
    """metrics.py::evaluate — results.json / per_view.json per model dir,
    over the test/<method> directories that hold renders/ and gt/. The JAX
    package also enters a directory without gt/ (an interpolation mode's
    frames) and fails there; the port skips it."""
    all_results = {}
    for mp in model_paths:
        test_dir = os.path.join(mp, "test")
        results, per_views = {}, {}
        if os.path.isdir(test_dir):
            for method in sorted(os.listdir(test_dir)):
                mdir = os.path.join(test_dir, method)
                if not all(os.path.isdir(os.path.join(mdir, d))
                           for d in ("renders", "gt")):
                    continue
                res, pv = evaluate_dir(mdir, device)
                results[method] = res
                per_views[method] = pv
        with open(os.path.join(mp, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        with open(os.path.join(mp, "per_view.json"), "w") as f:
            json.dump(per_views, f, indent=2)
        all_results[mp] = results
    return all_results
