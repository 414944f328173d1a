"""LPIPS (Learned Perceptual Image Patch Similarity) in PyTorch (counterpart
of `d3gs_tpu/render_eval/lpips_jax.py`, the reference's vendored
lpipsPyTorch/: VGG16 backbone, unit-normalized feature differences, 1x1
linear heads, spatial average, layer sum).

The v0.1 weights (VGG16 conv stack + 5 linear heads) are not shipped: they
load from the same npz that `lpips_jax.load_params` reads (HWIO convs,
written by `export_weights_from_torch()` on a machine with torchvision and
the pip `lpips` package), named by a `path` argument or the LPIPS_WEIGHTS
environment variable, or ./lpips_vgg.npz. Without weights the metrics
report LPIPS as null. Unlike the JAX package's `metrics.py`, the port has
no fallback to the pip `lpips` package.

Images are (H, W, 3) float in [0, 1]. The convolutions are `F.conv2d` with
padding 1 (JAX's SAME) and `F.max_pool2d(2)` (JAX's VALID 2x2 window,
which drops an odd last row/column); TF32 stays off
(`d3gs_tpu_torch/__init__.py`).
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 feature config: (out_channels, n_convs) per stage; LPIPS taps the
# output of the last relu in each stage (relu1_2, 2_2, 3_3, 4_3, 5_3)
_VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# the LPIPS v0.1 scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def vgg16_features(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """x: (N, 3, H, W) in LPIPS-normalized space -> the 5 tap activations."""
    taps = []
    i = 0
    for si, (_, n_convs) in enumerate(_VGG_STAGES):
        for _ in range(n_convs):
            x = F.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                                padding=1))
            i += 1
        taps.append(x)
        if si < len(_VGG_STAGES) - 1:
            x = F.max_pool2d(x, 2)
    return taps


def lpips(params: dict, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """LPIPS distance between two (H, W, 3) images in [0, 1]."""
    x = torch.stack([img1, img2]).permute(0, 3, 1, 2) * 2.0 - 1.0
    shift = x.new_tensor(_SHIFT).view(1, 3, 1, 1)
    scale = x.new_tensor(_SCALE).view(1, 3, 1, 1)
    total = x.new_zeros(())
    for li, f in enumerate(vgg16_features(params, (x - shift) / scale)):
        f = f / f.norm(dim=1, keepdim=True).clamp_min(1e-10)
        d = (f[0] - f[1]) ** 2                     # (c, h, w)
        w = params[f"lin{li}_w"]                   # (c,) 1x1 head, >= 0
        total = total + (d * w[:, None, None]).sum(dim=0).mean()
    return total


def load_params(path: Optional[str] = None, *,
                device: str | torch.device = "cuda") -> Optional[dict]:
    """LPIPS VGG weights from an npz (the `path` argument, the LPIPS_WEIGHTS
    environment variable, or ./lpips_vgg.npz), as tensors on `device`.

    Fails loudly when weights were explicitly requested (a `path` argument
    or LPIPS_WEIGHTS) but cannot be loaded; returns None only for the
    implicit default path, where the caller reports LPIPS as null."""
    explicit = path or os.environ.get("LPIPS_WEIGHTS")
    path = explicit or "lpips_vgg.npz"
    if not os.path.exists(path):
        if explicit:
            raise FileNotFoundError(
                f"LPIPS weights requested ({path}) but not found — export "
                "them with export_weights_from_torch() on a machine with "
                "the pip lpips package, then point LPIPS_WEIGHTS at the npz")
        return None
    raw = dict(np.load(path))
    n_convs = sum(n for _, n in _VGG_STAGES)
    missing = [k for k in
               [f"conv{i}_{s}" for i in range(n_convs) for s in "wb"]
               + [f"lin{i}_w" for i in range(len(_VGG_STAGES))]
               if k not in raw]
    if missing:
        raise ValueError(f"LPIPS npz {path} is missing keys {missing[:4]}"
                         f"{'…' if len(missing) > 4 else ''}")
    out = {}
    for k, v in raw.items():
        if k.startswith("conv") and k.endswith("_w"):
            v = v.transpose(3, 2, 0, 1)            # HWIO -> OIHW
        out[k] = torch.as_tensor(np.ascontiguousarray(v, np.float32),
                                 device=device)
    return out


def write_random_weights(out_path: str, seed: int = 0) -> str:
    """An npz in `load_params`' layout with random weights from a numpy
    seed: He-scaled HWIO convs, small biases, non-negative heads. LPIPS on
    them is a metric of the pipeline, not of perception."""
    rng = np.random.default_rng(seed)
    out, cin, i = {}, 3, 0
    for ch, n_convs in _VGG_STAGES:
        for _ in range(n_convs):
            out[f"conv{i}_w"] = rng.normal(0.0, math.sqrt(2.0 / (9 * cin)),
                                           (3, 3, cin, ch)).astype(np.float32)
            out[f"conv{i}_b"] = rng.normal(0.0, 0.01, ch).astype(np.float32)
            cin, i = ch, i + 1
    for li, (ch, _) in enumerate(_VGG_STAGES):
        out[f"lin{li}_w"] = rng.uniform(0.0, 1.0, ch).astype(np.float32)
    np.savez(out_path, **out)
    return out_path


def export_weights_from_torch(out_path: str = "lpips_vgg.npz"):
    """One-time converter (run where torchvision+lpips are installed):
    dumps VGG16 conv weights (HWIO) + LPIPS v0.1 linear heads to npz."""
    import lpips as lpips_pkg                     # type: ignore
    net = lpips_pkg.LPIPS(net="vgg")
    out = {}
    convs = [m for m in net.net.slice1] + [m for m in net.net.slice2] + \
            [m for m in net.net.slice3] + [m for m in net.net.slice4] + \
            [m for m in net.net.slice5]
    i = 0
    for m in convs:
        if m.__class__.__name__ == "Conv2d":
            out[f"conv{i}_w"] = m.weight.detach().numpy().transpose(
                2, 3, 1, 0)                        # OIHW -> HWIO
            out[f"conv{i}_b"] = m.bias.detach().numpy()
            i += 1
    for li, lin in enumerate(net.lins):
        w = lin.model[-1].weight.detach().numpy()  # (1, C, 1, 1)
        out[f"lin{li}_w"] = w[0, :, 0, 0]
    np.savez(out_path, **out)
    return out_path
