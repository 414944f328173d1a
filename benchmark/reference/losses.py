"""The photometric loss of the trainers: (1 - lambda) L1 + lambda (1 -
SSIM), SSIM with an 11x11 Gaussian window of sigma 1.5, zero padding and
C1 = 0.01^2, C2 = 0.03^2 (the reference's utils/loss_utils.py, a grouped
2D convolution)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _window(size: int, sigma: float, channels: int, device):
    g = torch.tensor([math.exp(-(x - size // 2) ** 2 / (2 * sigma ** 2))
                      for x in range(size)], device=device)
    g = g / g.sum()
    return (g[:, None] * g[None, :]).expand(channels, 1, size, size) \
        .contiguous()


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images."""
    x, y = a.permute(2, 0, 1)[None], b.permute(2, 0, 1)[None]
    c = x.shape[1]
    w = _window(11, 1.5, c, a.device)
    blur = lambda v: F.conv2d(v, w, padding=5, groups=c)  # noqa: E731
    mu1, mu2 = blur(x), blur(y)
    s11 = blur(x * x) - mu1 * mu1
    s22 = blur(y * y) - mu2 * mu2
    s12 = blur(x * y) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2)
    return (num / den).mean()


def photometric(image: torch.Tensor, target: torch.Tensor,
                lambda_dssim: float) -> torch.Tensor:
    l1 = (image - target).abs().mean()
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(image,
                                                                   target))
