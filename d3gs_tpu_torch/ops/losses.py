"""Image losses and metrics: L1, MSE, PSNR and windowed SSIM (counterpart of
`d3gs_tpu/ops/losses.py`, the reference's utils/loss_utils.py and
utils/image_utils.py).

Images are (H, W, C) float in [0, 1]. SSIM uses the reference's 11x11
window, sigma 1.5, C1 = 0.01², C2 = 0.03², zero SAME padding. The
separable blur is two f32 matmuls with banded matrices, as in the JAX
package: SSIM's variances are blur(x²) − μ², a cancellation that reduced
precision turns into negative variances, so TF32 must stay off
(`d3gs_tpu_torch/__init__.py`); plain `torch.matmul` then runs in full f32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the whole image, with the MSE
    floored at 1e-20."""
    m = mse(pred, target)
    return 20.0 * torch.log10(1.0 / torch.sqrt(m.clamp_min(1e-20)))


@functools.lru_cache(maxsize=8)
def _band_matrix(dim: int, size: int, sigma: float) -> np.ndarray:
    """(dim, dim) banded Gaussian blur matrix; rows cut at the border are
    the zero SAME padding."""
    x = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    b = np.zeros((dim, dim), np.float32)
    half = size // 2
    for o in range(-half, half + 1):
        b += np.eye(dim, k=o, dtype=np.float32) * g[o + half]
    return b


def _blur(img: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    h, w = img.shape[0], img.shape[1]
    bh = torch.from_numpy(_band_matrix(h, size, sigma)).to(img.device)
    bw = torch.from_numpy(_band_matrix(w, size, sigma)).to(img.device)
    x = torch.einsum("Hh,hwc->Hwc", bh, img)
    return torch.einsum("hwc,wW->hWc", x, bw)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
             sigma: float = 1.5) -> torch.Tensor:
    """Per-pixel SSIM of an (H, W, C) pair; the five blurred maps come from
    one pair of matmuls over the channel-stacked images."""
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                      dim=-1)
    blurred = _blur(stack, window_size, sigma)
    c = img1.shape[-1]
    mu1, mu2 = blurred[..., 0:c], blurred[..., c:2 * c]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blurred[..., 2 * c:3 * c] - mu1_sq
    sigma2_sq = blurred[..., 3 * c:4 * c] - mu2_sq
    sigma12 = blurred[..., 4 * c:5 * c] - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) pair."""
    return ssim_map(img1, img2, window_size, sigma).mean()
