"""d3gs_tpu_torch — the PyTorch/CUDA port of d3gs_tpu for NVIDIA Hopper.

The package mirrors `d3gs_tpu/` module by module. It imports torch and never
jax, nor anything of `d3gs_tpu`: the modules it needs from there (config,
PLY I/O, camera math) are kept here as copies.

Entry points run on the card (`cuda`) unless the caller asks for the CPU.
They never drop to the CPU on their own: `resolve_device` raises when CUDA
is asked for and missing.
"""
from __future__ import annotations

import torch

# Full f32 matmuls and convolutions. The deform MLP drives every Gaussian's
# position, and SSIM (once training lands) subtracts blurred squares: with
# reduced-precision passes in those contractions the JAX package saw SSIM
# read 6.6 and deform-phase training diverge (README "Training numerics").
# TF32 keeps ~3 decimal digits, the same class of error. cudnn's flag
# defaults to on.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for `device`; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
