"""The plain reference that decides a run's `correct`.

Plain PyTorch in float32, written from the published equations of
deformable 3D Gaussian splatting (Kerbl et al. 2023's rasterizer, Yang et
al. 2024's deformation network, the neural-ODE fork's dynamics), with no
kernels, no binning by sort, no checkpointing and no fused optimizer. It
imports nothing of the program and takes nothing the program made: it is
handed the benchmark's own scene, weights and cameras, and works out the
projection, the tiles' lists, the compositing, the ODE states and the
gradients again, in blocks where they would not fit at once.

`precision(tf32=...)` sets the matmul and cuDNN precision for a block of
reference work: off for the reference, on for the control (TF32, the
precision below the configurations' float32).
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Matmuls and convolutions in TF32 (`tf32=True`) or in full float32
    inside the block; the previous settings come back after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
