"""NeRF's positional encoding, for the deformation networks
(`models/deform/networks.py`) and the fused kernels' plain versions
(`ops/ode_rk4.py`, `ops/mlp_field.py`)."""
from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """NeRF PE: [x, then per frequency 2^i: sin(x·2^i) for the d dims,
    cos(x·2^i) for the d dims]."""
    if num_freqs <= 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]              # (..., m, d)
    enc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)
