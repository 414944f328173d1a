"""Deformation MLP (counterpart of `d3gs_tpu/models/deform/networks.py`
`DeformMLP`, the reference's time_utils.py:56-127 `DeformNetworkBaseline`).

8×256 ReLU MLP with a skip at D//2, PE(x, multires) + PE(t, 6|10), the
Blender timenet (PE(t) → 256 → ReLU → 30), and heads δx, δr, δs; with
`full_heads=False` (the `warp` kind) only δx. Layers use nn.Linear's default
init bounds, U(±1/√fan_in) for weight and bias, drawn from an explicit
generator.
"""
from __future__ import annotations

import torch
from torch import nn


def positional_encoding(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """NeRF PE: [x, then per frequency 2^i: sin(x·2^i) for the d dims,
    cos(x·2^i) for the d dims]."""
    if num_freqs <= 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]              # (..., m, d)
    enc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


def pe_dim(d: int, num_freqs: int) -> int:
    return d * (1 + 2 * num_freqs) if num_freqs > 0 else d


def _linear(fan_in: int, fan_out: int, generator: torch.Generator | None,
            device) -> nn.Linear:
    lin = nn.Linear(fan_in, fan_out, device=device)
    bound = fan_in ** -0.5
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


class DeformMLP(nn.Module):
    """forward(x (N,3), t (N,1) or scalar) -> (d_xyz, d_rot, d_scale); with
    full_heads=False, d_rot = d_scale = 0.0."""

    def __init__(self, D: int = 8, W: int = 256, multires: int = 10,
                 is_blender: bool = False, is_6dof: bool = False,
                 full_heads: bool = True, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if is_6dof:
            raise NotImplementedError(
                "the 6DoF deform head is not ported yet (ROADMAP.md, "
                "Queue 1: flagship / neural-ODE slice)")
        self.D, self.W, self.multires = D, W, multires
        self.is_blender, self.full_heads = is_blender, full_heads
        self.t_multires = 6 if is_blender else 10
        lin = lambda i, o: _linear(i, o, generator, device)  # noqa: E731
        t_dim = pe_dim(1, self.t_multires)
        # creation order = the flax module numbering TorchLinear_<i>
        if is_blender:
            self.timenet = nn.ModuleList([lin(t_dim, 256), lin(256, 30)])
            t_dim = 30
        else:
            self.timenet = None
        self.in_dim = pe_dim(3, multires) + t_dim
        self.skip = D // 2
        dims = [self.in_dim] + [W] * D
        self.trunk = nn.ModuleList(
            lin(dims[i] + (self.in_dim if i == self.skip + 1 else 0), W)
            for i in range(D))
        self.heads = nn.ModuleList(
            [lin(W + (self.in_dim if self.skip == D - 1 else 0), o)
             for o in ((3, 4, 3) if full_heads else (3,))])

    def layers(self) -> list[nn.Linear]:
        """All layers in flax numbering order (TorchLinear_0, _1, ...)."""
        pre = list(self.timenet) if self.timenet is not None else []
        return pre + list(self.trunk) + list(self.heads)

    def forward(self, x: torch.Tensor, t):
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        t = t.reshape(-1, 1).expand(x.shape[0], 1)
        t_emb = positional_encoding(t, self.t_multires)
        if self.timenet is not None:
            t_emb = self.timenet[1](torch.relu(self.timenet[0](t_emb)))
        inp = torch.cat([positional_encoding(x, self.multires), t_emb], dim=-1)
        h = inp
        for i, layer in enumerate(self.trunk):
            h = torch.relu(layer(h))
            if i == self.skip:
                h = torch.cat([inp, h], dim=-1)
        if not self.full_heads:
            return self.heads[0](h), 0.0, 0.0
        return tuple(head(h) for head in self.heads)
