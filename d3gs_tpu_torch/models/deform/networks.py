"""Deformation networks (counterpart of `d3gs_tpu/models/deform/networks.py`,
the reference's utils/time_utils.py):

  * `DeformMLP` — the canonical field, `DeformNetworkBaseline`
    (time_utils.py:56-127): 8×256 ReLU MLP with a skip at D//2,
    PE(x, multires) + PE(t, 6|10), the Blender timenet (PE(t) → 256 → ReLU
    → 30), and heads δx, δr, δs, or with `is_6dof` the screw-axis head whose
    δx is a per-Gaussian SE(3) matrix; with `full_heads=False` (the `warp`
    kind) only δx.
  * `DeformNetworkODE` — dynamics dx/dt = f(t, x) with the five `use_linear`
    ablations and `output_scale` (time_utils.py:331-438).
  * `DeformNetworkSimple` / `DeformNetworkSimpleStart` — tanh encoder /
    decoder dynamics on summed t / y (/ y0) latents (time_utils.py:203-330).

The MLP and ODE nets use nn.Linear's default init bounds, U(±1/√fan_in) for
weight and bias; the tanh nets N(0, 0.2) weights and zero biases. All draw
from an explicit generator. Each net names its layers by their flax paths
(`flax_layers`), so checkpoints carry across in the JAX package's layout.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.transforms import exp_se3


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


def _torch_linear_paths(layers) -> dict[str, nn.Linear]:
    """flax paths of a chain of TorchLinear modules, numbered in creation
    order."""
    return {f"['params']['TorchLinear_{i}']['Dense_0']": lin
            for i, lin in enumerate(layers)}


def _time_column(t, x: torch.Tensor) -> torch.Tensor:
    """t (a number, a 0-d or (N, 1) tensor) as an (N, 1) column."""
    if isinstance(t, torch.Tensor):
        return t.to(x.dtype).reshape(-1, 1).expand(x.shape[0], 1)
    return x.new_full((x.shape[0], 1), float(t))


class DeformMLP(nn.Module):
    """forward(x (N,3), t (N,1) or scalar) -> (d_xyz, d_rot, d_scale);
    d_xyz is (N, 4, 4) SE(3) with is_6dof; with full_heads=False, d_rot =
    d_scale = 0.0."""

    def __init__(self, D: int = 8, W: int = 256, multires: int = 10,
                 is_blender: bool = False, is_6dof: bool = False,
                 full_heads: bool = True, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.D, self.W, self.multires = D, W, multires
        self.is_blender, self.is_6dof = is_blender, is_6dof
        self.full_heads = full_heads
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
        xyz_heads = (3, 3) if is_6dof else (3,)       # (w, v) or δx
        outs = xyz_heads + ((4, 3) if full_heads else ())
        self.heads = nn.ModuleList(
            [lin(W + (self.in_dim if self.skip == D - 1 else 0), o)
             for o in outs])

    def flax_layers(self) -> dict[str, nn.Linear]:
        """Layers by flax path, numbered in creation order: timenet, trunk,
        heads."""
        pre = list(self.timenet) if self.timenet is not None else []
        return _torch_linear_paths(pre + list(self.trunk) + list(self.heads))

    def forward(self, x: torch.Tensor, t):
        t_emb = positional_encoding(_time_column(t, x), self.t_multires)
        if self.timenet is not None:
            t_emb = self.timenet[1](torch.relu(self.timenet[0](t_emb)))
        inp = torch.cat([positional_encoding(x, self.multires), t_emb], dim=-1)
        h = inp
        for i, layer in enumerate(self.trunk):
            h = torch.relu(layer(h))
            if i == self.skip:
                h = torch.cat([inp, h], dim=-1)
        if self.is_6dof:
            w, v = self.heads[0](h), self.heads[1](h)
            theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
            w = w / (theta + 1e-5)
            v = v / (theta + 1e-5)
            d_xyz = exp_se3(torch.cat([w, v], dim=-1), theta[..., 0])
            rest = self.heads[2:]
        else:
            d_xyz, rest = self.heads[0](h), self.heads[1:]
        if not self.full_heads:
            return d_xyz, 0.0, 0.0
        return d_xyz, rest[0](h), rest[1](h)


class DeformNetworkODE(nn.Module):
    """ODE dynamics dx/dt = f(t, x) (time_utils.py:331-438). `use_linear`
    picks an ablation: 0 full MLP, 1 joint linear, 2 time-conditioned affine,
    3 xyz-only linear, 4 z-only linear. forward(t (N,1) or scalar, x (N,3))."""

    def __init__(self, D: int = 8, W: int = 256, multires: int = 10,
                 is_blender: bool = False, use_linear: int = 0,
                 use_emb: bool = True, output_scale: float = 1.0,
                 skips=(4,), *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        if use_linear not in range(5):
            raise ValueError(f"use_linear={use_linear}: expected 0-4")
        self.D, self.W, self.multires = D, W, multires
        self.is_blender, self.use_linear = is_blender, use_linear
        self.use_emb, self.output_scale = use_emb, output_scale
        self.skips = tuple(skips)
        self.t_multires = 6 if is_blender else 10
        lin = lambda i, o: _linear(i, o, generator, device)  # noqa: E731
        x_dim = pe_dim(3, multires) if use_emb else 3
        t_dim = pe_dim(1, self.t_multires) if use_emb else 1
        self.timenet = self.trunk = None
        if use_linear == 1:
            self.linear = nn.ModuleList([lin(x_dim + t_dim, 3)])
        elif use_linear == 2:
            self.linear = nn.ModuleList([lin(t_dim, x_dim * x_dim),
                                         lin(t_dim, x_dim)])
        elif use_linear == 3:
            self.linear = nn.ModuleList([lin(x_dim, 3)])
        elif use_linear == 4:
            self.linear = nn.ModuleList([lin(1, 1)])
        else:
            self.linear = None
            if is_blender:
                self.timenet = nn.ModuleList([lin(t_dim, 256), lin(256, 30)])
                t_dim = 30
            in_dim = x_dim + t_dim
            fan_in = [in_dim] + [
                W + (in_dim if i - 1 in self.skips else 0)
                for i in range(1, D)]
            self.trunk = nn.ModuleList(lin(f, W) for f in fan_in)
            self.out = lin(W + (in_dim if D - 1 in self.skips else 0), 3)

    def flax_layers(self) -> dict[str, nn.Linear]:
        """Layers by flax path, numbered in creation order: the ablation's
        linears, or timenet, trunk, output."""
        if self.linear is not None:
            return _torch_linear_paths(self.linear)
        pre = list(self.timenet) if self.timenet is not None else []
        return _torch_linear_paths(pre + list(self.trunk) + [self.out])

    def forward(self, t, x: torch.Tensor) -> torch.Tensor:
        t = _time_column(t, x)
        if self.use_emb:
            t_emb = positional_encoding(t, self.t_multires)
            x_emb = positional_encoding(x, self.multires)
        else:
            t_emb, x_emb = t, x
        s = self.output_scale
        if self.use_linear == 1:
            return self.linear[0](torch.cat([x_emb, t_emb], dim=-1)) * s
        if self.use_linear == 2:
            d = x_emb.shape[-1]
            A = self.linear[0](t_emb).reshape(-1, d, d)
            b = self.linear[1](t_emb)
            return (torch.einsum("nij,nj->ni", A, x_emb) + b) * s
        if self.use_linear == 3:
            return self.linear[0](x_emb) * s
        if self.use_linear == 4:
            zt = self.linear[0](x_emb[:, 2:3])
            return torch.cat([torch.zeros_like(x_emb[:, :2]), zt], dim=-1) * s
        if self.timenet is not None:
            t_emb = self.timenet[1](torch.relu(self.timenet[0](t_emb)))
        inp = torch.cat([x_emb, t_emb], dim=-1)
        h = inp
        for i, layer in enumerate(self.trunk):
            h = torch.relu(layer(h))
            if i in self.skips:
                h = torch.cat([inp, h], dim=-1)
        return self.out(h) * s


class _TanhStack(nn.Module):
    """Dense → tanh per width, N(0, 0.2) weights, zero biases."""

    def __init__(self, fan_in: int, widths, generator, device):
        super().__init__()
        self.dense = nn.ModuleList()
        for w in widths:
            self.dense.append(_normal_linear(fan_in, w, generator, device))
            fan_in = w

    def forward(self, x):
        for d in self.dense:
            x = torch.tanh(d(x))
        return x


def _normal_linear(fan_in, fan_out, generator, device) -> nn.Linear:
    lin = nn.Linear(fan_in, fan_out, device=device)
    with torch.no_grad():
        lin.weight.normal_(0.0, 0.2, generator=generator)
        lin.bias.zero_()
    return lin


class _TanhDynamics(nn.Module):
    """Summed tanh encodings of the inputs, a tanh decoder and a linear
    output to 3: the shared shape of the two `Simple` nets. `encoders`
    lists (fan_in, widths) in the flax call order."""

    def __init__(self, encoders, decoder, *, generator, device):
        super().__init__()
        self.stacks = nn.ModuleList(
            _TanhStack(f, w, generator, device) for f, w in encoders)
        latent = encoders[0][1][-1]
        self.stacks.append(_TanhStack(latent, decoder, generator, device))
        self.out = _normal_linear(decoder[-1], 3, generator, device)

    def flax_layers(self) -> dict[str, nn.Linear]:
        paths = {f"['params']['_TanhStack_{s}']['Dense_{j}']": d
                 for s, stack in enumerate(self.stacks)
                 for j, d in enumerate(stack.dense)}
        paths["['params']['Dense_0']"] = self.out
        return paths

    def _decode(self, *encoded):
        return self.out(self.stacks[-1](sum(encoded)))


class DeformNetworkSimple(_TanhDynamics):
    """Enc-dec tanh dynamics: latent = net_y(y) + net_t(t)
    (time_utils.py:203-260). forward(t, y)."""

    def __init__(self, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__([(3, (256, 512, 512)), (1, (256, 512, 512))],
                         (512, 256), generator=generator, device=device)

    def forward(self, t, y: torch.Tensor) -> torch.Tensor:
        y_enc = self.stacks[0](y)
        t_enc = self.stacks[1](_time_column(t, y))
        return self._decode(t_enc, y_enc)


class DeformNetworkSimpleStart(_TanhDynamics):
    """The same, conditioned on the trajectory's start state y0
    (time_utils.py:261-330). forward(t, y, y_start)."""

    def __init__(self, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__([(3, (256, 256, 256)), (3, (256, 256)),
                          (1, (256, 256, 256))], (256, 256),
                         generator=generator, device=device)

    def forward(self, t, y: torch.Tensor, y_start: torch.Tensor):
        y_enc = self.stacks[0](y)
        y0_enc = self.stacks[1](y_start)
        t_enc = self.stacks[2](_time_column(t, y))
        return self._decode(t_enc, y_enc, y0_enc)
