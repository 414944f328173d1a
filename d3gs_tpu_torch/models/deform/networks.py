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

`DeformMLP(compute_dtype="bfloat16")` is the JAX package's bf16 compute
dtype (flax `Dense(dtype=bfloat16)`): the parameters stay float32 and are
cast to bf16 at each forward, each product rounds to bf16 before its bias
is added in bf16, the activations are bf16, the positional encodings are
computed in float32 and then cast, and the heads come back as float32.
The products stay dense matmuls (cuBLAS on the card). The JAX package
accepts any dtype string on any net: it ignores it for the ODE nets and
reads every string but "bfloat16" as float32. Here only DeformMLP takes a
compute dtype, and `fields.create_deform_field` raises ValueError for an
ODE kind with bf16 and for any string but "float32" / "bfloat16".
"""
from __future__ import annotations

import torch
from torch import nn

from ... import tracing
from ...ops import mlp_field
from ...ops.encoding import positional_encoding
from ...ops.transforms import exp_se3

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    d_scale = 0.0. The outputs are float32 for either compute dtype.

    An evaluation that `ops/mlp_field.py::engages` (f32, 8x256, not 6DoF,
    a CUDA x that takes no gradient, a host-number t) runs the fused
    kernels there, under autograd through `_FusedMLP`; every other runs
    the layers below. Each evaluation counts `deform.mlp.evals`, each fused
    one `deform.mlp.fused` besides."""

    def __init__(self, D: int = 8, W: int = 256, multires: int = 10,
                 is_blender: bool = False, is_6dof: bool = False,
                 full_heads: bool = True, compute_dtype: str = "float32", *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.D, self.W, self.multires = D, W, multires
        self.is_blender, self.is_6dof = is_blender, is_6dof
        self.full_heads = full_heads
        self.dtype = COMPUTE_DTYPES[compute_dtype]
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

    def _lin(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """layer(x) in the compute dtype: in bf16 the product rounds to bf16
        and the bias is added in bf16, as flax's Dense does."""
        if self.dtype == torch.float32:
            return layer(x)
        w, b = layer.weight.to(self.dtype), layer.bias.to(self.dtype)
        return torch.matmul(x.to(self.dtype), w.T) + b

    def forward(self, x: torch.Tensor, t):
        tracing.count("deform.mlp.evals")
        if mlp_field.engages(self, x, t):
            tracing.count("deform.mlp.fused")
            heads = mlp_field.evaluate(self, x, t)
            return heads if self.full_heads else (heads[0], 0.0, 0.0)
        lin = self._lin
        t_emb = positional_encoding(_time_column(t, x), self.t_multires)
        if self.timenet is not None:
            t_emb = lin(self.timenet[1], torch.relu(lin(self.timenet[0],
                                                         t_emb)))
        inp = torch.cat([positional_encoding(x, self.multires).to(self.dtype),
                         t_emb.to(self.dtype)], dim=-1)
        h = inp
        for i, layer in enumerate(self.trunk):
            h = torch.relu(lin(layer, h))
            if i == self.skip:
                h = torch.cat([inp, h], dim=-1)
        head = lambda layer: lin(layer, h).float()  # noqa: E731
        if self.is_6dof:
            w, v = head(self.heads[0]), head(self.heads[1])
            theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
            w = w / (theta + 1e-5)
            v = v / (theta + 1e-5)
            d_xyz = exp_se3(torch.cat([w, v], dim=-1), theta[..., 0])
            rest = self.heads[2:]
        else:
            d_xyz, rest = head(self.heads[0]), self.heads[1:]
        if not self.full_heads:
            return d_xyz, 0.0, 0.0
        return d_xyz, head(rest[0]), head(rest[1])


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
