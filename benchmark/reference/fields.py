"""Plain deformation fields: the deformable-3DGS MLP (Yang et al. 2024,
utils/time_utils.py DeformNetwork) and the neural-ODE fork's dynamics net
(DeformNetworkODE, use_linear 0) with its fixed-step RK4.

A field is a list of (weight (out, in), bias) pairs in the order the
networks create them: the Blender time net's two layers, the D trunk
layers, then the heads (d_xyz, d_rotation, d_scaling) or the ODE's output.
`layer_shapes` gives that list's (in, out) from a configuration's field
sizes.

    PE(v, L) = [v, sin(2^0 v), cos(2^0 v), ..., sin(2^(L-1) v), cos(...)]
    t_emb    = Linear(ReLU(Linear(PE(t, 6))))            (Blender scenes)
    h_0      = [PE(x, multires), t_emb]
    h_{i+1}  = ReLU(W_i h_i + b_i), with h_0 concatenated after layer
               `skip` (D/2 in the MLP, 4 in the ODE net)
    MLP:  d_xyz, d_rot, d_scale = the three heads of h_D
    ODE:  dx/dt = output_scale * Linear(h_D)

The RK4 integrates from t0 to t1 in n equal steps, the times in float32
as a host would compute them; the ODE trainer's trajectory runs through a
batch's sorted times from the first, and the viewer's from 0 to t.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pe_dim(d: int, freqs: int) -> int:
    return d * (1 + 2 * freqs)


def encode(v: torch.Tensor, freqs: int) -> torch.Tensor:
    bands = [v]
    for i in range(freqs):
        bands += [torch.sin(v * 2.0 ** i), torch.cos(v * 2.0 ** i)]
    return torch.cat(bands, dim=-1)


def layer_shapes(field: dict) -> list[tuple[int, int]]:
    """(in, out) of each layer of the field of a configuration
    (`field`: kind, D, W, multires, is_blender)."""
    D, W = field["D"], field["W"]
    t_freqs = 6 if field["is_blender"] else 10
    t_dim = pe_dim(1, t_freqs)
    shapes = []
    if field["is_blender"]:
        shapes += [(t_dim, 256), (256, 30)]
        t_dim = 30
    in_dim = pe_dim(3, field["multires"]) + t_dim
    skip = field["skip"]
    shapes += [(in_dim if i == 0 else W + (in_dim if i == skip + 1 else 0), W)
               for i in range(D)]
    heads = (3, 4, 3) if field["kind"] == "baseline" else (3,)
    return shapes + [(W + (in_dim if skip == D - 1 else 0), o)
                     for o in heads]


def trunk(weights, field: dict, x: torch.Tensor, t) -> torch.Tensor:
    """h_D for points x (N, 3) at time t (a number, or (N, 1))."""
    t_freqs = 6 if field["is_blender"] else 10
    tcol = (t.reshape(-1, 1).expand(x.shape[0], 1) if torch.is_tensor(t)
            else x.new_full((x.shape[0], 1), float(t)))
    t_emb = encode(tcol, t_freqs)
    layers = list(weights)
    if field["is_blender"]:
        (w0, b0), (w1, b1) = layers[:2]
        t_emb = F.linear(F.relu(F.linear(t_emb, w0, b0)), w1, b1)
        layers = layers[2:]
    inp = torch.cat([encode(x, field["multires"]), t_emb], dim=-1)
    h = inp
    skip = field["skip"]
    for i, (w, b) in enumerate(layers[:field["D"]]):
        h = F.relu(F.linear(h, w, b))
        if i == skip:
            h = torch.cat([inp, h], dim=-1)
    return h


def mlp(weights, field: dict, x: torch.Tensor, t):
    """The deformation MLP -> (d_xyz, d_rotation, d_scaling)."""
    h = trunk(weights, field, x, t)
    heads = list(weights)[-3:]
    return tuple(F.linear(h, w, b) for w, b in heads)


def dynamics(weights, field: dict):
    """f(t, x) of the ODE field."""
    w, b = list(weights)[-1]
    scale = field.get("output_scale", 1.0)
    return lambda t, x: F.linear(trunk(weights, field, x, t), w, b) * scale


def _rk4(f, y: torch.Tensor, t0, t1, n: int) -> torch.Tensor:
    """n RK4 steps from t0 to t1 (numbers); t0 == t1 returns y."""
    h0, h1 = np.float32(t0), np.float32(t1)
    if h0 == h1:
        return y
    dt = np.float32((h1 - h0) / np.float32(n))
    for i in range(n):
        t, h = float(np.float32(h0 + dt * np.float32(i))), float(dt)
        k1 = f(t, y)
        k2 = f(t + h * 0.5, y + 0.5 * h * k1)
        k3 = f(t + h * 0.5, y + 0.5 * h * k2)
        k4 = f(t + h, y + h * k3)
        y = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return y


def trajectory(f, y0: torch.Tensor, times, substeps: int) -> torch.Tensor:
    """States (T, N, 3) at the sorted `times`, y0 at times[0], `substeps`
    RK4 steps between consecutive times."""
    ys = [y0]
    for t0, t1 in zip(times[:-1], times[1:]):
        ys.append(_rk4(f, ys[-1], t0, t1, substeps))
    return torch.stack(ys)


def from_zero(f, y0: torch.Tensor, t, substeps: int) -> torch.Tensor:
    """The state at t, integrated from y0 at 0."""
    return _rk4(f, y0, 0.0, t, substeps)
