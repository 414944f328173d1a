"""Deformation fields: spec, construction, step, checkpoints (counterpart of
`d3gs_tpu/models/deform/fields.py`, render path only).

Checkpoints use the JAX package's npz layout — one array per flax leaf,
keyed by `jax.tree_util.keystr` of its path, e.g.
    ['params']['TorchLinear_3']['Dense_0']['kernel']   (in, out)
so a model directory written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from .networks import DeformMLP

_FLAX_KEY = re.compile(
    r"\['params'\]\['TorchLinear_(\d+)'\]\['Dense_0'\]\['(kernel|bias)'\]")


@dataclasses.dataclass(frozen=True)
class DeformFieldSpec:
    """The JAX spec's fields that the MLP kinds read (the ODE fields come
    with the ODE kinds)."""
    kind: str = "baseline"          # baseline | warp (ode kinds: not ported)
    is_blender: bool = False
    is_6dof: bool = False
    D: int = 8
    W: int = 256
    multires: int = 10
    compute_dtype: str = "float32"


@dataclasses.dataclass
class DeformField:
    spec: DeformFieldSpec
    net: DeformMLP

    @torch.no_grad()
    def step(self, xyz: torch.Tensor, t):
        """Deformation at (scalar) time t -> (d_xyz, d_rot, d_scale); the
        `warp` kind returns 0.0 for d_rot and d_scale."""
        return self.net(xyz, t)


def create_deform_field(spec: DeformFieldSpec, *, seed: int = 0,
                        device: str | torch.device = "cuda") -> DeformField:
    """A freshly initialized field (weights drawn from torch.Generator(seed))."""
    if spec.kind not in ("baseline", "warp"):
        raise NotImplementedError(
            f"deform kind {spec.kind!r} (neural ODE) is not ported yet "
            "(ROADMAP.md, Queue 1: flagship / neural-ODE slice)")
    if spec.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={spec.compute_dtype!r}: the port runs the deform "
            "MLP in float32 only")
    gen = torch.Generator().manual_seed(seed)
    net = DeformMLP(D=spec.D, W=spec.W, multires=spec.multires,
                    is_blender=spec.is_blender, is_6dof=spec.is_6dof,
                    full_heads=spec.kind == "baseline", generator=gen)
    return DeformField(spec=spec, net=net.to(device))


def params_from_flax(npz: dict, net: DeformMLP) -> dict[str, torch.Tensor]:
    """A state_dict for `net` from flax leaves in the npz layout. Layers
    map by the integer in TorchLinear_<i> (flax creation order: timenet,
    trunk, heads), not by sorted key order; kernels are (in, out) and are
    transposed."""
    layers = {}
    for key, arr in npz.items():
        m = _FLAX_KEY.fullmatch(key)
        if m is None:
            raise KeyError(f"unexpected deform checkpoint key {key!r}")
        layers.setdefault(int(m.group(1)), {})[m.group(2)] = np.asarray(arr)
    names = {id(mod): name for name, mod in net.named_modules()}
    mods = net.layers()
    if sorted(layers) != list(range(len(mods))):
        raise KeyError(f"checkpoint has layers {sorted(layers)}, the network "
                       f"expects TorchLinear_0..{len(mods) - 1}")
    state = {}
    for i, mod in enumerate(mods):
        kernel, bias = layers[i]["kernel"], layers[i]["bias"]
        if kernel.shape != (mod.in_features, mod.out_features):
            raise ValueError(f"TorchLinear_{i}: kernel {kernel.shape}, "
                             f"expected {(mod.in_features, mod.out_features)}")
        state[names[id(mod)] + ".weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.T, np.float32))
        state[names[id(mod)] + ".bias"] = torch.from_numpy(
            np.array(bias, np.float32))
    return state


def flax_from_params(net: DeformMLP) -> dict[str, np.ndarray]:
    """Inverse of `params_from_flax`: the npz layout of `net`'s weights."""
    out = {}
    for i, mod in enumerate(net.layers()):
        pre = f"['params']['TorchLinear_{i}']['Dense_0']"
        out[pre + "['kernel']"] = mod.weight.detach().cpu().numpy().T.copy()
        out[pre + "['bias']"] = mod.bias.detach().cpu().numpy().copy()
    return out


def _iteration_dir(model_path: str, iteration: int) -> str:
    base = os.path.join(model_path, "deform")
    if iteration == -1:
        iteration = max(int(d.split("_")[-1]) for d in os.listdir(base)
                        if d.startswith("iteration_"))
    return os.path.join(base, f"iteration_{iteration}")


def save_deform_weights(model_path: str, iteration: int, field: DeformField):
    out_dir = _iteration_dir(model_path, iteration)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "deform.npz"), **flax_from_params(field.net))


def load_deform_weights(model_path: str, field: DeformField,
                        iteration: int = -1) -> DeformField:
    """Load deform/iteration_<i>/deform.npz (latest for -1) into `field`."""
    path = os.path.join(_iteration_dir(model_path, iteration), "deform.npz")
    with np.load(path) as data:
        state = params_from_flax(dict(data), field.net)
    field.net.load_state_dict(state)
    return field
