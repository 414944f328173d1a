"""Deformation fields: spec, construction, step, optimizer, checkpoints
(counterpart of `d3gs_tpu/models/deform/fields.py`).

Kinds (reference scene/deform_model.py):
  baseline     -> DeformMLP, full δx/δr/δs heads (or the 6DoF head)
  warp         -> DeformMLP, δx only
  ode          -> DeformNetworkODE dynamics integrated from the start time
  simple       -> DeformNetworkSimple dynamics
  simple_start -> DeformNetworkSimpleStart, conditioned on y0

The network's parameters live in its `nn.Module`; `DeformState` holds the
Adam moments beside them, and `DeformField.update` steps the parameters in
place (torch-Adam semantics, eps 1e-15, weight decay added to the gradient).
The ODE kinds integrate with the fixed-step RK4 of `ode.py`; the adaptive
solver raises (ROADMAP.md, Queue 1).

Checkpoints use the JAX package's npz layout — one array per flax leaf,
keyed by `jax.tree_util.keystr` of its path, e.g.
    ['params']['TorchLinear_3']['Dense_0']['kernel']   (in, out)
    ['params']['_TanhStack_1']['Dense_2']['bias']
so a model directory written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from ...ops.schedules import expon_lr
from .networks import (DeformMLP, DeformNetworkODE, DeformNetworkSimple,
                       DeformNetworkSimpleStart)
from .ode import odeint_from_zero, odeint_grid

_DEFORM_LR_SCALE = 5.0   # reference deform.py: position_lr_init x 5

MLP_KINDS = ("baseline", "warp")
ODE_KINDS = ("ode", "simple", "simple_start")


@dataclasses.dataclass(frozen=True)
class DeformFieldSpec:
    kind: str = "baseline"          # baseline | warp | ode | simple |
    #                                 simple_start
    is_blender: bool = False
    is_6dof: bool = False
    D: int = 8
    W: int = 256
    multires: int = 10
    use_linear: int = 0
    use_emb: bool = True
    output_scale: float = 1.0
    skips: tuple = (4,)
    n_substeps: int = 4             # RK4 substeps per grid segment
    solver: str = "rk4"             # rk4 | adaptive (not ported)
    rtol: float = 1e-3              # adaptive-solver tolerances
    atol: float = 1e-4
    compute_dtype: str = "float32"


@dataclasses.dataclass
class DeformState:
    """Adam moments of the field's parameters, in `net.parameters()` order."""
    m: list
    v: list
    count: int = 0


@dataclasses.dataclass
class DeformField:
    spec: DeformFieldSpec
    net: nn.Module
    # learning-rate schedule (reference train_setting: position_lr_init x 5
    # decaying to position_lr_final over deform_lr_max_steps)
    lr_init: float = 1.6e-3
    lr_final: float = 1.6e-6
    lr_delay_mult: float = 0.01
    max_steps: int = 40_000
    weight_decay: float = 0.0

    def _dynamics(self, anchor: torch.Tensor):
        """f(t, y) of the ODE kinds; `simple_start` conditions on `anchor`."""
        if self.spec.kind == "simple_start":
            return lambda t, y: self.net(t, y, anchor)
        return self.net

    def step(self, xyz: torch.Tensor, t, y0: torch.Tensor | None = None):
        """Deformation at the (scalar) time t -> (d_xyz, d_rot, d_scale).
        MLP kinds evaluate the net (`warp` returns 0.0 for d_rot and
        d_scale); ODE kinds integrate xyz from 0 to t with 2·n_substeps RK4
        steps and return absolute positions with zero d_rot, d_scale.
        Differentiable: the render paths call it under `torch.no_grad()`."""
        if self.spec.kind in MLP_KINDS:
            return self.net(xyz, t)
        f = self._dynamics(xyz if y0 is None else y0)
        y = odeint_from_zero(f, xyz, t, n_substeps=2 * self.spec.n_substeps)
        n = xyz.shape[0]
        return y, xyz.new_zeros((n, 4)), xyz.new_zeros((n, 3))

    def step_multi(self, xyz: torch.Tensor, ts, y0: torch.Tensor | None = None):
        """A window of times, ts (T,) sorted (or (N, T) per-sample for the
        ODE kinds) -> (dxs, drs, dss) stacked over T. MLP kinds evaluate
        each time on its own; ODE kinds integrate one trajectory anchored
        at ts[0] with state xyz (torchode's InitialValueProblem semantics,
        deform_model.py:26-33)."""
        if self.spec.kind in MLP_KINDS:
            outs = [self.net(xyz, t) for t in ts]
            return tuple(torch.stack(o) if isinstance(o[0], torch.Tensor)
                         else o[0] for o in zip(*outs))
        f = self._dynamics(xyz if y0 is None else y0)
        ys = odeint_grid(f, xyz, ts, n_substeps=self.spec.n_substeps)
        T, n = ys.shape[:2]
        return ys, xyz.new_zeros((T, n, 4)), xyz.new_zeros((T, n, 3))

    def init_state(self) -> DeformState:
        params = list(self.net.parameters())
        return DeformState(m=[torch.zeros_like(p) for p in params],
                           v=[torch.zeros_like(p) for p in params])

    def lr_at(self, iteration) -> float:
        return expon_lr(iteration, lr_init=self.lr_init,
                        lr_final=self.lr_final,
                        lr_delay_mult=self.lr_delay_mult,
                        max_steps=self.max_steps)

    @torch.no_grad()
    def update(self, state: DeformState, grads, iteration) -> DeformState:
        """One Adam step of the network's parameters, in place; returns the
        new moments."""
        lr = self.lr_at(iteration)
        count = state.count + 1
        c1 = 1.0 - 0.9 ** count
        c2 = 1.0 - 0.999 ** count
        new_m, new_v = [], []
        for p, g, m, v in zip(self.net.parameters(), grads, state.m,
                              state.v):
            if self.weight_decay:
                g = g + self.weight_decay * p
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + 1e-15))
            new_m.append(m)
            new_v.append(v)
        return DeformState(m=new_m, v=new_v, count=count)


def _build_network(spec: DeformFieldSpec, gen: torch.Generator) -> nn.Module:
    if spec.kind in MLP_KINDS:
        return DeformMLP(D=spec.D, W=spec.W, multires=spec.multires,
                         is_blender=spec.is_blender, is_6dof=spec.is_6dof,
                         full_heads=spec.kind == "baseline", generator=gen)
    if spec.kind == "ode":
        return DeformNetworkODE(D=spec.D, W=spec.W, multires=spec.multires,
                                is_blender=spec.is_blender,
                                use_linear=spec.use_linear,
                                use_emb=spec.use_emb,
                                output_scale=spec.output_scale,
                                skips=spec.skips, generator=gen)
    if spec.kind == "simple":
        return DeformNetworkSimple(generator=gen)
    if spec.kind == "simple_start":
        return DeformNetworkSimpleStart(generator=gen)
    raise ValueError(f"unknown deform kind {spec.kind!r}")


def create_deform_field(spec: DeformFieldSpec, *, seed: int = 0,
                        device: str | torch.device = "cuda",
                        opt_cfg=None) -> DeformField:
    """A freshly initialized field (weights drawn from torch.Generator(seed)),
    with the learning-rate schedule of `opt_cfg` (the defaults of the JAX
    package without one)."""
    if spec.solver == "adaptive":
        raise NotImplementedError(
            "solver='adaptive' (Dopri5 with per-sample controllers) is not "
            "ported yet (ROADMAP.md, Queue 1: the adaptive ODE solver); use "
            "the fixed-step 'rk4'")
    if spec.solver != "rk4":
        raise ValueError(f"unknown ODE solver {spec.solver!r} (expected "
                         "'rk4' or 'adaptive')")
    if spec.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={spec.compute_dtype!r}: the port runs the deform "
            "nets in float32 only (ROADMAP.md, Queue 1: bf16 deform_dtype)")
    gen = torch.Generator().manual_seed(seed)
    field = DeformField(spec=spec, net=_build_network(spec, gen).to(device))
    if opt_cfg is not None:
        k = opt_cfg.num_cams_per_iter if opt_cfg.scale_lr else 1
        field.lr_init = opt_cfg.position_lr_init * _DEFORM_LR_SCALE * k
        field.lr_final = opt_cfg.position_lr_final * k
        field.lr_delay_mult = opt_cfg.position_lr_delay_mult
        field.max_steps = opt_cfg.deform_lr_max_steps
        field.weight_decay = opt_cfg.weight_decay
    return field


def params_from_flax(npz: dict, net: nn.Module) -> dict[str, torch.Tensor]:
    """A state_dict for `net` from flax leaves in the npz layout. Layers
    map by their flax paths (`net.flax_layers()`), not by sorted key order;
    kernels are (in, out) and are transposed."""
    layers = net.flax_layers()
    want = {p + f"['{leaf}']" for p in layers for leaf in ("kernel", "bias")}
    if set(npz) != want:
        raise KeyError(
            f"deform checkpoint keys do not match the network: unexpected "
            f"{sorted(set(npz) - want)}, missing {sorted(want - set(npz))}")
    names = {id(mod): name for name, mod in net.named_modules()}
    state = {}
    for prefix, mod in layers.items():
        kernel = np.array(npz[prefix + "['kernel']"], np.float32)
        bias = np.array(npz[prefix + "['bias']"], np.float32)
        if kernel.shape != (mod.in_features, mod.out_features):
            raise ValueError(f"{prefix}: kernel {kernel.shape}, expected "
                             f"{(mod.in_features, mod.out_features)}")
        state[names[id(mod)] + ".weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.T))
        state[names[id(mod)] + ".bias"] = torch.from_numpy(bias)
    return state


def flax_from_params(net: nn.Module) -> dict[str, np.ndarray]:
    """Inverse of `params_from_flax`: the npz layout of `net`'s weights."""
    out = {}
    for prefix, mod in net.flax_layers().items():
        out[prefix + "['kernel']"] = mod.weight.detach().cpu().numpy().T.copy()
        out[prefix + "['bias']"] = mod.bias.detach().cpu().numpy().copy()
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
