"""Explicit 3D-Gaussian state: parameters, Adam moments, densification
(counterpart of `d3gs_tpu/models/gaussians.py`, the reference's
scene/gaussian_model.py).

The padded capacity and the `alive` mask of the JAX state are kept, so a
state carried across from JAX compares slot by slot: densification writes
children into free slots by rank instead of growing tensors, and the
hand-written Adam's moments live beside the parameters, so the optimizer
surgery of a densify pass is the same masked write applied to m and v.
Parameters are the reference's pre-activation storage:
  xyz (C,3) · features_dc (C,1,3) · features_rest (C,K-1,3) ·
  scaling (C,3, log) · rotation (C,4, unnormalized wxyz) · opacity (C,1, logit)

Every function returns a new state and leaves its input as it was.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.knn import knn_log_scales
from ..ops.schedules import expon_lr
from ..ops.sh import rgb2sh
from ..ops.transforms import inverse_sigmoid, quat_normalize, quat_to_rotmat_cols

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity")

# Gaussians removed by `densify_and_prune` since import (or since a caller
# last reset them), by the rule that removed them: `low_opacity`, or
# `oversized` (over max_screen_size on screen or 0.1·extent in the world,
# and not low in opacity); split sources, replaced by a child, count in
# neither
pruned = {"low_opacity": 0, "oversized": 0}


class GaussianParams(NamedTuple):
    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor


class AdamState(NamedTuple):
    m: GaussianParams
    v: GaussianParams
    count: int          # steps taken (shared by the six groups)


def _zeros_like(p: GaussianParams) -> GaussianParams:
    return GaussianParams(*(torch.zeros_like(x) for x in p))


@dataclasses.dataclass
class GaussianState:
    params: GaussianParams
    alive: torch.Tensor            # (C,) bool
    active_sh_degree: int
    max_sh_degree: int
    # densification statistics (reference :398-401)
    grad_accum: torch.Tensor       # (C,) accumulated |dL/dmean2d|
    denom: torch.Tensor            # (C,) visible count
    max_radii2d: torch.Tensor      # (C,) f32
    opt: AdamState
    spatial_lr_scale: float = 1.0

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    @property
    def num_alive(self) -> int:
        return int(self.alive.sum())

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.params.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        return quat_normalize(self.params.rotation)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity)

    @property
    def get_features(self) -> torch.Tensor:
        return torch.cat([self.params.features_dc,
                          self.params.features_rest], dim=1)


def round_capacity(n: int) -> int:
    """The JAX package's padded buffer size for n Gaussians."""
    return max(1024, int(np.ceil(n / 1024)) * 1024)


def gaussians_from_numpy(params: dict[str, np.ndarray], alive: np.ndarray,
                         active_sh_degree: int, max_sh_degree: int,
                         device: str | torch.device,
                         spatial_lr_scale: float = 1.0) -> GaussianState:
    """Carry a (JAX or file) state across: numpy arrays keyed by the six
    parameter names, the alive mask, and the SH degrees. Statistics and
    moments start at zero."""
    p = GaussianParams(**{k: torch.as_tensor(np.asarray(params[k], np.float32),
                                             device=device)
                          for k in PARAM_NAMES})
    zeros = lambda: torch.zeros(p.xyz.shape[0], device=device)  # noqa: E731
    return GaussianState(
        params=p, alive=torch.as_tensor(np.asarray(alive, bool), device=device),
        active_sh_degree=int(active_sh_degree),
        max_sh_degree=int(max_sh_degree), grad_accum=zeros(), denom=zeros(),
        max_radii2d=zeros(), opt=AdamState(_zeros_like(p), _zeros_like(p), 0),
        spatial_lr_scale=float(spatial_lr_scale))


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def create_from_pcd(points: np.ndarray, colors: np.ndarray, *,
                    sh_degree: int = 3, spatial_lr_scale: float = 1.0,
                    max_gaussians: int = 500_000, capacity: int = 0,
                    seed: int = 0,
                    device: str | torch.device = "cuda") -> GaussianState:
    """Initialise from a point cloud (reference create_from_pcd :87-118):
    subsample to max_gaussians (numpy seed), DC colour from RGB, scales from
    the 3-NN mean squared distance (on `device`), identity rotations,
    opacity 0.1, capacity rounded up to a multiple of 1024."""
    n_total = points.shape[0]
    if n_total > max_gaussians:
        sel = np.random.default_rng(seed).choice(n_total, max_gaussians,
                                                 replace=False)
        points, colors = points[sel], colors[sel]
    n = points.shape[0]
    cap = capacity or round_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} points")
    k = (sh_degree + 1) ** 2

    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n] = points
    f_dc = np.zeros((cap, 1, 3), np.float32)
    f_dc[:n, 0] = rgb2sh(colors.astype(np.float32))
    scaling = np.zeros((cap, 3), np.float32)
    scaling[:n] = knn_log_scales(torch.as_tensor(
        np.asarray(points, np.float32), device=device)).cpu().numpy()
    rotation = np.zeros((cap, 4), np.float32)
    rotation[:, 0] = 1.0
    opacity = np.full((cap, 1), float(inverse_sigmoid(torch.tensor(0.1))),
                      np.float32)
    params = {"xyz": xyz, "features_dc": f_dc,
              "features_rest": np.zeros((cap, k - 1, 3), np.float32),
              "scaling": scaling, "rotation": rotation, "opacity": opacity}
    return gaussians_from_numpy(params, np.arange(cap) < n, 0, sh_degree,
                                device, spatial_lr_scale=spatial_lr_scale)


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Re-pad every per-Gaussian buffer to a larger capacity: new rows are
    dead, with identity quaternions and zero moments (the counterpart of
    the reference's growing tensors, taken when densification fills ~90 %
    of the buffer)."""
    cap = state.capacity
    if new_capacity < cap:
        raise ValueError(f"cannot shrink capacity {cap} -> {new_capacity}")
    pad = new_capacity - cap
    if pad == 0:
        return state

    def grow(x, fill=0):
        return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])

    params = GaussianParams(*(grow(p) for p in state.params))
    params.rotation[cap:, 0] = 1.0
    opt = AdamState(GaussianParams(*(grow(m) for m in state.opt.m)),
                    GaussianParams(*(grow(v) for v in state.opt.v)),
                    state.opt.count)
    return dataclasses.replace(
        state, params=params, opt=opt, alive=grow(state.alive, False),
        grad_accum=grow(state.grad_accum), denom=grow(state.denom),
        max_radii2d=grow(state.max_radii2d))


def oneup_sh_degree(state: GaussianState) -> GaussianState:
    return dataclasses.replace(state, active_sh_degree=min(
        state.active_sh_degree + 1, state.max_sh_degree))


# ---------------------------------------------------------------------------
# optimizer: torch-semantics Adam with per-group learning rates
# ---------------------------------------------------------------------------

def group_learning_rates(opt_cfg, step, spatial_lr_scale: float) -> GaussianParams:
    """Per-group learning rates at `step` (reference training_setup
    :120-152): xyz on the expon schedule scaled by the camera extent,
    f_rest at feature_lr / 20. Python floats."""
    xyz_lr = expon_lr(
        step, lr_init=opt_cfg.position_lr_init * spatial_lr_scale,
        lr_final=opt_cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps)
    return GaussianParams(
        xyz=xyz_lr, features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        scaling=opt_cfg.scaling_lr, rotation=opt_cfg.rotation_lr,
        opacity=opt_cfg.opacity_lr)


def adam_step(params: GaussianParams, grads: GaussianParams, opt: AdamState,
              lrs: GaussianParams, *, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-15,
              mask: torch.Tensor | None = None) -> tuple[GaussianParams,
                                                          AdamState]:
    """One Adam update, torch flavour (bias correction, eps outside the
    sqrt). `mask` (C,) zeroes the gradients of dead rows."""
    count = opt.count + 1
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, lr in zip(params, grads, opt.m, opt.v, lrs):
        if mask is not None:
            g = g * mask.reshape((-1,) + (1,) * (g.ndim - 1)).to(g.dtype)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        new_p.append(p - lr * (m / c1) / (torch.sqrt(v / c2) + eps))
        new_m.append(m)
        new_v.append(v)
    return GaussianParams(*new_p), AdamState(GaussianParams(*new_m),
                                             GaussianParams(*new_v), count)


# ---------------------------------------------------------------------------
# densification statistics, densify / prune, opacity reset
# ---------------------------------------------------------------------------

def add_densification_stats(state: GaussianState,
                            screenspace_grad: torch.Tensor,
                            radii: torch.Tensor) -> GaussianState:
    """Accumulate |dL/dmean2d| (pixel units) of the visible Gaussians and
    track their largest radius (reference :398-401)."""
    visible = radii > 0
    norm = torch.linalg.vector_norm(screenspace_grad[:, :2], dim=-1)
    return dataclasses.replace(
        state,
        grad_accum=state.grad_accum + torch.where(visible, norm, 0.0),
        denom=state.denom + visible.to(state.denom.dtype),
        max_radii2d=torch.maximum(
            state.max_radii2d,
            torch.where(visible, radii.to(torch.float32), 0.0)))


def _masked_rank(mask: torch.Tensor) -> torch.Tensor:
    """Exclusive cumsum rank of the True entries."""
    m = mask.long()
    return torch.cumsum(m, 0) - m


def densify_and_prune(state: GaussianState, *, max_grad: float,
                      min_opacity: float, extent: float,
                      max_screen_size: float, percent_dense: float,
                      noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None
                      ) -> GaussianState:
    """One densification pass (reference densify_and_prune :382-396 with
    densify_and_clone :365-380 and densify_and_split :338-363) as masked
    writes on the padded buffers:

      * clone small Gaussians whose mean screen-space gradient reaches
        max_grad, split large ones into two children sampled from
        N(0, scale) in the Gaussian's frame with scales / 1.6;
      * prune low opacity, and with max_screen_size > 0 oversized ones;
      * child A overwrites its source in place; child B and the clones go
        to free slots (dead or removed rows) by rank, and are dropped when
        the slots run out;
      * Adam moments are zeroed on every touched row, statistics reset.

    `noise` (2, C, 3) holds the standard normals of the two children; by
    default they come from `generator` (drawn on the CPU)."""
    cap = state.capacity
    p = state.params
    alive = state.alive
    dev = alive.device

    grads = torch.where(state.denom > 0, state.grad_accum / state.denom, 0.0)
    scaling = torch.exp(p.scaling)
    max_scale = scaling.amax(dim=-1)
    over_grad = (grads >= max_grad) & alive
    clone_sel = over_grad & (max_scale <= percent_dense * extent)
    split_sel = over_grad & (max_scale > percent_dense * extent)

    low = torch.sigmoid(p.opacity[:, 0]) < min_opacity
    prune_sel = low
    if max_screen_size > 0:
        prune_sel = (prune_sel | (state.max_radii2d > max_screen_size)
                     | (max_scale > 0.1 * extent))
    prune_sel = prune_sel & alive
    alive_after_remove = alive & ~(prune_sel | split_sel)
    removed = prune_sel & ~split_sel
    pruned["low_opacity"] += int((removed & low).sum())
    pruned["oversized"] += int((removed & ~low).sum())

    # free slots: dead rows (removed ones included) other than split sources
    free = ~alive_after_remove & ~split_sel
    free_slots = torch.nonzero(free).flatten()
    n_free = free_slots.shape[0]

    if noise is None:
        noise = torch.randn((2, cap, 3), generator=generator).to(dev)
    samples = noise * scaling[None]
    rot = torch.stack(quat_to_rotmat_cols(p.rotation), dim=-1).reshape(
        cap, 3, 3)
    child_xyz = p.xyz[None] + torch.einsum("nij,snj->sni", rot, samples)
    child_scaling = torch.log(scaling / (0.8 * 2))

    def child(i):
        return p._replace(xyz=child_xyz[i], scaling=child_scaling)

    def in_place(dst, src):
        m = split_sel.reshape((-1,) + (1,) * (dst.ndim - 1))
        return torch.where(m, src, dst)

    new_p = GaussianParams(*(in_place(d, s) for d, s in zip(p, child(0))))
    new_alive = alive_after_remove | split_sel

    # child B and the clones take free slots in rank order
    src_b = torch.nonzero(split_sel).flatten()[:n_free]
    slot_b = free_slots[:src_b.shape[0]]
    src_c = torch.nonzero(clone_sel).flatten()[:n_free - src_b.shape[0]]
    slot_c = free_slots[src_b.shape[0]:src_b.shape[0] + src_c.shape[0]]
    cb = child(1)
    new_p = GaussianParams(*(t.index_copy(0, slot_b, b[src_b])
                             for t, b in zip(new_p, cb)))
    new_p = GaussianParams(*(t.index_copy(0, slot_c, c[src_c])
                             for t, c in zip(new_p, p)))
    new_alive = new_alive.clone()
    new_alive[slot_b] = True
    new_alive[slot_c] = True

    touched = split_sel.clone()
    touched[slot_b] = True
    touched[slot_c] = True

    def zero_rows(t):
        return torch.where(touched.reshape((-1,) + (1,) * (t.ndim - 1)),
                           0.0, t)

    opt = AdamState(GaussianParams(*(zero_rows(m) for m in state.opt.m)),
                    GaussianParams(*(zero_rows(v) for v in state.opt.v)),
                    state.opt.count)
    zeros = torch.zeros(cap, device=dev)
    return dataclasses.replace(
        state, params=new_p, alive=new_alive, opt=opt, grad_accum=zeros,
        denom=zeros.clone(), max_radii2d=zeros.clone())


def reset_opacity(state: GaussianState) -> GaussianState:
    """Clamp opacity to at most 0.01 and zero its moments (reference
    reset_opacity :187-190)."""
    new_op = inverse_sigmoid(torch.clamp_max(torch.sigmoid(
        state.params.opacity), 0.01))
    m, v, count = state.opt
    return dataclasses.replace(
        state, params=state.params._replace(opacity=new_op),
        opt=AdamState(m._replace(opacity=torch.zeros_like(new_op)),
                      v._replace(opacity=torch.zeros_like(new_op)), count))
