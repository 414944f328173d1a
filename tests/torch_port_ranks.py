"""Rank side of the port's multi-rank tests (tests/test_torch_port_parallel*.py):
gloo ranks on the CPU, spawned with `torch.multiprocessing` around a
`FileStore` in the test's temporary folder (no fixed port, so test files
that run at once do not collide). This module imports torch and the port
only, so the ranks start without JAX.

The parent hands each rank the same list of tasks, (name, kwargs) with
numpy inputs; every rank runs them all in order (their collectives pair
up) and writes its results, numpy arrays keyed by task, to rank<r>.pt.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


# ---------------------------------------------------------------------------
# numpy <-> port objects
# ---------------------------------------------------------------------------

def state_to_numpy(st) -> dict:
    """A port GaussianState as numpy arrays and scalars."""
    a = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return {"params": [a(p) for p in st.params],
            "m": [a(p) for p in st.opt.m], "v": [a(p) for p in st.opt.v],
            "count": st.opt.count, "alive": a(st.alive),
            "grad_accum": a(st.grad_accum), "denom": a(st.denom),
            "max_radii2d": a(st.max_radii2d),
            "active": st.active_sh_degree, "max": st.max_sh_degree,
            "lr_scale": st.spatial_lr_scale}


def state_from_numpy(d: dict):
    from d3gs_tpu_torch.models import gaussians as G
    t = torch.from_numpy
    gp = lambda xs: G.GaussianParams(*(t(np.array(x)) for x in xs))  # noqa
    return G.GaussianState(
        params=gp(d["params"]), alive=t(np.array(d["alive"])),
        active_sh_degree=d["active"], max_sh_degree=d["max"],
        grad_accum=t(np.array(d["grad_accum"])), denom=t(np.array(d["denom"])),
        max_radii2d=t(np.array(d["max_radii2d"])),
        opt=G.AdamState(gp(d["m"]), gp(d["v"]), d["count"]),
        spatial_lr_scale=d["lr_scale"])


def camera_to_numpy(cam) -> dict:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in vars(cam).items()}


def camera_from_numpy(d: dict):
    from d3gs_tpu_torch.data.cameras import Camera
    return Camera(**{k: (torch.from_numpy(np.array(v))
                         if isinstance(v, np.ndarray) else v)
                     for k, v in d.items()})


def make_field(spec: dict, weights: dict, opt: dict):
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.models.deform import fields as F
    field = F.create_deform_field(F.DeformFieldSpec(**spec), device="cpu",
                                  opt_cfg=C.OptimizationParams(**opt))
    field.net.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in weights.items()})
    return field


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------

def _gather_rows(x, mesh):
    from d3gs_tpu_torch.parallel import comm
    return comm.all_gather(x.detach(), mesh.shard_group).numpy()


def task_render(mesh, *, state, cam, colors, bg, size, pipe=None):
    """The sharded render of `state` (all rows; sharded here) and the
    gradient of Σ image² with respect to the means; `pipe`: more
    PipelineParams fields."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.parallel import mesh as M
    from d3gs_tpu_torch.parallel.sharded import make_sharded_render
    st = M.shard_gaussian_state(state_from_numpy(state), mesh)
    cam = camera_from_numpy(cam)
    rows = st.capacity
    r0 = mesh.shard_rank * rows
    col = torch.from_numpy(colors)[r0:r0 + rows]
    render_fn = make_sharded_render(mesh, width=size, height=size,
                                    pipe_cfg=C.PipelineParams(
                                        depth_grad=True, **(pipe or {})))
    xyz = st.params.xyz.clone().requires_grad_()
    img, dep, alp, radii, counts = render_fn(
        xyz, st.get_scaling, st.params.rotation, col, st.get_opacity[:, 0],
        st.alive, cam, torch.from_numpy(bg), torch.zeros((rows, 2)))
    (g,) = torch.autograd.grad((img ** 2).sum(), [xyz])
    return {"image": img.detach().numpy(), "depth": dep.detach().numpy(),
            "alpha": alp.detach().numpy(),
            "radii": _gather_rows(radii, mesh),
            "counts": _gather_rows(counts, mesh),
            "grad_xyz": _gather_rows(g, mesh)}


def _result(st, dst, loss, l1, field, mesh, sharded: bool) -> dict:
    from d3gs_tpu_torch.parallel import mesh as M
    full = M.gather_gaussian_state(st, mesh) if sharded else st
    out = {"state": state_to_numpy(full), "loss": float(loss),
           "l1": float(l1)}
    if dst is not None:
        out["deform"] = {n: p.detach().numpy().copy()
                         for n, p in field.net.named_parameters()}
        out["deform_m"] = [m.numpy() for m in dst.m]
    return out


def task_baseline_step(mesh, *, state, cam, field, opt, size, iteration):
    """One step of `make_sharded_train_step` (warp field)."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.parallel import mesh as M
    from d3gs_tpu_torch.parallel.sharded import make_sharded_train_step
    fld = make_field(**field)
    step = make_sharded_train_step(
        mesh, opt_cfg=C.OptimizationParams(**opt),
        pipe_cfg=C.PipelineParams(), width=size, height=size, field=fld)
    st = M.shard_gaussian_state(state_from_numpy(state), mesh)
    st, dst, aux = step(st, fld.init_state(), camera_from_numpy(cam),
                        iteration, torch.zeros(3))
    return _result(st, dst, aux.loss, aux.l1, fld, mesh, True)


def task_flagship_step(mesh, *, layout, state, cams, field, opt, model, size,
                       iteration, wts=None, pipe=None):
    """One flagship step of the camera-parallel or gauss+tile layout;
    `pipe`: PipelineParams fields."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.parallel import mesh as M
    from d3gs_tpu_torch.parallel import sharded as S
    fld = make_field(**field)
    kw = dict(opt_cfg=C.OptimizationParams(**opt),
              pipe_cfg=C.PipelineParams(**(pipe or {})),
              model_cfg=C.ModelParams(**model), field=fld)
    st = state_from_numpy(state)
    if layout == "camera":
        step = S.make_flagship_camera_parallel_step(mesh, **kw)
    else:
        step = S.make_flagship_gauss_tile_step(mesh, width=size,
                                               height=size, **kw)
        st = M.shard_gaussian_state(st, mesh)
    st, dst, aux = step(st, fld.init_state(),
                        [camera_from_numpy(c) for c in cams], iteration,
                        torch.zeros(3), wts)
    return _result(st, dst, aux.loss, aux.l1, fld, mesh,
                   layout != "camera")


def task_densify(mesh, *, state, seed, extent):
    """shard -> gather -> densify_and_prune (generator `seed`) -> shard ->
    gather: what the flagship trainer does with a sharded state."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.parallel import mesh as M
    from d3gs_tpu_torch.train.step import densify_fns
    densify = densify_fns(C.OptimizationParams(
        densify_grad_threshold=1e-4))[0]
    st = M.shard_gaussian_state(state_from_numpy(state), mesh)
    full = M.gather_gaussian_state(st, mesh)
    full = densify(full, torch.Generator().manual_seed(seed), 20.0, extent)
    st = M.shard_gaussian_state(full, mesh)
    return {"state": state_to_numpy(M.gather_gaussian_state(st, mesh))}


def task_halo(mesh, *, x, rows):
    """halo_rows on this rank's strip of x (k, H, W, C) and the gradient
    of Σ (weights · [top, strip, bottom]) with respect to the strip."""
    from d3gs_tpu_torch.parallel import comm
    h = x.shape[1] // mesh.shard
    s = mesh.shard_rank
    strip = torch.from_numpy(x[:, s * h:(s + 1) * h]).requires_grad_()
    up, down = mesh.neighbours()
    top, bottom = comm.halo_rows(strip, rows, up, down)
    ext = torch.cat([top, strip, bottom], dim=1)
    wts = torch.arange(ext.numel(), dtype=ext.dtype).reshape(ext.shape)
    (g,) = torch.autograd.grad((ext * wts.sin()).sum(), [strip])
    return {"ext": ext.detach().numpy(), "grad": g.numpy(),
            "bytes": dict(comm.BYTES)}


TASKS = {"render": task_render, "baseline_step": task_baseline_step,
         "flagship_step": task_flagship_step, "densify": task_densify,
         "halo": task_halo}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world, folder, shape, tasks):
    # one intra-op thread per rank, as torch_port_fixtures.one_torch_thread
    # sets for the test processes: the ranks share the test's cores
    torch.set_num_threads(1)
    from d3gs_tpu_torch.parallel import mesh as M
    store = dist.FileStore(os.path.join(folder, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = (M.make_mesh_2d(*shape, torch.device("cpu")) if shape
                else M.make_mesh(torch.device("cpu")))
        out = {}
        for name, task, kwargs in tasks:
            out[name] = TASKS[task](mesh, **kwargs)
        torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, folder: str, tasks: list, shape=None) -> list:
    """Run `tasks` [(result name, task name, kwargs)] on `world` gloo ranks
    (a 1D mesh, or the (cam, shard) `shape`); -> each rank's results."""
    os.makedirs(folder, exist_ok=True)
    mp.spawn(_rank_main, args=(world, folder, shape, tasks), nprocs=world)
    return [torch.load(os.path.join(folder, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
