"""The device mesh over `torch.distributed` and the placement of the state
(counterpart of `d3gs_tpu/parallel/mesh.py`).

One process per rank, each on its own device (`cuda:LOCAL_RANK` with NCCL,
or the CPU with gloo). A `Mesh` is this rank's view of the default process
group:
  * 1D (`make_mesh`): one axis, "shard", over every rank;
  * 2D (`make_mesh_2d(cam, shard)`): the ranks as a (cam x shard) grid in
    row-major order, as the JAX package's `make_mesh_2d` orders devices:
    rank r sits in camera group r // shard at shard index r % shard. The
    ranks of a row (one camera group) share Gaussians and tile rows; the
    ranks of a column hold the same Gaussian rows for different cameras.
    Every rank creates every row's and column's group, in the same order,
    as `dist.new_group` requires.

`shard_gaussian_state` keeps this rank's capacity / shard rows of every
per-Gaussian tensor (parameters, Adam moments, `alive`, the densification
statistics); `gather_gaussian_state` is its inverse on every rank of the
row; `replicate` broadcasts tensors or a module's parameters from rank 0.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..models import gaussians as G
from . import comm

@dataclass(frozen=True)
class Mesh:
    cam: int                 # camera groups (1 on a 1D mesh)
    shard: int               # ranks per group: Gaussians and tile rows
    rank: int                # this rank in the default group
    device: torch.device
    shard_group: object = None   # this rank's row; None: the default group
    cam_group: object = None     # this rank's column; None on a 1D mesh

    @property
    def size(self) -> int:
        return self.cam * self.shard

    @property
    def shard_rank(self) -> int:
        return self.rank % self.shard

    @property
    def cam_rank(self) -> int:
        return self.rank // self.shard

    def neighbours(self) -> tuple[int | None, int | None]:
        """Global ranks of the strips above and below this rank's in its
        row (None at the outer strips)."""
        s = self.shard_rank
        return (self.rank - 1 if s > 0 else None,
                self.rank + 1 if s < self.shard - 1 else None)


def backend_for(device: torch.device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(device: torch.device) -> Mesh:
    """1D mesh over every rank of the initialised default group."""
    return Mesh(cam=1, shard=dist.get_world_size(), rank=dist.get_rank(),
                device=torch.device(device))


def make_mesh_2d(cam: int, shard: int, device: torch.device) -> Mesh:
    """(cam x shard) mesh: the camera batch splits over the `cam` groups,
    Gaussians and tile rows over the `shard` ranks of each group
    (d3gs_tpu/parallel/COMMS.md, 'Multi-host story')."""
    world = dist.get_world_size()
    if cam * shard != world:
        raise ValueError(f"a {cam}x{shard} mesh needs {cam * shard} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank()
    rows = [dist.new_group([c * shard + s for s in range(shard)])
            for c in range(cam)]
    cols = [dist.new_group([c * shard + s for c in range(cam)])
            for s in range(shard)]
    return Mesh(cam=cam, shard=shard, rank=rank, device=torch.device(device),
                shard_group=rows[rank // shard], cam_group=cols[rank % shard])


def _per_gaussian(state: G.GaussianState):
    """-> (per-Gaussian tensors in a fixed order, a function that rebuilds
    the state from that list)."""
    p, m, v = state.params, state.opt.m, state.opt.v
    tensors = [*p, *m, *v, state.alive, state.grad_accum, state.denom,
               state.max_radii2d]
    n = len(p)

    def rebuild(ts):
        return dataclasses.replace(
            state, params=G.GaussianParams(*ts[:n]),
            opt=G.AdamState(G.GaussianParams(*ts[n:2 * n]),
                            G.GaussianParams(*ts[2 * n:3 * n]),
                            state.opt.count),
            alive=ts[3 * n], grad_accum=ts[3 * n + 1], denom=ts[3 * n + 2],
            max_radii2d=ts[3 * n + 3])

    return tensors, rebuild


def shard_gaussian_state(state: G.GaussianState,
                         mesh: Mesh) -> G.GaussianState:
    """This rank's rows [s·C/S, (s+1)·C/S) of every per-Gaussian tensor
    (s = its shard index, C the capacity, S the ranks of a row). Raises
    when C does not divide by S."""
    cap = state.capacity
    if cap % mesh.shard:
        raise ValueError(f"capacity {cap} does not divide over {mesh.shard} "
                         f"shards")
    rows = cap // mesh.shard
    r0 = mesh.shard_rank * rows
    tensors, rebuild = _per_gaussian(state)
    return rebuild([t[r0:r0 + rows].clone() for t in tensors])


@torch.no_grad()
def gather_gaussian_state(state: G.GaussianState,
                          mesh: Mesh) -> G.GaussianState:
    """Inverse of `shard_gaussian_state`: every rank of the row gets the
    whole state. One all-gather of the float tensors as one (rows, F)
    block, `alive` riding along as 0/1."""
    if mesh.shard == 1:
        return state
    tensors, rebuild = _per_gaussian(state)
    rows = state.capacity
    flat = torch.cat([t.reshape(rows, -1).float() for t in tensors], dim=1)
    full = comm.all_gather(flat, mesh.shard_group)
    out, i = [], 0
    for t in tensors:
        w = t[:1].numel()
        col = full[:, i:i + w].reshape((-1,) + tuple(t.shape[1:]))
        out.append(col > 0.5 if t.dtype == torch.bool else col.to(t.dtype))
        i += w
    return rebuild(out)


def replicate(tensors) -> None:
    """Broadcast, in place, from rank 0: a list of tensors or a module's
    parameters."""
    if isinstance(tensors, torch.nn.Module):
        tensors = [p.data for p in tensors.parameters()]
    comm.broadcast_(list(tensors))
