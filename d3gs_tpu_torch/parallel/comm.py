"""The collectives of the sharded steps over `torch.distributed`, with their
gradients (the port's counterpart of what `shard_map` gives the JAX package:
`all_gather`, `psum`, `pmax`, `ppermute` and their transposes).

  all_gather(x, group)        tiled on dim 0; backward: reduce-scatter (sum),
                              so each rank's rows receive the gradients that
                              every rank's consumer sent them
  gather_replicated(x, group) the same forward, for a result every rank then
                              uses in the same way (a full image for a loss
                              computed on every rank); backward: this rank's
                              slice of the (equal) gradients, no traffic
  psum(x, group)              all-reduce sum; backward: the identity. Each
                              rank's share enters the global value once, so
                              its gradient is the global value's gradient
  all_reduce_(tensors, group) in-place sum of a list of tensors as one flat
                              buffer: one collective (the gradient
                              all-reduce of replicated parameters)
  pmax(x, group)              all-reduce max, no gradient
  halo_rows(x, rows, up, down) the `rows` rows above and below this
                              rank's strip (dim 1) from the ranks that hold
                              the strips above (`up`) and below (`down`);
                              zeros at the outer strips; backward: the
                              reverse exchange (the JAX step's two ppermutes)
  broadcast_(tensors)         from rank 0 to every rank, in place

`group` None is the default (world) group. NCCL takes CUDA tensors as they
are. Gloo is the CPU backend, and it is what ranks that share one card use;
it does not take CUDA tensors for every collective (a send of a CUDA tensor
aborts the process), so its path copies CUDA tensors to the host for the
collective and back, always, chosen by the group's backend, and says so
once. NCCL never stages through the host. A group of one rank moves
nothing.

`BYTES` counts, per collective, the bytes of its full tensor on this rank:
the gathered output of an all-gather, the input of a reduce-scatter, the
tensor of an all-reduce or a broadcast, the rows a halo exchange sends
(staging copies are not counted). These are the volumes of the per-step
byte model in `parallel/__init__.py`. `reset_bytes()` zeroes them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BYTES = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0,
         "halo": 0, "broadcast": 0}
_staging_noted = False


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


def _staged(x: torch.Tensor, group) -> bool:
    """Whether this collective copies `x` to the host: CUDA tensors under
    gloo, always; never under NCCL."""
    global _staging_noted
    if not (x.is_cuda and dist.get_backend(group) == "gloo"):
        return False
    if not _staging_noted:
        _staging_noted = True
        print(f"[comm rank {dist.get_rank()}] gloo: CUDA tensors are copied "
              f"to the host for each collective", flush=True)
    return True


def _count(kind: str, x: torch.Tensor, factor: int = 1) -> None:
    BYTES[kind] += x.numel() * x.element_size() * factor


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    d = dist.get_world_size(group)
    _count("all_gather", x, d)
    src = x.contiguous()
    if d == 1:
        return src.clone()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    out = src.new_empty((d * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.device) if staged else out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    d = dist.get_world_size(group)
    _count("reduce_scatter", x)
    src = x.contiguous()
    if d == 1:
        return src.clone()
    if src.shape[0] % d:
        raise ValueError(f"reduce_scatter: {src.shape[0]} rows do not "
                         f"split over {d} ranks")
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    out = src.new_empty((src.shape[0] // d,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(x.device) if staged else out


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """-> the reduced copy of x (x itself is left as it was)."""
    _count("all_reduce", x)
    if dist.get_world_size(group) == 1:
        return x.clone()
    staged = _staged(x, group)
    buf = x.detach().cpu() if staged else x.detach().clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device) if staged else buf


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        r0 = dist.get_rank(ctx.group) * ctx.rows
        return g[r0:r0 + ctx.rows].contiguous(), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rows of every rank of `group`, in rank order (tiled on dim 0)."""
    return _AllGather.apply(x, group)


def gather_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """`all_gather` for a result that every rank uses identically."""
    return _GatherReplicated.apply(x, group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks of `group`; the gradient passes through."""
    return _PSum.apply(x, group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max over the ranks of `group`, without a gradient."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


@torch.no_grad()
def all_reduce_(tensors: list[torch.Tensor], group=None) -> None:
    """Sum each tensor over `group`, in place, as one flat buffer: one
    collective for the lot. The tensors share a dtype."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = _all_reduce(flat, group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


@torch.no_grad()
def broadcast_(tensors: list[torch.Tensor]) -> None:
    """Copy each tensor from rank 0 to every rank, in place."""
    for t in tensors:
        _count("broadcast", t)
        if dist.get_world_size() == 1:
            continue
        staged = _staged(t, None)
        buf = t.cpu() if staged else t
        dist.broadcast(buf, 0)
        if staged:
            t.copy_(buf)


def _exchange(send_up, send_down, up: int | None, down: int | None):
    """Send `send_up` to global rank `up` and `send_down` to `down`; ->
    (rows from up, rows from down), zeros where there is no neighbour.
    All sends and receives of a rank go in one `batch_isend_irecv`, so
    neighbours that post them in different orders cannot deadlock."""
    dev = send_up.device
    staged = _staged(send_up, None)
    if staged:
        send_up, send_down = send_up.cpu(), send_down.cpu()
    from_up = torch.zeros_like(send_down)
    from_down = torch.zeros_like(send_up)
    ops = []
    if up is not None:
        ops += [dist.P2POp(dist.isend, send_up.contiguous(), up),
                dist.P2POp(dist.irecv, from_up, up)]
        BYTES["halo"] += send_up.numel() * send_up.element_size()
    if down is not None:
        ops += [dist.P2POp(dist.isend, send_down.contiguous(), down),
                dist.P2POp(dist.irecv, from_down, down)]
        BYTES["halo"] += send_down.numel() * send_down.element_size()
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        from_up, from_down = from_up.to(dev), from_down.to(dev)
    return from_up, from_down


def halo_rows(x: torch.Tensor, rows: int, up: int | None,
              down: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(top, bottom): the `rows` rows (dim 1 of x) that the strip above
    (global rank `up`) ends with and the strip below (`down`) starts with;
    zeros where the neighbour is None. Differentiable in x."""
    return _HaloRowsFn.apply(x, rows, up, down)


class _HaloRowsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, up, down):
        ctx.rows, ctx.up, ctx.down, ctx.strip = rows, up, down, x.shape[1]
        top, bottom = _exchange(x[:, :rows], x[:, -rows:], up, down)
        # received from up: the rows above my strip; from down: below it
        return top, bottom

    @staticmethod
    def backward(ctx, g_top, g_bottom):
        rows = ctx.rows
        # g_top belongs to up's last rows, g_bottom to down's first rows:
        # send them back; what arrives from up is the gradient of my first
        # rows (up's bottom halo), from down that of my last rows
        from_up, from_down = _exchange(g_top.contiguous(),
                                       g_bottom.contiguous(), ctx.up,
                                       ctx.down)
        shape = list(g_top.shape)
        shape[1] = ctx.strip
        g = g_top.new_zeros(shape)
        g[:, :rows] += from_up
        g[:, -rows:] += from_down
        return g, None, None, None
