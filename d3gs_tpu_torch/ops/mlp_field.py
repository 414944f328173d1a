"""One evaluation of the 8x256 deformation MLP: the CUDA kernels and their
plain versions.

    mlp_field(net, x, t)   the heads (δx, δr, δs), or (δx,) for `warp`

for a `DeformMLP` that `qualifies` (f32 compute, D 8, W 256, skip after
layer 4, PE(x, 10), not 6DoF; either `is_blender`, full heads or δx
alone), an (N, 3) f32 x and a host-number t. Both versions compute the net
in the kernels' form, that of `ode_rk4.py` (the trunk is the ODE net's):

  * the time input as the two bias vectors c0 and c5 at t
    (`ode_rk4.time_biases` on one row: the Blender time net's output or
    PE(t, 10)), so that one evaluation at one time needs no (N, in) input;
  * the skip layer as two products into one sum, PE(x) by W5[:, :63] and h
    by W5[:, in:], with no concat.

`mlp_field` launches `csrc/mlp_field.cu` for CUDA tensors, keeping what
the backward reads where asked (`keep`), and runs the plain version
`mlp_field_torch` for CPU tensors; it never falls back from one to the
other. `mlp_field_vjp` is the vector-Jacobian product for the parameters
(x takes none: the trainers detach it): the kernel's sweep and weight
gradients over what the forward kept, or `mlp_field_vjp_torch`, which
evaluates again. `evaluate` is `DeformMLP.forward`'s path where `engages`
holds: through `_FusedMLP` while autograd records. `launch_counts()`
reads the kernels' launches since the port's counters were last drained.
"""
from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from .. import tracing
from . import _build
from .ode_rk4 import (DEPTH, MULTIRES, SKIP, WIDE_LAYERS, WIDTH, X_DIM,
                      X_ROWS, TrunkPack, _host_number, cached, time_biases,
                      trunk_grads, trunk_torch)

if TYPE_CHECKING:
    from ..models.deform.networks import DeformMLP

HEAD_ROWS = 12                  # the kernels' head rows: the heads', zeros
PART_ROWS = DEPTH + HEAD_ROWS + 1   # the backward's sums, see `_param_grads`
# the input's devices on which `DeformMLP.forward` takes this path
DEVICES = ("cuda",)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [_P, _LL, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P]
_ARGTYPES_BWD = [_P, _P, _P, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _P, _I, _P]
SUM_GROUP = 64                  # the sweep's blocks a first-pass sum


def launch_counts() -> dict[str, int]:
    """Evaluations run by each kernel since the port's counters were last
    drained (`tracing.drain`), one a call of its C entry (the forward's
    one or two launches of whole waves and the rest; the backward's sweep,
    weight-gradient pass and sums); the plain versions do not count."""
    c = tracing.counters()
    return {"mlp_field": c.get("launches.mlp_field", 0),
            "mlp_field_bwd": c.get("launches.mlp_field_bwd", 0)}


def qualifies(net) -> bool:
    """The net is the kernels': DeformMLP (read by its attributes: `ops`
    imports no `models`) computing in f32, D 8, W 256, a skip after layer
    4, PE(x, 10), not 6DoF."""
    return (getattr(net, "skip", None) == SKIP
            and getattr(net, "heads", None) is not None
            and net.dtype == torch.float32 and net.D == DEPTH
            and net.W == WIDTH and net.multires == MULTIRES
            and not net.is_6dof)


def engages(net, x: torch.Tensor, t) -> bool:
    """Whether an evaluation of net at (x, t) runs here: net qualifies, x
    is an (N, 3) f32 tensor on a device of `DEVICES` that takes no
    gradient (the kernels give none), and t is a host number (per-point
    or tensor times cannot fold into a bias)."""
    return (qualifies(net) and x.device.type in DEVICES
            and x.dtype == torch.float32 and x.ndim == 2 and x.shape[1] == 3
            and not (x.requires_grad and torch.is_grad_enabled())
            and _host_number(t))


class _Packed(TrunkPack):
    """`TrunkPack`, the heads and the sweep's weights."""

    def __init__(self, net: DeformMLP):
        super().__init__(net)
        w = lambda i: net.trunk[i].weight.detach()  # noqa: E731
        rows = sum(lin.out_features for lin in net.heads)
        self.w_head = F.pad(torch.cat([lin.weight.detach()
                                       for lin in net.heads]),
                            (0, 0, 0, HEAD_ROWS - rows)).contiguous()
        self.b_head = F.pad(torch.cat([lin.bias.detach()
                                       for lin in net.heads]),
                            (0, HEAD_ROWS - rows))
        # the sweep's weights, out-major (as `nn.Linear` keeps them), in the
        # order it reads them: W7, W6, W5[:, in:], W4 ... W1
        self.wt = torch.cat([w(7).reshape(-1), w(6).reshape(-1),
                             self.w5_h.reshape(-1)]
                            + [w(i).reshape(-1) for i in (4, 3, 2, 1)])


def _packed(net: DeformMLP) -> _Packed:
    """The net's `_Packed`, for its parameters' current values."""
    return cached(net, "_mlp_field_packed", _Packed)


def _check(net, x: torch.Tensor, t) -> None:
    if not qualifies(net):
        raise ValueError("mlp_field: the net must be DeformMLP computing in "
                         "float32 with D 8, W 256, a skip after layer 4, "
                         "multires 10 and no 6DoF head")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"mlp_field: x must be an (N, 3) float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not _host_number(t):
        raise ValueError("mlp_field: t must be a host number")
    if 3 * x.shape[0] >= 2 ** 31:
        raise ValueError("mlp_field: x must hold fewer than 2**31 floats")
    for p in net.parameters():
        if p.device != x.device or p.dtype != torch.float32:
            raise ValueError(f"mlp_field: the net's parameters must be "
                             f"float32 on {x.device}, got {p.dtype} on "
                             f"{p.device}")


def _prologue(net, x: torch.Tensor, t):
    """What each version starts with: the checks, then x contiguous, the
    packed weights, the time (one, as a tuple) and the time biases at
    it."""
    _check(net, x, t)
    times = (float(t),)
    return x.contiguous(), _packed(net), times, time_biases(net, times, x)


def _cotangents(net, x: torch.Tensor, gs) -> list:
    """Each head's cotangent, checked, contiguous."""
    if len(gs) != len(net.heads):
        raise ValueError(f"mlp_field: {len(gs)} cotangents for "
                         f"{len(net.heads)} heads")
    for g, lin in zip(gs, net.heads):
        shape = (x.shape[0], lin.out_features)
        if g.shape != shape or g.dtype != x.dtype or g.device != x.device:
            raise ValueError(f"mlp_field: a cotangent must be {x.dtype} "
                             f"{shape} on {x.device}, got {g.dtype} "
                             f"{tuple(g.shape)} on {g.device}")
    return [g.contiguous() for g in gs]


def mlp_field(net: DeformMLP, x: torch.Tensor, t, keep: bool = False):
    """-> (heads, kept): the heads of one evaluation, the kernel's for a
    CUDA x (with `keep`, kept holds the scratch that `mlp_field_vjp`
    reads), the plain version's for a CPU one (kept None). Not
    differentiable (`_FusedMLP` is)."""
    if x.is_cuda:
        with torch.cuda.device(x.device):
            return _forward_kernel(
                _build.entry("mlp_field", _ARGTYPES), net, x, t, keep,
                torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.type == "cpu":
        return mlp_field_torch(net, x, t), None
    raise ValueError(f"mlp_field: unsupported device {x.device}")


@torch.no_grad()
def mlp_field_torch(net: DeformMLP, x: torch.Tensor, t) -> tuple:
    """Plain version: the kernel's function in PyTorch operators."""
    x, pk, _, tb = _prologue(net, x, t)
    h8 = trunk_torch(net, pk, tb[0, 0], tb[0, 1], x)[-1]
    return tuple(lin(h8) for lin in net.heads)


@torch.no_grad()
def _forward_kernel(entry, net: DeformMLP, x: torch.Tensor, t, keep: bool,
                    stream):
    """`mlp_field` by the C entry `entry` (`d3gs_mlp_field` of
    `csrc/mlp_field.cu`) on x's device (the tests pass a CPU build of it).
    kept: PE(x) and h1 ... h8 (n x (64 + 8 x 256) floats), the ReLU masks
    (16 bytes x 256 x 8 a block, at most ceil(n / 64) blocks) and the
    packing the kernel read."""
    x, pk, _, tb = _prologue(net, x, t)
    n = x.shape[0]
    outs = [x.new_empty((n, lin.out_features)) for lin in net.heads]
    kept = None
    if keep:
        blocks = -(-n // 64)
        kept = (x.new_empty(n * (X_ROWS + DEPTH * WIDTH)),
                torch.empty(blocks * DEPTH * WIDTH * 4, dtype=torch.int32,
                            device=x.device), pk)
    err = entry(x.data_ptr(), n, pk.w.data_ptr(), pk.bias.data_ptr(),
                tb.data_ptr(), pk.w_head.data_ptr(), pk.b_head.data_ptr(),
                sum(lin.out_features for lin in net.heads),
                *[o.data_ptr() for o in outs], *[None] * (3 - len(outs)),
                kept[0].data_ptr() if keep else None,
                kept[1].data_ptr() if keep else None, stream)
    if err != 0:
        raise RuntimeError(f"mlp_field kernel launch failed: cudaError {err}")
    tracing.count("launches.mlp_field")
    return tuple(outs), kept


def mlp_field_vjp(net: DeformMLP, x: torch.Tensor, t, gs, kept,
                  need=None) -> list:
    """The vector-Jacobian product of one evaluation for the cotangents gs
    of its heads: [dL/dp for p in net.parameters()], an entry None where
    `need` (one flag a parameter, default all) is False. The kernels for a
    CUDA x, over `kept` of `mlp_field(net, x, t, keep=True)`; the plain
    version for a CPU one."""
    if x.is_cuda:
        with torch.cuda.device(x.device):
            return _vjp_kernel(
                _build.entry("mlp_field", _ARGTYPES_BWD, "mlp_field_bwd"),
                net, x, t, gs, kept, need,
                torch.cuda.get_device_properties(
                    x.device).multi_processor_count,
                torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.type == "cpu":
        return mlp_field_vjp_torch(net, x, t, gs, need)
    raise ValueError(f"mlp_field: unsupported device {x.device}")


def _param_grads(net: DeformMLP, times, like: torch.Tensor, dw: torch.Tensor,
                 dwx: torch.Tensor, db: torch.Tensor, need) -> list:
    """Each parameter's gradient from the backward's parts: dw and dwx as
    `ode_rk4.trunk_grads` takes them, db (PART_ROWS, 256) the column sums
    of the gradients at layers 0-7's outputs (rows 0-7), the heads'
    weight gradients (rows 8-19, the heads' rows in order) and their bias
    gradients (row 20, columns 0-11)."""
    named = list(net.named_parameters())
    need = [True] * len(named) if need is None else list(need)
    want = {name for (name, _), n in zip(named, need) if n}
    grads = trunk_grads(
        net, times, like, dw, dwx, torch.stack([db[0], db[SKIP + 1]])[None],
        {layer: db[layer] for layer in WIDE_LAYERS if layer != SKIP + 1},
        want)
    row = 0
    for i, lin in enumerate(net.heads):
        k = lin.out_features
        grads[f"heads.{i}.weight"] = db[DEPTH + row:DEPTH + row + k]
        grads[f"heads.{i}.bias"] = db[DEPTH + HEAD_ROWS, row:row + k]
        row += k
    return [grads[name] if n else None for (name, _), n in zip(named, need)]


@torch.no_grad()
def mlp_field_vjp_torch(net: DeformMLP, x: torch.Tensor, t, gs,
                        need=None) -> list:
    """Plain version of `mlp_field_vjp`: the evaluation again in the
    kernel's form, each layer's input kept, then the reverse sweep, layers
    7 -> 0, in PyTorch operators."""
    x, pk, times, tb = _prologue(net, x, t)
    g = torch.cat(_cotangents(net, x, gs), 1)
    hs = trunk_torch(net, pk, tb[0, 0], tb[0, 1], x)
    tr = net.trunk
    k = g.shape[1]
    dw = x.new_zeros((len(WIDE_LAYERS), WIDTH, WIDTH))
    dwx = x.new_zeros((2, WIDTH, X_ROWS))
    db = x.new_zeros((PART_ROWS, WIDTH))
    db[DEPTH:DEPTH + k] = g.T @ hs[DEPTH]
    db[DEPTH + HEAD_ROWS, :k] = g.sum(0)
    d = (g @ pk.w_head[:k]) * (hs[DEPTH] > 0)
    w_in = {i: tr[i].weight for i in WIDE_LAYERS}
    w_in[SKIP + 1] = pk.w5_h
    for layer in range(DEPTH - 1, 0, -1):
        db[layer] = d.sum(0)
        dw[layer - 1] = d.T @ hs[layer]
        if layer == SKIP + 1:
            dwx[1, :, :X_DIM] = d.T @ hs[0]
        d = (d @ w_in[layer]) * (hs[layer] > 0)
    db[0] = d.sum(0)
    dwx[0, :, :X_DIM] = d.T @ hs[0]
    return _param_grads(net, times, x, dw, dwx, db, need)


@torch.no_grad()
def _vjp_kernel(entry, net: DeformMLP, x: torch.Tensor, t, gs, kept, need,
                splits: int, stream) -> list:
    """`mlp_field_vjp` by the C entry `entry` (`d3gs_mlp_field_bwd` of
    `csrc/mlp_field.cu`) on x's device (the tests pass a CPU build of it),
    a K-split a SM for each of the 14 halves of the trunk's weight blocks.
    Its scratch (the gradients at the 8 layers' outputs, ~3.3 GB at N =
    400,000, and the partial sums) comes from PyTorch's allocator."""
    _check(net, x, t)
    gs = _cotangents(net, x, gs)
    acts, masks, pk = kept
    n = x.shape[0]
    blocks = -(-n // 64)          # the most row tiles the kernels make
    wlen = len(WIDE_LAYERS) * WIDTH * WIDTH + 2 * WIDTH * X_ROWS
    deltas = x.new_empty(n * DEPTH * WIDTH)
    part = x.new_empty(blocks * PART_ROWS * WIDTH)
    psum = x.new_empty(-(-blocks // SUM_GROUP) * PART_ROWS * WIDTH)
    wpart = x.new_empty(splits * wlen)
    dpart = x.new_empty((PART_ROWS, WIDTH))
    dws = x.new_empty(wlen)
    err = entry(*[g.data_ptr() for g in gs], *[None] * (3 - len(gs)), n,
                sum(lin.out_features for lin in net.heads), pk.wt.data_ptr(),
                pk.w_head.data_ptr(), acts.data_ptr(), deltas.data_ptr(),
                masks.data_ptr(), part.data_ptr(), psum.data_ptr(),
                wpart.data_ptr(), dpart.data_ptr(), dws.data_ptr(), splits,
                stream)
    if err != 0:
        raise RuntimeError(f"mlp_field_bwd kernel launch failed: cudaError "
                           f"{err}")
    tracing.count("launches.mlp_field_bwd")
    nw = len(WIDE_LAYERS) * WIDTH * WIDTH
    return _param_grads(
        net, (float(t),), x,
        dws[:nw].view(len(WIDE_LAYERS), WIDTH, WIDTH),
        dws[nw:].view(2, WIDTH, X_ROWS), dpart, need)


class _FusedMLP(torch.autograd.Function):
    """One evaluation under autograd, as `models/deform/ode.py::_FusedRK4`
    is one RK4 step: the forward kernel, keeping what the backward reads
    where a parameter takes a gradient; the backward `mlp_field_vjp` over
    it, returning each parameter's (the inputs after t). x takes none."""

    @staticmethod
    def forward(ctx, net, x, t, *params):
        heads, kept = mlp_field(net, x, t, keep=any(ctx.needs_input_grad[3:]))
        ctx.net, ctx.t, ctx.kept = net, t, kept
        ctx.save_for_backward(x)
        return heads

    @staticmethod
    def backward(ctx, *gs):
        (x,) = ctx.saved_tensors
        grads = mlp_field_vjp(ctx.net, x, ctx.t, gs, ctx.kept,
                              ctx.needs_input_grad[3:])
        ctx.kept = None
        return (None, None, None, *grads)


def evaluate(net: DeformMLP, x: torch.Tensor, t) -> tuple:
    """The heads of an evaluation that `engages`: through `_FusedMLP`
    while autograd records, else the forward alone (nothing kept)."""
    if torch.is_grad_enabled():
        return _FusedMLP.apply(net, x, t, *net.parameters())
    return mlp_field(net, x, t)[0]
