"""One RK4 step of the 8x256 ODE dynamics net: the CUDA kernel and its plain
version.

    rk4_step(net, y, t, dt)   y + dt/6 (k1 + 2 k2 + 2 k3 + k4), k_i = net(t_i, y_i)

for a `DeformNetworkODE` that `qualifies` (use_linear 0, use_emb, D 8,
W 256, skips (4,), multires 10, either `is_blender`), an (N, 3) f32 state
and host-number t and dt. The stage times are `_rk4_step`'s: the Python
floats t, t + dt*0.5, t + dt, each cast to f32.

Both versions compute the net in the kernel's form:

  * the time input as two bias vectors per stage time, c0 = b0 + W0[:, 63:]
    temb(t) and c5 = b5 + W5[:, 63:in] temb(t), temb the time net's output
    (Blender) or PE(t, 10), computed once per distinct time on 3 rows;
  * the skip layer as two products into one sum, PE(x) by W5[:, :63] and
    h by W5[:, in:], with no concat;
  * the stage arithmetic in `_rk4_step`'s order, one rounding per
    operation.

`rk4_step` launches `csrc/ode_rk4.cu` for CUDA tensors (`rk4_step_cuda`)
and runs the plain PyTorch version `rk4_step_torch` for CPU tensors; it
never falls back from one to the other. `rk4_step_vjp` is the step's
vector-Jacobian product in the same form, by `csrc/ode_rk4_bwd.cu`
(`rk4_step_vjp_cuda`) or in PyTorch (`rk4_step_vjp_torch`). `engages` is
the rule by which `models/deform/ode.py::_substep` takes this path;
`launch_counts()` reads the kernels' launches since the port's counters
were last drained. The trunk's packing (`TrunkPack`), its layers in the
kernels' form (`trunk_torch`), `time_biases` and the trunk's gradients
from a backward's parts (`trunk_grads`) serve `ops/mlp_field.py` too: the
deformation MLP has the same trunk.
"""
from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from .. import tracing
from . import _build
from .encoding import positional_encoding

if TYPE_CHECKING:
    from ..models.deform.networks import DeformNetworkODE

WIDTH, DEPTH, SKIP, MULTIRES = 256, 8, 4, 10
X_DIM = 63                      # PE(x, 10)
X_ROWS = 64                     # PE(x) rows of the packed weights, padded
PACKED_ROWS = X_ROWS + 4 * WIDTH + X_ROWS + WIDTH + 2 * WIDTH
# the state's devices on which `_substep` takes this path
DEVICES = ("cuda",)

_P, _F, _LL, _I = (ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong,
                   ctypes.c_int)
_ARGTYPES = [_P, _LL, _P, _P, _P, _P, _P, _F, _F, _F, _F, _P, _P]
_ARGTYPES_BWD = [_P, _P, _LL, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F,
                 _P, _P, _P, _P, _P, _P, _P, _P, _I, _P]
# the backward's products: the seven 256x256 trunk blocks it returns, in
# the order W1, W2, W3, W4, W5[:, in:], W6, W7, then the two PE(x)
# blocks W0[:, :63] and W5[:, :63] padded to 64 columns
WIDE_LAYERS = (1, 2, 3, 4, 5, 6, 7)
PART_ROWS = 12                  # per block and stage, see `_param_grads`


def launch_counts() -> dict[str, int]:
    """Steps run by each kernel since the port's counters were last drained
    (`tracing.drain`), one a call of its C entry (which launches the
    128-row blocks of whole waves and, for the rest, a second grid; the
    backward's also its weight-gradient pass and two sums); the plain
    versions do not count."""
    c = tracing.counters()
    return {"ode_rk4": c.get("launches.ode_rk4", 0),
            "ode_rk4_bwd": c.get("launches.ode_rk4_bwd", 0)}


def qualifies(net) -> bool:
    """The net is the fused step's: DeformNetworkODE (read by its
    attributes: `ops` imports no `models`), full MLP, PE, 8x256, one skip
    after layer 4, PE(x, 10)."""
    return (getattr(net, "use_linear", None) == 0 and net.use_emb
            and net.W == WIDTH and net.D == DEPTH
            and net.skips == (SKIP,) and net.multires == MULTIRES)


def _host_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def engages(f, y: torch.Tensor, t, dt) -> bool:
    """Whether one RK4 step of f from (t, y) over dt runs here: f
    qualifies, y is an (N, 3) f32 tensor on a device of `DEVICES`, and t
    and dt are host numbers (a shared time grid; per-sample (N, 1) times
    cannot fold into a bias)."""
    return (qualifies(f) and y.device.type in DEVICES
            and y.dtype == torch.float32 and y.ndim == 2
            and y.shape[1] == 3 and _host_number(t) and _host_number(dt))


def stage_times(t, dt) -> tuple[float, float, float]:
    """The distinct stage times, as `_rk4_step` forms them."""
    return float(t), t + dt * 0.5, t + dt


class TrunkPack:
    """The trunk's parameters in the kernels' layouts (detached), for the
    parameters' current values: `w` the forward kernels' K-major packing
    (1,920 x 256: layer 0's PE(x) rows and a zero row, layers 1-4, layer
    5's PE(x) rows, a zero row and its h rows, layers 6-7), `bias` (8, 256)
    and the blocks the time input does not meet, W0[:, :63], W5[:, :63]
    and W5[:, in:], as `nn.Linear` keeps them."""

    def __init__(self, net):
        tr = net.trunk
        w = lambda i: tr[i].weight.detach()  # noqa: E731
        in_dim = tr[0].in_features
        pad = lambda m: F.pad(m.T, (0, 0, 0, X_ROWS - X_DIM))  # noqa: E731
        self.w = torch.cat([pad(w(0)[:, :X_DIM])]
                           + [w(i).T for i in range(1, SKIP + 1)]
                           + [pad(w(SKIP + 1)[:, :X_DIM]),
                              w(SKIP + 1)[:, in_dim:].T]
                           + [w(i).T for i in range(SKIP + 2, DEPTH)]
                           ).contiguous()
        self.bias = torch.stack([lin.bias.detach() for lin in tr])
        self.w0_x = w(0)[:, :X_DIM]
        self.w5_x = w(SKIP + 1)[:, :X_DIM]
        self.w5_h = w(SKIP + 1)[:, in_dim:]


class _Packed(TrunkPack):
    """`TrunkPack` and the output layer and the backward's weights."""

    def __init__(self, net: DeformNetworkODE):
        super().__init__(net)
        w = lambda i: net.trunk[i].weight.detach()  # noqa: E731
        self.w_out = net.out.weight.detach().contiguous()
        self.b_out = net.out.bias.detach().contiguous()
        # the backward's weights, out-major (as `nn.Linear` keeps them), in
        # the order its sweep reads them: W7, W6, W5[:, :63] padded to 64
        # columns, W5[:, in:], W4 ... W1, W0[:, :63] padded
        xpad = lambda m: F.pad(m, (0, X_ROWS - X_DIM))  # noqa: E731
        self.wt = torch.cat([w(7).reshape(-1), w(6).reshape(-1),
                             xpad(self.w5_x).reshape(-1),
                             self.w5_h.reshape(-1)]
                            + [w(i).reshape(-1) for i in (4, 3, 2, 1)]
                            + [xpad(self.w0_x).reshape(-1)])


def cached(net, attr: str, make):
    """make(net), kept on the net as `attr` and made again when one of its
    parameters was replaced or changed in place (its version counter
    moved)."""
    key = tuple((p.data_ptr(), p._version) for p in net.parameters())
    found = getattr(net, attr, None)
    if found is None or found[0] != key:
        found = (key, make(net))
        setattr(net, attr, found)
    return found[1]


def _packed(net: DeformNetworkODE) -> _Packed:
    """The net's `_Packed`, for its parameters' current values."""
    return cached(net, "_ode_rk4_packed", _Packed)


def time_biases(net: DeformNetworkODE, times,
                like: torch.Tensor) -> torch.Tensor:
    """(len(times), 2, 256): c0 and c5 at each time, from the parameter
    blocks the time input meets, W0[:, 63:] and W5[:, 63:in], and the
    biases b0 and b5 (differentiable where autograd records). The times
    are filled on the device as f32, as `_time_column` fills them, with no
    copy from the host."""
    tt = like.new_empty((len(times), 1))
    for i, v in enumerate(times):
        tt[i].fill_(v)
    temb = positional_encoding(tt, net.t_multires)
    if net.timenet is not None:
        temb = net.timenet[1](torch.relu(net.timenet[0](temb)))
    l0, l5 = net.trunk[0], net.trunk[SKIP + 1]
    return torch.stack([
        F.linear(temb, l0.weight[:, X_DIM:], l0.bias),
        F.linear(temb, l5.weight[:, X_DIM:l0.in_features], l5.bias)], dim=1)


def rk4_step(net: DeformNetworkODE, y: torch.Tensor, t, dt) -> torch.Tensor:
    """One RK4 step: the kernel for a CUDA state, the plain version for a
    CPU one. Not differentiable (`models/deform/ode.py::_FusedRK4` is)."""
    if y.is_cuda:
        return rk4_step_cuda(net, y, t, dt)
    if y.device.type == "cpu":
        return rk4_step_torch(net, y, t, dt)
    raise ValueError(f"ode_rk4: unsupported device {y.device}")


def _check(net, y: torch.Tensor, t, dt) -> None:
    if not qualifies(net):
        raise ValueError("ode_rk4: the net must be DeformNetworkODE with "
                         "use_linear 0, use_emb, D 8, W 256, skips (4,) and "
                         "multires 10")
    if y.dtype != torch.float32 or y.ndim != 2 or y.shape[1] != 3:
        raise ValueError(f"ode_rk4: y must be an (N, 3) float32 tensor, got "
                         f"{y.dtype} {tuple(y.shape)}")
    if not (_host_number(t) and _host_number(dt)):
        raise ValueError("ode_rk4: t and dt must be host numbers")
    for p in net.parameters():
        if p.device != y.device or p.dtype != torch.float32:
            raise ValueError(f"ode_rk4: the net's parameters must be float32 "
                             f"on {y.device}, got {p.dtype} on {p.device}")


def _prologue(net, y: torch.Tensor, t, dt, g: torch.Tensor | None = None):
    """What each version of the step and of its VJP starts with: the checks
    (the cotangent g's too, where given), then y contiguous, the packed
    weights, the stage times and the time biases at them."""
    _check(net, y, t, dt)
    if g is not None:
        _check_cotangent(y, g)
    if 3 * y.shape[0] >= 2 ** 31:
        raise ValueError("ode_rk4: y must hold fewer than 2**31 floats")
    times = stage_times(t, dt)
    return y.contiguous(), _packed(net), times, time_biases(net, times, y)


def trunk_torch(net, pk, c0: torch.Tensor, c5: torch.Tensor,
                x: torch.Tensor) -> list:
    """The trunk in the kernels' form, in PyTorch operators, for the time
    biases c0 and c5 at one time: each layer's input [PE(x), h1 ... h7]
    and layer 7's output h8. pk: the net's `TrunkPack`."""
    tr = net.trunk
    hs = [positional_encoding(x, MULTIRES)]
    hs.append(torch.relu(F.linear(hs[0], pk.w0_x, c0)))
    for i in range(1, SKIP + 1):
        hs.append(torch.relu(tr[i](hs[-1])))
    hs.append(torch.relu(F.linear(hs[0], pk.w5_x)
                         + F.linear(hs[-1], pk.w5_h) + c5))
    for i in range(SKIP + 2, DEPTH):
        hs.append(torch.relu(tr[i](hs[-1])))
    return hs


def _stages(net: DeformNetworkODE, pk: _Packed, tb: torch.Tensor,
            y: torch.Tensor, dt):
    """The step's four stages in the kernel's form, in PyTorch operators:
    each stage's k, and each stage's layer inputs [PE(x), h1 ... h7] and
    output h8."""

    def f(ti: int, x: torch.Tensor):
        hs = trunk_torch(net, pk, tb[ti, 0], tb[ti, 1], x)
        return net.out(hs[-1]) * net.output_scale, hs

    out = [f(0, y)]
    out.append(f(1, y + 0.5 * dt * out[0][0]))
    out.append(f(1, y + 0.5 * dt * out[1][0]))
    out.append(f(2, y + dt * out[2][0]))
    return [k for k, _ in out], [hs for _, hs in out]


@torch.no_grad()
def rk4_step_torch(net: DeformNetworkODE, y: torch.Tensor, t,
                   dt) -> torch.Tensor:
    """Plain version: the kernel's function in PyTorch operators."""
    y, pk, _, tb = _prologue(net, y, t, dt)
    k, _ = _stages(net, pk, tb, y, dt)
    return y + (dt / 6.0) * (k[0] + 2 * k[1] + 2 * k[2] + k[3])


@torch.no_grad()
def rk4_step_cuda(net: DeformNetworkODE, y: torch.Tensor, t,
                  dt) -> torch.Tensor:
    """Launch `csrc/ode_rk4.cu`; raises if it cannot be built or launched."""
    with torch.cuda.device(y.device):
        return _step_kernel(_build.entry("ode_rk4", _ARGTYPES), net, y, t,
                            dt, torch.cuda.current_stream(y.device
                                                          ).cuda_stream)


def _step_kernel(entry, net: DeformNetworkODE, y: torch.Tensor, t, dt,
                 stream) -> torch.Tensor:
    """`rk4_step` by the C entry `entry` of `csrc/ode_rk4.cu` on y's device
    (the tests pass a CPU build of it)."""
    y, pk, _, tb = _prologue(net, y, t, dt)
    out = torch.empty_like(y)
    err = entry(y.data_ptr(), y.shape[0], pk.w.data_ptr(), pk.bias.data_ptr(),
                tb.data_ptr(), pk.w_out.data_ptr(), pk.b_out.data_ptr(),
                float(net.output_scale), 0.5 * dt, float(dt), dt / 6.0,
                out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ode_rk4 kernel launch failed: cudaError {err}")
    tracing.count("launches.ode_rk4")
    return out


def rk4_step_vjp(net: DeformNetworkODE, y: torch.Tensor, t, dt,
                 g: torch.Tensor, need=None):
    """The vector-Jacobian product of one RK4 step for the cotangent g of
    its output: (dL/dy, [dL/dp for p in net.parameters()]), a parameter's
    entry None where `need` (one flag a parameter, default all) is False.
    The kernel for a CUDA state, the plain version for a CPU one."""
    if y.is_cuda:
        return rk4_step_vjp_cuda(net, y, t, dt, g, need)
    if y.device.type == "cpu":
        return rk4_step_vjp_torch(net, y, t, dt, g, need)
    raise ValueError(f"ode_rk4: unsupported device {y.device}")


def _check_cotangent(y: torch.Tensor, g: torch.Tensor) -> None:
    if g.shape != y.shape or g.dtype != y.dtype or g.device != y.device:
        raise ValueError(f"ode_rk4: the cotangent must match y, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")


def _pe_vjp(e: torch.Tensor, ge: torch.Tensor) -> torch.Tensor:
    """dL/dx of e = PE(x, 10) for dL/de = ge: d sin(2^f x) = 2^f cos, d cos
    = -2^f sin, both read from e."""
    n = e.shape[0]
    freqs = 2.0 ** torch.arange(MULTIRES, dtype=e.dtype, device=e.device)
    en = e[:, 3:X_DIM].reshape(n, MULTIRES, 6)
    gn = ge[:, 3:X_DIM].reshape(n, MULTIRES, 6)
    gxf = gn[..., :3] * en[..., 3:] - gn[..., 3:] * en[..., :3]
    return ge[:, :3] + (gxf * freqs[:, None]).sum(1)


def trunk_grads(net, times, like: torch.Tensor, dw: torch.Tensor,
                dwx: torch.Tensor, dtb: torch.Tensor, dbias: dict,
                want: set) -> dict:
    """name -> gradient of each parameter in `want` of the trunk and the
    time net, from a backward's parts: dw (7, 256, 256) the trunk blocks
    of `WIDE_LAYERS`, dwx (2, 256, 64) the PE(x) blocks of W0 and W5, dtb
    (len(times), 2, 256) the gradient at `time_biases`' output and dbias
    the gradients of the biases of the layers but 0 and 5, by layer. The
    time input's blocks W0[:, 63:], W5[:, 63:in], b0, b5 and the time net
    take theirs by autograd through `time_biases` on its rows."""
    named = list(net.named_parameters())
    l0, l5 = "trunk.0.", f"trunk.{SKIP + 1}."
    timed = [name for name, _ in named if name in want and (
        name.startswith(("timenet.", l0, l5)))]
    grads = {}
    if timed:
        params = dict(named)
        with torch.enable_grad():
            tb = time_biases(net, times, like)
            grads.update(zip(timed, torch.autograd.grad(
                tb, [params[name] for name in timed], dtb)))
    in_dim = net.trunk[0].in_features
    if l0 + "weight" in grads:
        grads[l0 + "weight"] = torch.cat(
            [dwx[0, :, :X_DIM], grads[l0 + "weight"][:, X_DIM:]], 1)
    if l5 + "weight" in grads:
        grads[l5 + "weight"] = torch.cat(
            [dwx[1, :, :X_DIM], grads[l5 + "weight"][:, X_DIM:in_dim],
             dw[WIDE_LAYERS.index(SKIP + 1)]], 1)
    for i, layer in enumerate(WIDE_LAYERS):
        if layer != SKIP + 1:
            grads[f"trunk.{layer}.weight"] = dw[i]
            grads[f"trunk.{layer}.bias"] = dbias[layer]
    return grads


def _param_grads(net: DeformNetworkODE, times, like: torch.Tensor,
                 dw: torch.Tensor, dwx: torch.Tensor, db: torch.Tensor,
                 need) -> list:
    """Each parameter's gradient from the sweep's parts: dw and dwx as
    `trunk_grads` takes them, db (4, PART_ROWS, 256) per stage the column
    sums of the gradients at layers 0-7's outputs (rows 0-7), dW_out (rows
    8-10) and db_out (row 11, columns 0-2). The time biases' gradient at
    each of the 3 times sums the layer 0 and 5 sums of the stages that
    share it."""
    named = list(net.named_parameters())
    need = [True] * len(named) if need is None else list(need)
    want = {name for (name, _), n in zip(named, need) if n}
    # by slices alone: an index tensor would be a copy from the host, which
    # waits for the device
    d = torch.stack([db[:, 0], db[:, SKIP + 1]], 1)
    dtb = torch.stack([d[0], d[1] + d[2], d[3]])
    grads = trunk_grads(net, times, like, dw, dwx, dtb, {
        layer: db[:, layer].sum(0) for layer in WIDE_LAYERS
        if layer != SKIP + 1}, want)
    grads["out.weight"] = db[:, DEPTH:DEPTH + 3].sum(0)
    grads["out.bias"] = db[:, DEPTH + 3, :3].sum(0)
    return [grads[name] if n else None for (name, _), n in zip(named, need)]


@torch.no_grad()
def rk4_step_vjp_torch(net: DeformNetworkODE, y: torch.Tensor, t, dt,
                       g: torch.Tensor, need=None):
    """Plain version of `rk4_step_vjp`: the four stages again in the
    kernel's form, each layer's input kept, then the reverse sweep, stages
    4 -> 1 and layers 7 -> 0, in PyTorch operators."""
    y, pk, times, tb = _prologue(net, y, t, dt, g)
    _, acts = _stages(net, pk, tb, y, dt)
    tr = net.trunk

    c1 = (dt / 6.0) * g
    gk = [c1, 2 * c1, 2 * c1, c1]
    gy = g.clone()
    dw = y.new_zeros((len(WIDE_LAYERS), WIDTH, WIDTH))
    dwx = y.new_zeros((2, WIDTH, X_ROWS))
    db = y.new_zeros((4, PART_ROWS, WIDTH))
    w_in = {i: tr[i].weight for i in WIDE_LAYERS}
    w_in[SKIP + 1] = pk.w5_h
    for s in (3, 2, 1, 0):
        hs = acts[s]
        go = gk[s] * net.output_scale
        db[s, DEPTH:DEPTH + 3] = go.T @ hs[DEPTH]
        db[s, DEPTH + 3, :3] = go.sum(0)
        d = (go @ net.out.weight) * (hs[DEPTH] > 0)
        for layer in range(DEPTH - 1, 0, -1):
            db[s, layer] = d.sum(0)
            dw[layer - 1] += d.T @ hs[layer]
            if layer == SKIP + 1:
                ge = d @ pk.w5_x
                dwx[1, :, :X_DIM] += d.T @ hs[0]
            d = (d @ w_in[layer]) * (hs[layer] > 0)
        db[s, 0] = d.sum(0)
        dwx[0, :, :X_DIM] += d.T @ hs[0]
        gx = _pe_vjp(hs[0], ge + d @ pk.w0_x)
        gy += gx
        if s:
            gk[s - 1] = gk[s - 1] + (dt if s == 3 else 0.5 * dt) * gx
    return gy, _param_grads(net, times, y, dw, dwx, db, need)


@torch.no_grad()
def rk4_step_vjp_cuda(net: DeformNetworkODE, y: torch.Tensor, t, dt,
                      g: torch.Tensor, need=None):
    """Launch `csrc/ode_rk4_bwd.cu`; raises if it cannot be built or
    launched. A K-split a SM for each of the 14 halves of the trunk's
    weight blocks (on the H100 132 splits: 14 waves; 44 or 88 read 4 % and
    1 % slower)."""
    with torch.cuda.device(y.device):
        return _vjp_kernel(
            _build.entry("ode_rk4_bwd", _ARGTYPES_BWD), net, y, t, dt, g,
            need, torch.cuda.get_device_properties(
                y.device).multi_processor_count,
            torch.cuda.current_stream(y.device).cuda_stream)


def _vjp_kernel(entry, net: DeformNetworkODE, y: torch.Tensor, t, dt,
                g: torch.Tensor, need, splits: int, stream):
    """`rk4_step_vjp` by the C entry `entry` of `csrc/ode_rk4_bwd.cu` on
    y's device (the tests pass a CPU build of it). Its scratch (each
    stage's layer outputs, the gradients at them, ReLU masks and partial
    sums: ~5.3 GB at N = 78,624) comes from PyTorch's allocator, which
    hands the same blocks to the next substep."""
    y, pk, times, tb = _prologue(net, y, t, dt, g)
    g = g.contiguous()
    n = y.shape[0]
    blocks = -(-n // 64)          # the most row tiles the kernel makes
    wlen = len(WIDE_LAYERS) * WIDTH * WIDTH + 2 * WIDTH * X_ROWS
    acts = y.new_empty(4 * n * (X_ROWS + DEPTH * WIDTH))
    deltas = y.new_empty(4 * n * DEPTH * WIDTH)
    masks = torch.empty(blocks * 4 * DEPTH * WIDTH * 4, dtype=torch.int32,
                        device=y.device)
    part = y.new_empty(blocks * 4 * PART_ROWS * WIDTH)
    wpart = y.new_empty(splits * wlen)
    dpart = y.new_empty((4, PART_ROWS, WIDTH))
    dws = y.new_empty(wlen)
    gy = torch.empty_like(y)
    err = entry(y.data_ptr(), g.data_ptr(), n, pk.w.data_ptr(),
                pk.wt.data_ptr(), pk.bias.data_ptr(), tb.data_ptr(),
                pk.w_out.data_ptr(), pk.b_out.data_ptr(),
                float(net.output_scale), 0.5 * dt, float(dt), dt / 6.0,
                acts.data_ptr(), deltas.data_ptr(), masks.data_ptr(),
                part.data_ptr(), wpart.data_ptr(), gy.data_ptr(),
                dpart.data_ptr(), dws.data_ptr(), splits, stream)
    if err != 0:
        raise RuntimeError(f"ode_rk4_bwd kernel launch failed: cudaError "
                           f"{err}")
    tracing.count("launches.ode_rk4_bwd")
    nw = len(WIDE_LAYERS) * WIDTH * WIDTH
    return gy, _param_grads(
        net, times, y, dws[:nw].view(len(WIDE_LAYERS), WIDTH, WIDTH),
        dws[nw:].view(2, WIDTH, X_ROWS), dpart, need)
