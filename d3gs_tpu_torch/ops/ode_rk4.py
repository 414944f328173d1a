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
never falls back from one to the other. `engages` is the rule by which
`models/deform/ode.py::_substep` takes this path; `launch_counts()` reads
the kernel's launches since the port's counters were last drained.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import tracing
from ..models.deform.networks import DeformNetworkODE, positional_encoding
from . import _build

WIDTH, DEPTH, SKIP, MULTIRES = 256, 8, 4, 10
X_DIM = 63                      # PE(x, 10)
X_ROWS = 64                     # PE(x) rows of the packed weights, padded
PACKED_ROWS = X_ROWS + 4 * WIDTH + X_ROWS + WIDTH + 2 * WIDTH
# the state's devices on which `_substep` takes this path
DEVICES = ("cuda",)

_P, _F, _LL = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
_ARGTYPES = [_P, _LL, _P, _P, _P, _P, _P, _F, _F, _F, _F, _P, _P]


def launch_counts() -> dict[str, int]:
    """Steps run by the kernel since the port's counters were last drained
    (`tracing.drain`), one a call of its C entry (which launches the
    128-row blocks of whole waves and, for the rest, a second grid); the
    plain version does not count."""
    return {"ode_rk4": tracing.counters().get("launches.ode_rk4", 0)}


def qualifies(net) -> bool:
    """The net is the fused step's: DeformNetworkODE, full MLP, PE, 8x256,
    one skip after layer 4, PE(x, 10)."""
    return (isinstance(net, DeformNetworkODE) and net.use_linear == 0
            and net.use_emb and net.W == WIDTH and net.D == DEPTH
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


class _Packed:
    """The net's parameters in the kernel's layout (detached), for the
    parameters' current values."""

    def __init__(self, net: DeformNetworkODE):
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
        self.w_out = net.out.weight.detach().contiguous()
        self.b_out = net.out.bias.detach().contiguous()
        # the parameter blocks the time bias folds: W0[:, 63:], W5[:, 63:in]
        self.w0_t = w(0)[:, X_DIM:]
        self.w5_t = w(SKIP + 1)[:, X_DIM:in_dim]
        self.w0_x = w(0)[:, :X_DIM]
        self.w5_x = w(SKIP + 1)[:, :X_DIM]
        self.w5_h = w(SKIP + 1)[:, in_dim:]


def _packed(net: DeformNetworkODE) -> _Packed:
    """The net's `_Packed`, rebuilt when a parameter was replaced or
    changed in place (its version counter moved)."""
    key = tuple((p.data_ptr(), p._version) for p in net.parameters())
    cached = getattr(net, "_ode_rk4_packed", None)
    if cached is None or cached[0] != key:
        cached = (key, _Packed(net))
        net._ode_rk4_packed = cached
    return cached[1]


def time_biases(net: DeformNetworkODE, pk: _Packed, times,
                like: torch.Tensor) -> torch.Tensor:
    """(len(times), 2, 256): c0 and c5 at each time. The times are filled
    on the device as f32, as `_time_column` fills them, with no copy from
    the host."""
    tt = like.new_empty((len(times), 1))
    for i, v in enumerate(times):
        tt[i].fill_(v)
    temb = positional_encoding(tt, net.t_multires)
    if net.timenet is not None:
        temb = net.timenet[1](torch.relu(net.timenet[0](temb)))
    b0, b5 = pk.bias[0], pk.bias[SKIP + 1]
    return torch.stack([F.linear(temb, pk.w0_t, b0),
                        F.linear(temb, pk.w5_t, b5)], dim=1)


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


@torch.no_grad()
def rk4_step_torch(net: DeformNetworkODE, y: torch.Tensor, t,
                   dt) -> torch.Tensor:
    """Plain version: the kernel's function in PyTorch operators."""
    _check(net, y, t, dt)
    pk = _packed(net)
    tb = time_biases(net, pk, stage_times(t, dt), y)
    tr = net.trunk

    def f(ti: int, x: torch.Tensor) -> torch.Tensor:
        x_emb = positional_encoding(x, MULTIRES)
        h = torch.relu(F.linear(x_emb, pk.w0_x, tb[ti, 0]))
        for i in range(1, SKIP + 1):
            h = torch.relu(tr[i](h))
        h = torch.relu(F.linear(x_emb, pk.w5_x) + F.linear(h, pk.w5_h)
                       + tb[ti, 1])
        for i in range(SKIP + 2, DEPTH):
            h = torch.relu(tr[i](h))
        return net.out(h) * net.output_scale

    k1 = f(0, y)
    k2 = f(1, y + 0.5 * dt * k1)
    k3 = f(1, y + 0.5 * dt * k2)
    k4 = f(2, y + dt * k3)
    return y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


@torch.no_grad()
def rk4_step_cuda(net: DeformNetworkODE, y: torch.Tensor, t,
                  dt) -> torch.Tensor:
    """Launch `csrc/ode_rk4.cu`; raises if it cannot be built or launched."""
    _check(net, y, t, dt)
    if 3 * y.shape[0] >= 2 ** 31:
        raise ValueError("ode_rk4: y must hold fewer than 2**31 floats")
    y = y.contiguous()
    pk = _packed(net)
    tb = time_biases(net, pk, stage_times(t, dt), y)
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        err = _build.entry("ode_rk4", _ARGTYPES)(
            y.data_ptr(), y.shape[0], pk.w.data_ptr(), pk.bias.data_ptr(),
            tb.data_ptr(), pk.w_out.data_ptr(), pk.b_out.data_ptr(),
            float(net.output_scale), 0.5 * dt, float(dt), dt / 6.0,
            out.data_ptr(), torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ode_rk4 kernel launch failed: cudaError {err}")
    tracing.count("launches.ode_rk4")
    return out
