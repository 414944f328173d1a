"""Row kernels of the dev tools: strided copy, gather, scatter-add of f32
rows of 16 (counterparts of the Pallas kernels in `tools/exp_r5_reduce.py`,
`tools/exp_vmem_gather.py` and `tools/exp_vmem_scatter.py`).

    row_copy(x)                 (B, R, 16) or (M, 16) view, any strides
                                -> contiguous (M, 16)
    row_gather(table, idx)      out[..., :] = table[idx[...], :]
    scatter_add_rows(g, rank, n)  out[rank[m], :] += g[m, :], out (n, 16)

Each wrapper launches its hand-written kernel (`csrc/row_copy.cu`,
`csrc/row_gather.cu`, `csrc/scatter_add_rows.cu`) for CUDA tensors and
takes its plain PyTorch version (`*_torch`) for CPU tensors; it never falls
back from one to the other. `launch_counts()` reads the kernel launches
per kernel since the port's counters were last drained (`tracing`).
"""
from __future__ import annotations

import ctypes

import torch

from .. import tracing
from . import _build

REC = 16
KERNELS = ("row_copy", "row_gather", "scatter_add_rows")


def launch_counts() -> dict[str, int]:
    """Launches of each row kernel since the counters were last drained."""
    c = tracing.counters()
    return {k: c.get("launches." + k, 0) for k in KERNELS}

_LL, _P = ctypes.c_longlong, ctypes.c_void_p
_COPY_ARGTYPES = [_P, _LL, _LL, _LL, _LL, _LL, _P, _P]
_GATHER_ARGTYPES = [_P, _P, _LL, _P, _P]
_SCATTER_ARGTYPES = [_P, _P, _LL, _P, _P]


def _as3d(x: torch.Tensor) -> torch.Tensor:
    """(M, 16) -> (1, M, 16) without a copy; (B, R, 16) as it is."""
    if x.ndim == 2:
        return x.unsqueeze(0)
    if x.ndim != 3:
        raise ValueError(f"rows: expected a (M, 16) or (B, R, 16) tensor, "
                         f"got shape {tuple(x.shape)}")
    return x


def _check(name: str, t: torch.Tensor, dtype, *, contiguous: bool = True,
           last: int | None = REC) -> None:
    if t.dtype != dtype or (contiguous and not t.is_contiguous()):
        raise ValueError(f"rows: {name} must be a{' contiguous' * contiguous} "
                         f"{dtype} tensor, got {t.dtype}")
    if last is not None and t.shape[-1] != last:
        raise ValueError(f"rows: {name} must end in {last} columns, got shape "
                         f"{tuple(t.shape)}")


def _check_index(name: str, idx: torch.Tensor, n: int) -> None:
    """Every index in [0, n): the kernels read and write unchecked."""
    _check(name, idx, torch.int32, last=None)
    if idx.numel() and not (int(idx.min()) >= 0 and int(idx.max()) < n):
        raise ValueError(f"rows: {name} holds an index outside [0, {n})")


def _launch(name: str, argtypes, *args, device) -> None:
    with torch.cuda.device(device):
        err = _build.entry(name, argtypes)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _dispatch(x: torch.Tensor, cuda_fn, torch_fn, *args):
    if x.is_cuda:
        return cuda_fn(*args)
    if x.device.type == "cpu":
        return torch_fn(*args)
    raise ValueError(f"rows: unsupported device {x.device}")


# --------------------------------------------------------------------------
# row_copy
# --------------------------------------------------------------------------

def row_copy(x: torch.Tensor) -> torch.Tensor:
    """Contiguous row-major (M, 16) copy of the f32 view `x`, (M, 16) or
    (B, R, 16) with any strides."""
    return _dispatch(x, row_copy_cuda, row_copy_torch, x)


def row_copy_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the kernel's addressing, b·s0 + r·s1 + c·s2 from the
    view's storage offset, as one index into the storage."""
    x3 = _as3d(x)
    _check("x", x3, torch.float32, contiguous=False)
    b, r, c = x3.shape
    s0, s1, s2 = x3.stride()
    dev = x.device
    off = (torch.arange(b, device=dev)[:, None, None] * s0
           + torch.arange(r, device=dev)[None, :, None] * s1
           + torch.arange(c, device=dev) * s2).reshape(-1)
    if off.numel() == 0:
        return x3.new_empty((0, c))
    flat = torch.as_strided(x3, (int(off.max()) + 1,), (1,))
    return flat[off].reshape(b * r, c)


def row_copy_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/row_copy.cu`; raises if it cannot be built or launched."""
    x3 = _as3d(x)
    _check("x", x3, torch.float32, contiguous=False)
    b, r, _ = x3.shape
    out = torch.empty((b * r, REC), dtype=torch.float32, device=x.device)
    launch_row_copy(x3, out)
    tracing.count("launches.row_copy")
    return out


def launch_row_copy(x3: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of the copy kernel from the (B, R, 16) view `x3` into the
    preallocated (B·R, 16) `out`, without the checks of `row_copy_cuda`
    (which calls it) and uncounted."""
    b, r, _ = x3.shape
    _launch("row_copy", _COPY_ARGTYPES, x3.data_ptr(), *x3.stride(), b, r,
            out.data_ptr(), device=x3.device)


# --------------------------------------------------------------------------
# row_gather
# --------------------------------------------------------------------------

def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(*idx.shape, 16): the rows of the (N, 16) f32 `table` at the int32
    `idx`, each in [0, N)."""
    return _dispatch(table, row_gather_cuda, row_gather_torch, table, idx)


def row_gather_torch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: advanced indexing."""
    _check("table", table, torch.float32)
    _check_index("idx", idx, table.shape[0])
    return table[idx.long()]


def row_gather_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/row_gather.cu`; raises if it cannot be built or
    launched."""
    _check("table", table, torch.float32)
    _check_index("idx", idx, table.shape[0])
    if table.ndim != 2 or idx.device != table.device:
        raise ValueError("rows: table must be (N, 16), idx on its device")
    if table.data_ptr() % 16:
        raise ValueError("rows: table must be 16-byte aligned (float4 rows)")
    out = torch.empty((*idx.shape, REC), dtype=torch.float32,
                      device=table.device)
    launch_row_gather(table, idx, out)
    tracing.count("launches.row_gather")
    return out


def launch_row_gather(table: torch.Tensor, idx: torch.Tensor,
                      out: torch.Tensor) -> None:
    """One launch of the gather kernel into the preallocated `out`, without
    the checks of `row_gather_cuda` (which calls it) and uncounted."""
    _launch("row_gather", _GATHER_ARGTYPES, table.data_ptr(), idx.data_ptr(),
            idx.numel(), out.data_ptr(), device=table.device)


# --------------------------------------------------------------------------
# scatter_add_rows
# --------------------------------------------------------------------------

def scatter_add_rows(g: torch.Tensor, rank: torch.Tensor,
                     n: int) -> torch.Tensor:
    """(n, 16) segment sums: out[rank[m], :] += g[m, :] over the rows of the
    (..., 16) f32 `g`, with the int32 `rank` (g's leading shape) in
    [0, n)."""
    return _dispatch(g, scatter_add_rows_cuda, scatter_add_rows_torch, g,
                     rank, n)


def _rows_and_rank(g, rank, n):
    _check("g", g, torch.float32)
    _check_index("rank", rank, n)
    if tuple(rank.shape) != tuple(g.shape[:-1]):
        raise ValueError(f"rows: rank has shape {tuple(rank.shape)}, g "
                         f"{tuple(g.shape)}")
    return g.reshape(-1, REC), rank.reshape(-1)


def scatter_add_rows_torch(g: torch.Tensor, rank: torch.Tensor,
                           n: int) -> torch.Tensor:
    """Plain version: a stable sort by rank, a float64 running sum of the
    sorted rows, and its difference across each rank's segment."""
    rows, rank = _rows_and_rank(g, rank, n)
    order = torch.sort(rank, stable=True).indices
    cs = torch.cumsum(rows[order].double(), dim=0)
    cs = torch.cat([cs.new_zeros((1, REC)), cs])
    ends = torch.searchsorted(rank[order],
                              torch.arange(n + 1, device=g.device,
                                           dtype=rank.dtype))
    return (cs[ends[1:]] - cs[ends[:-1]]).float()


def scatter_add_rows_cuda(g: torch.Tensor, rank: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Launch `csrc/scatter_add_rows.cu` into a zeroed (n, 16); raises if it
    cannot be built or launched."""
    rows, flat_rank = _rows_and_rank(g, rank, n)
    if rank.device != g.device:
        raise ValueError("rows: rank must be on g's device")
    out = torch.zeros((n, REC), dtype=torch.float32, device=g.device)
    launch_scatter_add_rows(rows, flat_rank, out)
    tracing.count("launches.scatter_add_rows")
    return out


def launch_scatter_add_rows(rows: torch.Tensor, rank: torch.Tensor,
                            out: torch.Tensor) -> None:
    """One launch of the scatter-add kernel, adding the (M, 16) `rows` into
    `out` (which the caller zeroes), without the checks of
    `scatter_add_rows_cuda` (which calls it) and uncounted."""
    _launch("scatter_add_rows", _SCATTER_ARGTYPES, rows.data_ptr(),
            rank.data_ptr(), rows.shape[0], out.data_ptr(), device=rows.device)
