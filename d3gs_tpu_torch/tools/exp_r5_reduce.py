"""Blend-backward duplicate-reduction variants, timed on the card
(counterpart of `tools/exp_r5_reduce.py`).

    python -m d3gs_tpu_torch.tools.exp_r5_reduce [--device cpu] [--reps N]

The reduction sums the (M, 16) per-duplicate gradient rows, given
channel-major as (M/KB, 16, KB), into per-Gaussian rows by their rank. The
variants, on the JAX tool's inputs (numpy seed 0: M = 393,216 rows in 625
ascending per-tile runs of ranks below N1 - 1 = 44,032):

  V0: transpose to (M, 16), stable sort by rank, row gather, per-block
      lower-triangular cumsum as an f32 matmul, block carries, difference
      at the rank boundaries;
  V1: sort the 9 live channels by rank, a log-depth cumsum per channel,
      difference at the boundaries;
  V2: V3 with the transpose done by the row_copy kernel
      (`csrc/row_copy.cu`, the counterpart of the Pallas `_id_kernel`);
  V3: V0 with the triangular matmul on three bf16 parts of each value
      (x = x1 + x2 + x3 exactly), bf16 products summed in f32.

It prints the largest difference of V1-V3 from V0 and each variant's time
(CUDA events around repeated calls on the card; the host clock, labelled
so, with `--device cpu`), then the times of the pieces.
"""
from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.rows import row_copy
from .timing import clock, time_ms

M = 393_216
N1 = 44_033
KB = 128
REC = 16
LIVE = 9
TILES = 625


class Inputs(NamedTuple):
    g: torch.Tensor            # (M/KB, 16, KB) f32, channel-major rows
    rank: torch.Tensor         # (M,) int32, ascending within each tile run
    bounds_all: torch.Tensor   # (N1 + 2,) int32 segment starts, then M, M


def make_inputs(device, *, m: int = M, n1: int = N1, kb: int = KB,
                tiles: int = TILES, seed: int = 0) -> Inputs:
    """The JAX tool's inputs, drawn in its order from
    numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    bounds = np.sort(rng.choice(m - 1, tiles - 1, replace=False) + 1)
    runs = np.split(np.arange(m), bounds)
    rank = np.concatenate([np.sort(rng.integers(0, n1 - 1, len(r)))
                           for r in runs]).astype(np.int32)
    cnt = np.bincount(rank, minlength=n1)
    rb = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
    g = rng.standard_normal((m // kb, REC, kb)).astype(np.float32)
    bounds_all = np.concatenate([rb[:n1], [m, m]]).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return Inputs(t(g), t(rank), t(bounds_all))


def boundary_diff(cs: torch.Tensor, bounds_all: torch.Tensor) -> torch.Tensor:
    """(N1 + 1, C): cs at each segment's last row minus cs before it."""
    def at_prev(idx):
        row = cs[(idx.long() - 1).clamp_min(0)]
        return torch.where((idx > 0)[:, None], row, 0.0)
    return at_prev(bounds_all[1:]) - at_prev(bounds_all[:-1])


def _tri_cumsum_f32(g3: torch.Tensor) -> torch.Tensor:
    """within[b, i, c] = Σ_{j<=i} g3[b, j, c], one f32 matmul."""
    mb, kb, rec = g3.shape
    tri = torch.tril(torch.ones((kb, kb), device=g3.device))
    flat = g3.permute(1, 0, 2).reshape(kb, mb * rec)
    return (tri @ flat).reshape(kb, mb, rec).permute(1, 0, 2)


def _split3(x: torch.Tensor):
    x1 = x.to(torch.bfloat16)
    r1 = x - x1.float()
    x2 = r1.to(torch.bfloat16)
    x3 = (r1 - x2.float()).to(torch.bfloat16)
    return x1, x2, x3


def _mm_bf16_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 × bf16 with f32 results. On the card one bf16 tensor-core GEMM
    that writes f32; the CPU has no such kernel, and multiplies the same
    (exactly representable) values in f32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _tri_cumsum_bf16(g3: torch.Tensor) -> torch.Tensor:
    mb, kb, rec = g3.shape
    tri = torch.tril(torch.ones((kb, kb), device=g3.device,
                                dtype=torch.bfloat16))
    parts = [p.permute(1, 0, 2).reshape(kb, mb * rec) for p in _split3(g3)]
    d = [_mm_bf16_f32(tri, p) for p in parts]
    within = d[0] + (d[1] + d[2])
    return within.reshape(kb, mb, rec).permute(1, 0, 2)


def _reduce_rows(g_flat, rank, bounds_all, kb, tri_cumsum):
    m, rec = g_flat.shape
    invperm = torch.sort(rank, stable=True).indices
    g3 = g_flat[invperm].reshape(m // kb, kb, rec)
    within = tri_cumsum(g3)
    bsum = g3.sum(dim=1)
    bpre = torch.cumsum(bsum, dim=0) - bsum
    cs = (within + bpre[:, None, :]).reshape(m, rec)
    return boundary_diff(cs, bounds_all)


def _to_rows(g: torch.Tensor) -> torch.Tensor:
    mb, rec, kb = g.shape
    return g.transpose(1, 2).reshape(mb * kb, rec)


def v0(g, rank, bounds_all):
    return _reduce_rows(_to_rows(g), rank, bounds_all, g.shape[2],
                        _tri_cumsum_f32)


def v3(g, rank, bounds_all):
    return _reduce_rows(_to_rows(g), rank, bounds_all, g.shape[2],
                        _tri_cumsum_bf16)


def v2(g, rank, bounds_all):
    return _reduce_rows(row_copy(g.transpose(1, 2)), rank, bounds_all,
                        g.shape[2], _tri_cumsum_bf16)


def logdepth_cumsum_1d(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum by doubling shifts inside rows of 512, then the
    rows' carries."""
    x2 = x.reshape(-1, 512)
    d = 1
    while d < 512:
        x2 = x2 + F.pad(x2, (d, 0))[:, :512]
        d *= 2
    rowsum = x2[:, -1]
    carry = torch.cumsum(rowsum, dim=0) - rowsum
    return (x2 + carry[:, None]).reshape(-1)


def v1(g, rank, bounds_all):
    mb, _, kb = g.shape
    perm = torch.sort(rank, stable=True).indices
    cs = torch.stack([logdepth_cumsum_1d(g[:, c, :].reshape(mb * kb)[perm])
                      for c in range(LIVE)], dim=1)
    return boundary_diff(cs, bounds_all)


VARIANTS = {"V0": v0, "V1": v1, "V2": v2, "V3": v3}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    parser.add_argument("--reps", type=int, default=20,
                        help="timed calls per variant")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    inp = make_inputs(dev)
    g, rank, bounds_all = inp

    outs = {name: fn(*inp) for name, fn in VARIANTS.items()}
    ref = outs["V0"]
    diffs = {"max_abs_v0_v1": float((ref[:, :LIVE] - outs["V1"]).abs().max()),
             "max_abs_v0_v2": float((ref - outs["V2"]).abs().max()),
             "max_abs_v0_v3": float((ref - outs["V3"]).abs().max()),
             "max_abs_v0": float(ref.abs().max())}
    print(f"max|v0-v1| = {diffs['max_abs_v0_v1']:.3e}   max|v0-v2| = "
          f"{diffs['max_abs_v0_v2']:.3e}   max|v0-v3| = "
          f"{diffs['max_abs_v0_v3']:.3e}   (max|v0| = "
          f"{diffs['max_abs_v0']:.3e})", flush=True)

    labels = {"V0": "V0 current (sort+gather+f32 tri)",
              "V3": "V3 = V0 with bf16x3 tri",
              "V2": "V2 = V3 + row_copy kernel row-major",
              "V1": "V1 sort-payload (9ch)"}
    pieces = {
        "piece: sort (rank, iota)":
            lambda: torch.sort(rank, stable=True).indices,
        "piece: 10-op sort": lambda: [
            g[:, c, :].reshape(-1)[torch.sort(rank, stable=True).indices]
            for c in range(LIVE)],
        "piece: transpose to (M,16)": lambda: _to_rows(g) * 1.0,
        "piece: row_copy to (M,16)": lambda: row_copy(g.transpose(1, 2)),
        "piece: 9ch extract only": lambda: sum(
            g[:, c, :].reshape(-1) for c in range(LIVE)),
    }
    ms = {}
    print(f"times: {clock(dev)}, mean of {args.reps} calls", flush=True)
    for name in ("V0", "V3", "V2", "V1"):
        ms[name] = time_ms(lambda f=VARIANTS[name]: f(*inp), dev, args.reps)
        print(f"{labels[name]:44s} {ms[name]:8.3f} ms/iter", flush=True)
    for name, fn in pieces.items():
        ms[name] = time_ms(fn, dev, args.reps)
        print(f"  {name:42s} {ms[name]:8.3f} ms/iter", flush=True)
    return {**diffs, "ms": ms, "clock": clock(dev), "M": M, "N1": N1}


if __name__ == "__main__":
    main()
