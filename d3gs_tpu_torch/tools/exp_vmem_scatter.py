"""Row scatter-accumulate of per-duplicate gradient rows, checked and timed
on the card (counterpart of `tools/exp_vmem_scatter.py`).

    python -m d3gs_tpu_torch.tools.exp_vmem_scatter [--device cpu] [--reps N]

The JAX microbenchmark measures a Pallas kernel that keeps an (N1, 16)
accumulator in VMEM across its sequential grid and adds one row per record
at its rank, at three loop unrolls, to decide whether such a reduction can
beat XLA's sort + gather + cumsum. Here the function, out[rank[m], :] +=
g[m, :], is one kernel, `csrc/scatter_add_rows.cu`, that adds with atomics
(the TPU unroll factor has no counterpart). Inputs as in the JAX tool
(numpy seed 0): (2752, 128, 16) uniform rows (M = 352,256) and uniform ranks
below N1 = 44,032. It prints the kernel's largest difference from the plain
version (a float64 segment sum) beside the largest sum, and the times of
the kernel, of `Tensor.index_add_` (the library call) and of the plain
version (CUDA events on the card; the host clock, labelled so, with
`--device cpu`).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..ops.rows import scatter_add_rows, scatter_add_rows_torch
from .timing import clock, time_ms

M = 352_256
KB = 128
MB = M // KB
REC = 16
N1 = 44_032


def make_inputs(device, *, m: int = M, n1: int = N1, seed: int = 0):
    """(g (m/KB, KB, 16) f32, ranks (m/KB, KB) int32) as the JAX tool draws
    them."""
    rng = np.random.default_rng(seed)
    g = rng.random((m // KB, KB, REC)).astype(np.float32)
    ranks = rng.integers(0, n1, m).astype(np.int32).reshape(m // KB, KB)
    return torch.from_numpy(g).to(device), torch.from_numpy(ranks).to(device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    parser.add_argument("--reps", type=int, default=20,
                        help="timed calls per variant")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    g, ranks = make_inputs(dev)
    out = scatter_add_rows(g, ranks, N1)
    want = scatter_add_rows_torch(g, ranks, N1)
    err = float((out - want).abs().max())
    scale = float(want.abs().max())
    print(f"scatter_add_rows: max err vs segment sum {err:.2e} "
          f"(= {err / scale:.2e} of the largest sum {scale:.3e})",
          flush=True)
    rows_flat, rank_flat = g.reshape(-1, REC), ranks.reshape(-1)

    def library():
        return torch.zeros((N1, REC), device=dev).index_add_(
            0, rank_flat, rows_flat)

    ms = {"scatter_add_rows": time_ms(
              lambda: scatter_add_rows(g, ranks, N1), dev, args.reps),
          "index_add_": time_ms(library, dev, args.reps),
          "plain": time_ms(lambda: scatter_add_rows_torch(g, ranks, N1), dev,
                           args.reps)}
    print(f"times: {clock(dev)}, mean of {args.reps} calls", flush=True)
    for name, t in ms.items():
        print(f"  {name:16s} {t:8.4f} ms/iter ({t * 1e6 / M:.3f} ns/row)",
              flush=True)
    return {"max_abs_err": err, "max_abs_sum": scale, "ms": ms, "M": M,
            "N1": N1, "clock": clock(dev)}


if __name__ == "__main__":
    main()
