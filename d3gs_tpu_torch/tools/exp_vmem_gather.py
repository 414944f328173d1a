"""Row gather from a (N, 16) table, checked and timed on the card
(counterpart of `tools/exp_vmem_gather.py`).

    python -m d3gs_tpu_torch.tools.exp_vmem_gather [--device cpu] [--reps N]

The JAX probe asks whether a Pallas kernel can gather rows per index lane
from a VMEM-resident table, with `jnp.take` (variant A) or a loop of
dynamic row slices (variant C). Both compute out[s, k, :] =
table[idx[s, k], :]; here they are one kernel, `csrc/row_gather.cu`, whose
table is served from the L2 cache. Inputs as in the JAX tool (numpy seed
0): a (44,032, 16) table of uniform floats and (512, 128) uniform indices,
65,536 rows a call. It prints whether the kernel equals numpy's gather
exactly, and the times of the kernel, of `torch.index_select` (the library
call) and of the plain version (CUDA events on the card; the host clock,
labelled so, with `--device cpu`).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..ops.rows import row_gather, row_gather_torch
from .timing import clock, time_ms

N = 44_032
REC = 16
KB = 128
STEPS = 512          # gathered rows per call = STEPS * KB


def make_inputs(device, *, n: int = N, steps: int = STEPS, seed: int = 0):
    """(table (n, 16) f32, idx (steps, KB) int32) as the JAX tool draws
    them."""
    rng = np.random.default_rng(seed)
    table = rng.random((n, REC)).astype(np.float32)
    idx = rng.integers(0, n, (steps, KB)).astype(np.int32)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(idx).to(device))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    parser.add_argument("--reps", type=int, default=50,
                        help="timed calls per variant")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    table, idx = make_inputs(dev)
    want = table.cpu().numpy()[idx.cpu().numpy()]
    got = row_gather(table, idx).cpu().numpy()
    exact = bool(np.array_equal(got, want))
    print(f"row_gather: shape {got.shape}, equals numpy's gather "
          f"exactly: {exact}", flush=True)
    rows = idx.numel()
    flat = idx.reshape(-1)
    ms = {"row_gather": time_ms(lambda: row_gather(table, idx), dev,
                                args.reps),
          "index_select": time_ms(
              lambda: torch.index_select(table, 0, flat), dev, args.reps),
          "plain": time_ms(lambda: row_gather_torch(table, idx), dev,
                           args.reps)}
    print(f"times: {clock(dev)}, mean of {args.reps} calls", flush=True)
    for name, t in ms.items():
        print(f"   {name:12s} {t:.4f} ms / {rows} rows = "
              f"{t * 1e6 / rows:.3f} ns/row", flush=True)
    return {"exact": exact, "ms": ms, "rows": rows, "clock": clock(dev)}


if __name__ == "__main__":
    main()
