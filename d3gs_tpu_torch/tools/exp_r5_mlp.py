"""Deform-MLP time by compute dtype, forward and forward + backward, on the
card (counterpart of `tools/exp_r5_mlp.py`).

    python -m d3gs_tpu_torch.tools.exp_r5_mlp [--device cpu] [--reps N] [--n N]

The bench's Blender baseline MLP (8x256, the timenet, full heads) on
bench.py's 43,132 points (numpy seed 0, uniform in [-1.3, 1.3]^3) at t =
0.5, in float32 (TF32 off) and in bfloat16 (`compute_dtype`); the backward
takes the gradients of the parameters and the points from sum(dx² + dr² +
ds²), as the JAX tool does. The JAX tool's other arms choose XLA's matmul
passes on the TPU and have no counterpart here. Times: CUDA events on the
card, the host clock (labelled so) with `--device cpu`.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..models.deform.fields import DeformFieldSpec, create_deform_field
from .timing import clock, time_ms

N = 43_132
FID = 0.5


def make_inputs(device, n: int = N) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy((rng.random((n, 3)) * 2.6 - 1.3)
                            .astype(np.float32)).to(device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    parser.add_argument("--reps", type=int, default=20,
                        help="timed calls per variant")
    parser.add_argument("--n", type=int, default=N, help="points")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    xyz = make_inputs(dev, args.n)
    ms = {}
    for dtype in ("float32", "bfloat16"):
        field = create_deform_field(DeformFieldSpec(
            kind="baseline", is_blender=True, compute_dtype=dtype),
            device=dev)
        params = list(field.net.parameters())

        @torch.no_grad()
        def fwd():
            return field.step(xyz, FID)

        def fwd_bwd():
            x = xyz.detach().requires_grad_()
            dx, dr, ds = field.step(x, FID)
            loss = (dx * dx).sum() + (dr * dr).sum() + (ds * ds).sum()
            return torch.autograd.grad(loss, [*params, x])

        ms[f"{dtype} fwd"] = time_ms(fwd, dev, args.reps)
        ms[f"{dtype} fwd+bwd"] = time_ms(fwd_bwd, dev, args.reps)
    print(f"deform MLP (8x256 Blender) at N={args.n}: {clock(dev)}, mean of "
          f"{args.reps} calls", flush=True)
    for name, t in ms.items():
        print(f"   {name:18s} {t:8.3f} ms", flush=True)
    ratio = ms["bfloat16 fwd+bwd"] / ms["float32 fwd+bwd"]
    print(f"   bf16 / f32 fwd+bwd: {ratio:.3f}", flush=True)
    return {"ms": ms, "bf16_over_f32_fwd_bwd": ratio, "n": args.n,
            "clock": clock(dev)}


if __name__ == "__main__":
    main()
