"""Readings that the real-scene cell's limits and duplicate budget are set
from, on the card at the cell's own sizes (PERF.md keeps what they gave):

    python3 -m benchmark.calibrate_real --seeds 1 2 3 \
        [--workload hyper_mlp_ast_train] [--dups]

For each seed: the cell's set-up, then the numbers `correct` compares, of
the program against the reference (`program`), of the control (the
reference in TF32 put in the program's place) and of the faults the check
has to see, each the reference's in the program's place: AST off
(`ast_off`: every step at its frame's own time), the loss over half the
frame (`half_frame`: the frame's top half, its mean taken there, a
one-camera step's counterpart of leaving out half a batch) and a state
left unchanged (`unchanged`: every change norm 0). Then the duplicates
the binning would keep in each of the cell's views, from the reference's
tile rectangles of the teacher and of the student the program starts
from, whose largest sets `dup_capacity` (`--dups`: those alone). One JSON
line per seed on stdout.
(`benchmark/calibrate.py` draws square views, and halves a batch of
cameras, which a one-camera step does not have.)
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from . import run as harness
from . import scene
from .loops import common, train_real
from .reference import fields, losses, render


@contextlib.contextmanager
def half_frame():
    """The reference's photometric loss over the top half of each frame."""
    real = losses.photometric
    top = lambda x: x[:x.shape[0] // 2]  # noqa: E731
    losses.photometric = lambda a, b, lam: real(top(a), top(b), lam)
    try:
        yield
    finally:
        losses.photometric = real


@torch.no_grad()
def dups(cfg: dict, mix: dict, seed: int, device="cuda") -> dict:
    """Largest, smallest and mean duplicates over the views, of the
    teacher and of the student."""
    gen, teacher, alive, weights = common.build(cfg, seed, device)
    student = scene.perturb(teacher, alive, gen, mix["colour_sd"],
                            mix["opacity_sd"])
    out = {}
    for name, params in (("teacher", teacher), ("student", student)):
        m = []
        for v in train_real.views(mix, cfg, device):
            dx, dr, ds = fields.mlp(weights, cfg["field"], params["xyz"],
                                    v.fid)
            sp = render.splats_for(params, alive, params["xyz"] + dx, dr, ds,
                                   v)
            r = sp.rect
            area = (r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])
            m.append(int(area[sp.visible].sum()))
        out[name] = {"max": max(m), "min": min(m), "mean": sum(m) / len(m)}
    return out


def readings(workload: str, seed: int, device="cuda") -> dict:
    bench = harness.spec()
    _, cfg, mix, _ = harness.cell_files(bench, workload)
    loop = train_real.Loop(cfg, mix, seed, device)
    loop.setup()
    loop.release()
    ref = loop.reference()
    out = {"workload": workload, "seed": seed,
           "program": loop.numbers(loop.prog, ref),
           "control": loop.numbers(loop.reference(tf32=True), ref),
           "ast_off": loop.numbers(loop.reference(jitter=False), ref)}
    with half_frame():
        out["half_frame"] = loop.numbers(loop.reference(), ref)
    still = dict(loop.prog, change_norms={k: 0.0 for k in
                                          loop.prog["change_norms"]})
    out["unchanged"] = loop.numbers(still, ref)
    out["dups"] = dups(cfg, mix, seed, device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="hyper_mlp_ast_train")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dups", action="store_true")
    args = p.parse_args(argv)
    for seed in args.seeds:
        if args.dups:
            _, cfg, mix, _ = harness.cell_files(harness.spec(), args.workload)
            out = {"seed": seed, "dups": dups(cfg, mix, seed)}
        else:
            out = readings(args.workload, seed)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
