"""Readings that the correctness limits and the duplicate budget are set
from, on the card at a cell's own sizes (PERF.md keeps what they gave):

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 \
        [--control] [--half-batch] [--seconds 3]
    python3 -m benchmark.calibrate --dups <config> --seeds 1 2 3

For each seed: the cell's set-up (and, for a viewing cell, a short
window), then the numbers `correct` compares, of the program against the
reference; with `--control` also of the control (the reference in TF32,
put in the program's place) against the reference; with `--half-batch`
(batched training) of the reference over half of each batch, its mean
taken over the rest. `--dups` prints the duplicates the binning would
keep for every view of every cell of a configuration (the reference's
tile rectangles), whose largest sets `dup_capacity`. One JSON line per
seed on stdout.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from . import run as harness
from . import scene


def readings(workload: str, seed: int, seconds: float, control: bool,
             half_batch: bool) -> dict:
    bench = harness.spec()
    cell, cfg, mix, _ = harness.cell_files(bench, workload)
    loop = importlib.import_module(f"benchmark.loops.{mix['loop']}").Loop(
        cfg, mix, seed, "cuda")
    loop.setup()
    if mix["loop"] != "train":
        loop.window(seconds, False)
    loop.release()
    ref = loop.reference()
    prog = loop.prog if mix["loop"] == "train" else dict(loop.sample)
    out = {"workload": workload, "seed": seed,
           "program": loop.numbers(prog, ref)}
    if control:
        out["control"] = loop.numbers(loop.reference(tf32=True), ref)
    if half_batch:
        full = loop.batches
        loop.batches = [b[:max(1, len(b) // 2)] for b in full]
        out["half_batch"] = loop.numbers(loop.reference(), ref)
        loop.batches = full
    return out


@torch.no_grad()
def dups(config: str, seed: int) -> dict:
    """Duplicates of every training view and orbit frame of the cells of
    `config`, from the reference's projection of the seed's scene."""
    from .loops import common
    from .reference import fields, render
    bench = harness.spec()
    cells = [w for w in bench["workloads"] if w["config"] == config]
    _, cfg, _, _ = harness.cell_files(bench, cells[0]["name"])
    _, params, alive, weights = common.build(cfg, seed, "cuda")
    fref = cfg["field"]
    out = {}
    for w in cells:
        _, _, mix, _ = harness.cell_files(bench, w["name"])
        if mix["loop"] == "train":
            views = scene.train_views(mix["views"], cfg["radius"],
                                      mix["size"], cfg["fovx"], "cuda")
        else:
            views = [scene.orbit_view(i, mix["period"], cfg["radius"],
                                      mix["elevation_deg"], mix["size"],
                                      cfg["fovx"], "cuda")
                     for i in range(mix["period"])]
        xyz = params["xyz"]
        m = []
        for v in views:
            if fref["kind"] == "ode":
                f = fields.dynamics(weights, fref)
                means, dr, ds = fields.from_zero(
                    f, xyz, v.fid, 2 * fref["n_substeps"]), 0.0, 0.0
            else:
                dx, dr, ds = fields.mlp(weights, fref, xyz, v.fid)
                means = xyz + dx
            sp = render.splats_for(params, alive, means, dr, ds, v)
            r = sp.rect
            area = (r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])
            m.append(int(area[sp.visible].sum()))
        out[w["name"]] = {"max": max(m), "min": min(m),
                          "mean": sum(m) / len(m)}
    return {"config": config, "seed": seed, "dups": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--dups")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--half-batch", action="store_true")
    args = p.parse_args(argv)
    for seed in args.seeds:
        if args.dups:
            out = dups(args.dups, seed)
        else:
            out = readings(args.workload, seed, args.seconds, args.control,
                           args.half_batch)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
