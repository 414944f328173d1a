"""Tiny copies of the cells for the CPU: the configurations' fields at
D = 6, W = 32, multires 2 (heads at nn.Linear's range) over 300
Gaussians, 32x32 views, the flagship at k = 3 over a 6-view sequence."""
from __future__ import annotations

import copy
import json

from benchmark import run as harness


# the cells with their files: BENCHMARK.json's, and the MLP cells kept in
# benchmark/ for a later PR (PERF.md §7), whose field the bf16 test needs
CELLS = {
    "trex_mlp_train": ("dnerf_trex_mlp", "train_carried"),
    "trex_ode_train": ("dnerf_trex_ode_k10", "train_carried"),
    "trex_mlp_view": ("dnerf_trex_mlp", "view_orbit"),
    "trex_ode_view": ("dnerf_trex_ode_k10", "view_orbit"),
}


def cell(workload: str):
    """(bench, cell, configuration, mix, limits) of `workload` at tiny
    sizes; the limits are the cell's own."""
    config, traffic = CELLS[workload]
    cfg, mix, limits = harness.files(f"benchmark/configs/{config}.json",
                                     traffic, workload)
    c = {"name": workload, "config": config, "traffic": traffic, "chips": 1}
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg["gaussians"] = 300
    for d in (cfg["field"], cfg["model"]):
        d.update(D=6, W=32, multires=2)
    cfg["field"]["skip"] = 3 if cfg["field"]["kind"] == "baseline" else 4
    # the heads at nn.Linear's own range: the deformation is then large
    # enough at 32x32 for a bf16 field to show in the images
    cfg["field"]["head_init"] = 1.0
    if cfg["trainer"] != "baseline":
        cfg["optimization"].update(num_cams_per_iter=3, sequence_length=6)
    if mix["loop"] == "train":
        mix.update(views=6, size=32, log_every=2, profile_seconds=0.0)
    else:
        mix.update(size=32, period=10, checked_frames=3, profile_seconds=0.0)
    return harness.spec(), c, cfg, mix, limits


def dumps(x) -> str:
    return json.dumps(x, sort_keys=True)
