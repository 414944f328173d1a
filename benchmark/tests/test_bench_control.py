"""The control on the card: the plain reference computed in TF32 (the
precision below the configurations' float32), put in the program's place,
fails the cell's limits, while the program passes them; at the cells'
widths over fewer Gaussians and pixels, so that a test run holds it. The
cells' own sizes are measured by `python3 -m benchmark.calibrate
--control` (PERF.md)."""
import copy

import pytest

from benchmark import run as harness
from benchmark.loops import train, view

from . import tiny

CELLS = list(tiny.CELLS)


def small(workload):
    config, traffic = tiny.CELLS[workload]
    cfg, mix, limits = harness.files(f"benchmark/configs/{config}.json",
                                     traffic, workload)
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg["gaussians"] = 16384
    if mix["loop"] == "train":
        mix.update(size=200)
    else:
        mix.update(size=400, checked_frames=4)
    return cfg, mix, limits


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102,
                                  2 ** 31 + 103])
def test_control_fails_the_limits(workload, seed, card):
    cfg, mix, limits = small(workload)
    kind = train if mix["loop"] == "train" else view
    loop = kind.Loop(cfg, mix, seed, card)
    loop.setup()
    if mix["loop"] != "train":
        loop.window(1.0, False)
    loop.release()
    ref = loop.reference()
    prog = loop.prog if mix["loop"] == "train" else dict(loop.sample)
    sound = loop.numbers(prog, ref)
    control = loop.numbers(loop.reference(tf32=True), ref)
    compared = [k for k, v in limits.items() if v is not None]
    assert all(sound[k] <= limits[k] for k in compared), sound
    assert any(control[k] > limits[k] for k in compared), control
