"""The plain reference against the port's CPU path at tiny sizes: a sound
run of each cell comes out correct under the cell's own limits, and the
same run with the deformation MLP computed in bfloat16 does not."""
import pytest

from benchmark import run as harness
from benchmark.loops import common

from . import tiny

CELLS = ["trex_mlp_train", "trex_ode_train", "trex_mlp_view",
         "trex_ode_view"]
SEED = 2 ** 31 + 77


def run_tiny(workload, seed=SEED, seconds=0.5):
    bench, cell, cfg, mix, limits = tiny.cell(workload)
    return harness.run_cell(bench, cell, cfg, mix, limits, seed, seconds,
                            False, "cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out, r, numbers = run_tiny(workload)
    assert out["correct"], (out["checks"], numbers)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) >= {"failed"}


@pytest.mark.parametrize("workload", ["trex_mlp_train", "trex_mlp_view"])
def test_bf16_field_is_not(workload, monkeypatch):
    bench, cell, cfg, mix, limits = tiny.cell(workload)
    cfg["model"]["deform_dtype"] = "bfloat16"
    monkeypatch.setattr(common, "check_field", lambda field, ref: None)
    out, _, numbers = harness.run_cell(bench, cell, cfg, mix, limits, SEED,
                                       0.5, False, "cpu")
    assert not out["correct"], (out["checks"], numbers)


def test_program_field_must_match(monkeypatch):
    bench, cell, cfg, mix, limits = tiny.cell("trex_mlp_train")
    cfg["model"]["deform_dtype"] = "bfloat16"
    with pytest.raises(ValueError):
        harness.run_cell(bench, cell, cfg, mix, limits, SEED, 0.5, False,
                         "cpu")
