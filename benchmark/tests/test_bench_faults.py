"""A run with the timed path broken underneath comes out not correct, for
each fault its cell can have: a training step that returns its state
unchanged, a batched step that leaves out half of its batch (the mean
taken over the rest), a frame altered where it is produced. (No cell
spans chips, so none can leave out an exchange between them.)"""
import pytest
import torch

from benchmark import program
from benchmark import run as harness

from . import tiny

SEED = 2 ** 31 + 91


def run_broken(workload):
    bench, cell, cfg, mix, limits = tiny.cell(workload)
    return harness.run_cell(bench, cell, cfg, mix, limits, SEED, 0.5, False,
                            "cpu")


@pytest.mark.parametrize("workload", ["trex_mlp_train", "trex_ode_train"])
def test_state_left_unchanged(workload, monkeypatch):
    real = program.make_step

    def make_step(cfg, model, opt, pipe, field):
        step = real(cfg, model, opt, pipe, field)

        def unchanged(state, ds, cams, it, bg):
            w0 = [t.detach().clone() for t in program.field_tensors(field)]
            _, _, aux, frames = step(state, ds, cams, it, bg)
            with torch.no_grad():
                for t, w in zip(program.field_tensors(field), w0):
                    t.copy_(w)
            return state, ds, aux, frames
        return unchanged

    monkeypatch.setattr(program, "make_step", make_step)
    out, _, numbers = run_broken(workload)
    assert not out["correct"], (out["checks"], numbers)


def test_half_of_the_batch_left_out(monkeypatch):
    real = program.make_step

    def make_step(cfg, model, opt, pipe, field):
        step = real(cfg, model, opt, pipe, field)
        return lambda state, ds, cams, it, bg: step(
            state, ds, cams[:max(1, len(cams) // 2)], it, bg)

    monkeypatch.setattr(program, "make_step", make_step)
    out, _, numbers = run_broken("trex_ode_train")
    assert not out["correct"], (out["checks"], numbers)


@pytest.mark.parametrize("workload", ["trex_mlp_view", "trex_ode_view"])
def test_frame_altered(workload, monkeypatch):
    real = program.render_frame

    def render_frame(*args):
        out = real(*args)
        return out._replace(image=out.image + 1.0 / 255.0)

    monkeypatch.setattr(program, "render_frame", render_frame)
    out, _, numbers = run_broken(workload)
    assert not out["correct"], (out["checks"], numbers)


@pytest.mark.parametrize("workload", ["trex_mlp_train", "trex_ode_train",
                                      "trex_mlp_view"])
def test_budget_is_a_frames(workload):
    """A frame whose duplicates reach `dup_capacity` fails the run; a
    batch whose frames sum past it, none reaching it, does not."""
    bench, cell, cfg, mix, limits = tiny.cell(workload)
    out, r, _ = harness.run_cell(bench, cell, cfg, mix, limits, SEED, 0.3,
                                 False, "cpu")
    largest = r["dups_max"]
    assert out["correct"] and largest > 0
    cfg["dup_capacity"] = largest + 512
    out, _, _ = harness.run_cell(bench, cell, cfg, mix, limits, SEED, 0.3,
                                 False, "cpu")
    assert out["correct"], out["checks"]
    cfg["dup_capacity"] = largest - 512
    out, _, _ = harness.run_cell(bench, cell, cfg, mix, limits, SEED, 0.3,
                                 False, "cpu")
    assert not out["correct"] and out["failed"] > 0
