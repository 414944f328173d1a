"""The real-scene recipe of deformable 3D Gaussians on the port: the
baseline trainer with AST (annealing smooth training) time noise, as
`train/baseline.py::ast_time` / `make_deform_fn` run it, on the CPU.

* The benchmark's real-scene cell (`benchmark/loops/train_real.py`) at a
  tiny size: a non-Blender 8x32 field, 512 Gaussians, 40x24 frames (a
  partial tile column and row), three checked steps of the port's
  baseline step against `benchmark/reference` with its own AST draws;
  and the same run with the timed path broken (AST off, the loss over
  half the frame, the state left unchanged) fails the cell's limits, as
  does a frame that reaches the duplicate budget.
* AST's time against linear_noise's formula, the reference's copy and
  the JAX package's schedule on the same draw; t = fid for Blender scenes
  and at evaluation; the counter `deform.ast` and the `deform` span's `t`.
* `train_baseline`'s losses on a fixed seed against the same run with the
  deform function the trainer had inline before AST was made public.
"""
import copy

import numpy as np
import pytest
import torch

from benchmark import program
from benchmark import run as harness
from benchmark import scene
from benchmark.loops import train_real
from benchmark.reference import ast as ref_ast
from d3gs_tpu.ops.schedules import linear_noise as jax_linear_noise
from d3gs_tpu_torch import config as C
from d3gs_tpu_torch import tracing
from d3gs_tpu_torch.data.cameras import Camera
from d3gs_tpu_torch.models import gaussians as G
from d3gs_tpu_torch.models.deform.fields import (DeformFieldSpec,
                                                 create_deform_field)
from d3gs_tpu_torch.ops.schedules import linear_noise
from d3gs_tpu_torch.train import baseline
from d3gs_tpu_torch.train import step as S
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

CELL = "hyper_mlp_ast_train"
SEED = 2 ** 31 + 77
# AST's schedule as d3gs_tpu/train/baseline.py:110-112 calls linear_noise
JAX_AST = dict(lr_init=0.1, lr_final=1e-15, lr_delay_mult=0.01,
               max_steps=20000)
ITERATIONS = (0, 1, 3000, 16000, 19999, 20000, 25000)
# The port's step against the reference at the tiny size, in float32 on
# the CPU. The two differ only in the order of float32 sums (the port's
# tile-binned compositing and separable SSIM blur against the reference's
# per-pixel walk and 2D convolution), which moved the 3-step losses by
# 3.6e-6 to 3.3e-5, a leaf's gradient norm by 2.9e-5 to 4.9e-5 and its
# change by 2.9e-6 to 3.3e-6 over the seeds tried: each tolerance is ~10x
# the largest. The faults move them by 0.1 to 1.
LOSS_TOL, GRAD_TOL, CHANGE_TOL = 3e-4, 5e-4, 5e-5


def tiny():
    """(bench, cell, configuration, mix, limits) of the cell at a tiny
    size; the limits are the cell's own."""
    bench = harness.spec()
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    _, cfg, mix, limits = harness.cell_files(bench, CELL)
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg["gaussians"] = 512
    for d in (cfg["field"], cfg["model"]):
        d.update(D=8, W=32)
    # the heads at nn.Linear's range: a 40x24 frame then shows the
    # deformation, and AST's jitter moves it
    cfg["field"]["head_init"] = 1.0
    mix.update(views=6, width=40, height=24, log_every=2,
               profile_seconds=0.0)
    return bench, cell, cfg, mix, limits


def run_tiny(seed=SEED):
    bench, cell, cfg, mix, limits = tiny()
    return harness.run_cell(bench, cell, cfg, mix, limits, seed, 0.3, False,
                            "cpu")


@pytest.mark.parametrize("seed", [SEED, 2 ** 31 + 91])
def test_baseline_step_with_ast_matches_reference(seed):
    out, r, numbers = run_tiny(seed)
    assert out["correct"], (out["checks"], numbers)
    assert numbers["loss_gap"] < LOSS_TOL, numbers
    assert numbers["grad_gap"] < GRAD_TOL, numbers
    assert numbers["change_gap"] < CHANGE_TOL, numbers
    # the same draws, the same formula in float64 on both sides
    assert numbers["t_gap"] == 0.0
    # every window step jittered its field's time
    assert r["ast_evals"] == r["window_views"] > 0


def _ast_off(monkeypatch):
    real = train_real.make_step
    monkeypatch.setattr(train_real, "make_step",
                        lambda *a: real(*a[:-1], None))


def _half_frame(monkeypatch):
    """The loss over the frame's top half, its mean taken there."""
    l1, ssim = S.l1_loss, S.ssim
    top = lambda x: x[:x.shape[0] // 2]  # noqa: E731
    monkeypatch.setattr(S, "l1_loss", lambda a, b: l1(top(a), top(b)))
    monkeypatch.setattr(S, "ssim", lambda a, b: ssim(top(a), top(b)))


def _unchanged(monkeypatch):
    real = train_real.make_step

    def make_step(opt, pipe, model, field, interval, gen):
        step = real(opt, pipe, model, field, interval, gen)

        def unchanged(state, ds, cams, it, bg):
            w0 = [t.detach().clone() for t in program.field_tensors(field)]
            _, _, aux, frames = step(state, ds, cams, it, bg)
            with torch.no_grad():
                for t, w in zip(program.field_tensors(field), w0):
                    t.copy_(w)
            return state, ds, aux, frames
        return unchanged
    monkeypatch.setattr(train_real, "make_step", make_step)


@pytest.mark.parametrize("fault", [_ast_off, _half_frame, _unchanged],
                         ids=["ast_off", "half_frame", "unchanged"])
def test_broken_step_fails_the_limits(fault, monkeypatch):
    fault(monkeypatch)
    out, _, numbers = run_tiny(2 ** 31 + 91)
    assert not out["correct"], (out["checks"], numbers)
    if fault is _ast_off:
        assert numbers["t_gap"] > out["checks"]["t_gap"]["limit"]


def test_a_frame_at_the_budget_fails():
    """A frame whose duplicates reach `dup_capacity` fails the run."""
    bench, cell, cfg, mix, limits = tiny()
    out, r, _ = harness.run_cell(bench, cell, cfg, mix, limits, SEED, 0.3,
                                 False, "cpu")
    largest = r["dups_max"]
    assert out["correct"] and largest > 0
    for capacity, fails in ((largest + 512, False), (largest - 512, True)):
        cfg["dup_capacity"] = capacity
        out, _, _ = harness.run_cell(bench, cell, cfg, mix, limits, SEED,
                                     0.3, False, "cpu")
        assert out["correct"] != fails and (out["failed"] > 0) == fails


def test_ast_time_is_the_schedule_on_the_draw():
    """fid + z · interval · lerp(0.1 -> 1e-15 over 20,000): exactly the
    port's linear_noise and the reference's copy, and the JAX package's
    float32 schedule within its rounding (near the end of the schedule,
    1 - i / 20000 in float32 is within an ulp of 1, not of itself)."""
    interval, fid = 1.0 / 120, 0.375
    gen = torch.Generator().manual_seed(11)
    for it in ITERATIONS:
        z = float(torch.randn((), generator=gen.clone_state()))
        t = baseline.ast_time(fid, it, gen, interval, False)
        noise = linear_noise(it, **JAX_AST)
        assert t == fid + z * interval * noise
        assert ref_ast.noise(it) == noise
        # JAX lerps in float32: each term rounds within an ulp of 0.1
        jax_noise = float(jax_linear_noise(it, **JAX_AST))
        assert abs(jax_noise - noise) <= 2 * 2.0 ** -23 * 0.1
        assert abs((t - fid) - z * interval * jax_noise) \
            <= abs(z) * interval * 2 * 2.0 ** -23 * 0.1 + 1e-18
    assert linear_noise(16000, **JAX_AST) == pytest.approx(0.02, rel=1e-12)
    # the reference's draws are the port's, in order
    gen = torch.Generator().manual_seed(SEED % 2 ** 63)
    fids = [0.1, 0.9, 0.5]
    assert ref_ast.jittered(fids, 16000, SEED, interval, False) == [
        baseline.ast_time(f, 16000 + i, gen, interval, False)
        for i, f in enumerate(fids)]


@pytest.mark.parametrize("is_blender, generator, iteration", [
    (True, torch.Generator().manual_seed(3), 16000),   # Blender scene
    (False, None, 10 ** 9),                            # evaluation
])
def test_time_is_fid_without_ast(is_blender, generator, iteration):
    fid = 0.3
    state = None if generator is None else generator.get_state()
    assert baseline.ast_time(fid, iteration, generator, 0.01,
                             is_blender) is fid
    if generator is not None:    # no draw taken
        assert torch.equal(generator.get_state(), state)


def _field(is_blender: bool):
    spec = DeformFieldSpec(kind="baseline", is_blender=is_blender, D=2, W=16)
    return create_deform_field(spec, seed=0, device="cpu")


@pytest.mark.parametrize("is_blender", [False, True])
def test_counter_and_span_record_the_time(is_blender):
    field = _field(is_blender)
    model = C.ModelParams(is_blender=is_blender)
    fn = baseline.make_deform_fn(field, model, 0.05)
    xyz = torch.zeros((4, 3))
    gen = torch.Generator().manual_seed(5)
    copy_gen = torch.Generator().manual_seed(5)
    want = [baseline.ast_time(0.5, it, copy_gen, 0.05, is_blender)
            for it in (100, 101, 102)] + [0.5]
    tracing.drain()
    tracing.enable()
    try:
        for it in (100, 101, 102):
            fn(xyz, 0.5, it, gen)
        fn(xyz, 0.5, 10 ** 9, None)          # an evaluation render
    finally:
        tracing.disable()
    spans, counts = tracing.drain()
    times = [s.attrs["t"] for s in sorted(spans, key=lambda s: s.start_ns)
             if s.name == "deform"]
    assert counts.get("deform.ast", 0) == (0 if is_blender else 3)
    assert times == want
    assert (times == [0.5] * 4) == is_blender


def _inline_deform_fn(field, model_cfg, time_interval):
    """The deform function `train_baseline` built inline before AST was
    made public, kept as the reference of its trajectory."""
    def deform_fn(xyz, fid, iteration, generator):
        t = fid
        if not model_cfg.is_blender and generator is not None:
            t = fid + float(torch.randn((), generator=generator)) \
                * time_interval * linear_noise(
                    iteration, lr_init=0.1, lr_final=1e-15,
                    lr_delay_mult=0.01, max_steps=20000)
        return field.step(xyz, t)
    return deform_fn


def _train(**kw):
    """A few baseline iterations on a non-Blender scene -> the losses."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.8, 0.8, (300, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (300, 3)).astype(np.float32)
    state = G.create_from_pcd(pts, cols, sh_degree=1, spatial_lr_scale=2.0,
                              device="cpu")
    cams = []
    for i in range(4):
        v = scene.look_at(scene.sphere_pose(i, 4, 4.0), i / 3, 40, 24, 0.72,
                          "cpu")
        img = torch.from_numpy(rng.uniform(0, 1, (24, 40, 3)).astype(
            np.float32))
        cams.append(Camera(viewmatrix=v.viewmatrix, projmatrix=v.projmatrix,
                           campos=v.campos, fid=v.fid, image=img,
                           width=40, height=24, fovx=v.fovx, fovy=v.fovy))
    model = C.ModelParams(is_blender=False, D=2, W=16, sh_degree=1)
    opt = C.OptimizationParams(iterations=10, warm_up=3, sequence_length=4,
                               densify_until_iter=0)
    out = baseline.train_baseline(
        gaussians=state, train_cams=cams, test_cams=[], cameras_extent=2.0,
        model_cfg=model, opt_cfg=opt, pipe_cfg=C.PipelineParams(), seed=9,
        log_every=1, progress=False, **kw)
    return [loss for _, loss in out.losses]


def test_train_baseline_trajectory_is_unchanged(monkeypatch):
    tracing.drain()
    losses = _train()
    assert tracing.drain()[1].get("deform.ast", 0) == 10 - 3 + 1
    monkeypatch.setattr(baseline, "make_deform_fn", _inline_deform_fn)
    assert losses == _train()


def test_new_harness_modules_load_no_jax():
    """The cell's loop and calibration load no JAX; the reference's AST
    loads nothing of the program either."""
    from benchmark.tests.test_bench_imports import tops_after_import
    banned = {"jax", "jaxlib", "flax", "d3gs_tpu"}
    tops = tops_after_import(["benchmark.loops.train_real",
                              "benchmark.calibrate_real"])
    assert "d3gs_tpu_torch" in tops and not tops & banned, tops
    tops = tops_after_import(["benchmark.reference.ast"])
    assert not tops & (banned | {"d3gs_tpu_torch"}), tops
