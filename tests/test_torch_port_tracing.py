"""The port's spans and counters (`d3gs_tpu_torch/tracing.py`) on the CPU:
the facility alone, its clock against a `torch.profiler` trace, the span
tree of the flagship ODE step and the baseline MLP step at a tiny size,
the RK4 evaluation counters, and steps that compute the same bits with
spans on and off."""
from __future__ import annotations

import json
import math
import threading

import numpy as np
import pytest
import torch

from d3gs_tpu_torch import config as C
from d3gs_tpu_torch import tracing
from d3gs_tpu_torch.data.cameras import camera_from_matrices
from d3gs_tpu_torch.models import gaussians as G
from d3gs_tpu_torch.models.deform.fields import (DeformFieldSpec,
                                                 create_deform_field)
from d3gs_tpu_torch.models.deform.ode import odeint_from_zero, odeint_grid
from d3gs_tpu_torch.ops.camera_math import world_to_view
from d3gs_tpu_torch.train.flagship import make_batched_step, pick_field_spec
from d3gs_tpu_torch.train.step import make_train_step
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

SUBSTEPS = DeformFieldSpec().n_substeps


@pytest.fixture(autouse=True)
def clean():
    """Each test starts with spans off and nothing recorded, and leaves
    the facility so."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


# ---------------------------------------------------------------- facility

@pytest.mark.parametrize("make", [
    lambda: tracing.span("a", x=1),
    lambda: tracing.host_read("site"),
], ids=["span", "host_read"])
def test_off_hands_back_the_shared_no_op(make):
    first, second = make(), make()
    assert first is second
    with first as s:
        s.mark("m")
        tracing.mark("m")
    spans, _ = tracing.drain()
    assert spans == []


def test_counters_count_with_spans_off_and_drain_clears():
    tracing.count("a")
    tracing.count("a", 4)
    with tracing.host_read("site"):
        pass
    assert tracing.counters() == {"a": 5, "host_reads.site": 1}
    spans, counts = tracing.drain()
    assert spans == [] and counts == {"a": 5, "host_reads.site": 1}
    assert tracing.counters() == {}


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nesting_parents_threads_and_roots():
    """Parents are the innermost open span of the thread; a thread with
    none open hangs under the root thread's innermost; marks close with
    their enclosing span; every span of a root shares its id."""
    tracing.enable()
    seen = {}

    def worker(parent_open: threading.Event, done: threading.Event):
        parent_open.wait(10)
        with tracing.span("worker"):
            with tracing.span("worker.inner"):
                tracing.mark("late")
        seen["tid"] = threading.get_native_id()
        done.set()

    with tracing.span("root", i=7) as root:
        with tracing.span("child"):
            opened, done = threading.Event(), threading.Event()
            t = threading.Thread(target=worker, args=(opened, done))
            t.start()
            opened.set()
            assert done.wait(10)
            t.join(10)
            assert not t.is_alive()
        root.mark("tail")
    with tracing.span("second"):
        pass
    spans, _ = tracing.drain()
    by = _by_name(spans)
    (r,), (c,), (w,), (wi,), (late,), (tail,), (sec,) = (
        by[n] for n in ("root", "child", "worker", "worker.inner", "late",
                        "tail", "second"))
    main = threading.get_native_id()
    assert r.parent is None and r.root == r.id and r.attrs == {"i": 7}
    assert c.parent == r.id and c.thread == main
    assert c.ident == threading.get_ident() != w.ident
    assert w.parent == c.id and w.thread == seen["tid"] != main
    assert wi.parent == w.id and wi.thread == seen["tid"]
    assert late.parent == wi.id and late.end_ns == wi.end_ns
    assert late.thread == seen["tid"]
    assert tail.parent == r.id and tail.end_ns == r.end_ns
    assert {s.root for s in (r, c, w, wi, late, tail)} == {r.id}
    assert sec.parent is None and sec.root == sec.id != r.id
    for s in spans:
        assert s.start_ns <= s.end_ns
    for a, b in ((r, c), (c, w), (w, wi), (wi, late), (r, tail)):
        assert a.start_ns <= b.start_ns and b.end_ns <= a.end_ns


def test_a_mark_opens_once_per_enclosing_span():
    tracing.enable()
    with tracing.span("root") as root:
        root.mark("m")
        tracing.mark("m")
    spans, _ = tracing.drain()
    assert [s.name for s in spans].count("m") == 1


def test_spans_share_the_profilers_clock(tmp_path):
    """A span around a `record_function` contains it on the exported
    Chrome trace's clock: ts (us) * 1e3 + baseTimeNanoseconds."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with record_function("probe"):
                torch.ones(64).sum()
    (outer,), _ = tracing.drain()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    (probe,) = [e for e in trace["traceEvents"]
                if e.get("name") == "probe" and e.get("ph") == "X"]
    start_us = (outer.start_ns - base) / 1e3
    end_us = (outer.end_ns - base) / 1e3
    assert start_us <= float(probe["ts"])
    assert float(probe["ts"]) + float(probe["dur"]) <= end_us
    assert int(probe["tid"]) == outer.thread


# ------------------------------------------------------------ train steps

K = 3


def _scene(seed: int = 0, n: int = 96, size: int = 32):
    """A tiny scene: n Gaussians in [-1, 1]^3, K cameras 3 units away at
    times i / (K - 1), random target images."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)) * 2.0 - 1.0).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    state = G.create_from_pcd(pts, cols, sh_degree=1, capacity=128,
                              spatial_lr_scale=1.0, device="cpu")
    fov = math.radians(50)
    cams = [camera_from_matrices(
        world_to_view(np.eye(3), np.array([0.1 * i, -0.1 * i, 3.0])).T, fov,
        fov, fid=i / (K - 1),
        image=rng.random((size, size, 3)).astype(np.float32), device="cpu")
        for i in range(K)]
    return state, cams


def _flagship():
    """-> (step(), field): the flagship's ODE step over K cameras."""
    model = C.ModelParams(is_ode=True, D=2, W=16, multires=2)
    opt = C.OptimizationParams(num_cams_per_iter=K)
    field = create_deform_field(pick_field_spec(model, opt), seed=0,
                                device="cpu", opt_cfg=opt)
    step = make_batched_step(opt_cfg=opt, pipe_cfg=C.PipelineParams(),
                             model_cfg=model, field=field,
                             update_gaussians=True, update_deform=True,
                             use_deform=True)
    state, cams = _scene()
    ds0 = field.init_state()
    return (lambda: step(state, ds0, cams, 16_000, torch.zeros(3))), field


def _baseline():
    """-> (step(), field): the baseline trainer's MLP step on one camera."""
    field = create_deform_field(DeformFieldSpec(kind="baseline", D=2, W=16,
                                                multires=2), seed=0,
                                device="cpu")
    step = make_train_step(
        opt_cfg=C.OptimizationParams(), pipe_cfg=C.PipelineParams(),
        deform_fn=lambda xyz, fid, it, gen: field.step(xyz, fid),
        deform_params=list(field.net.parameters()),
        deform_update_fn=field.update)
    state, cams = _scene()
    ds0 = field.init_state()
    return (lambda: step(state, ds0, cams[1], 16_000, None,
                         torch.zeros(3))), field


TRAINERS = {"flagship_ode": (_flagship, K), "baseline_mlp": (_baseline, 1)}


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_train_step_span_tree(trainer):
    build, k = TRAINERS[trainer]
    step, _ = build()
    tracing.enable()
    step()
    spans, counts = tracing.drain()
    by = _by_name(spans)
    (root,) = by["train.step"]
    assert root.parent is None and root.attrs["cameras"] == k
    assert {s.root for s in spans} == {root.id}

    def children(parent, name):
        return [s for s in by.get(name, []) if s.parent == parent.id]

    assert len(children(root, "deform")) == 1
    renders = children(root, "render")
    assert len(renders) == k and len(children(root, "loss")) == k
    for r in renders:
        for part in ("render.project", "render.bin", "render.blend"):
            assert len(children(r, part)) == 1, part
        (b,) = children(r, "render.bin")
        (read,) = children(b, "host_read")
        assert read.attrs == {"site": "binning"}
    assert counts["host_reads.binning"] == k
    assert counts["render.calls"] == k
    (bw,) = children(root, "backward")
    (deform_bw,) = children(bw, "backward.deform")
    assert deform_bw.end_ns == bw.end_ns
    blend_bw = children(bw, "blend.bwd")
    assert len(blend_bw) == k
    assert all(b.end_ns <= deform_bw.start_ns for b in blend_bw)
    (adam,) = children(root, "adam")
    assert len(children(adam, "adam.gaussians")) == 1
    assert len(children(adam, "adam.deform")) == 1
    order = sorted(children(root, n)[0].start_ns
                   for n in ("render", "backward", "adam"))
    assert order == [children(root, "render")[0].start_ns, bw.start_ns,
                     adam.start_ns]


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_spans_on_compute_the_same_bits(trainer):
    """State, field, deform moments and StepAux are bitwise equal with
    spans on and off (the backward hook reads nothing and changes
    nothing)."""
    build = TRAINERS[trainer][0]
    out = []
    for on in (False, True):
        step, field = build()
        if on:
            tracing.enable()
        state, ds, aux = step()
        tracing.disable()
        out.append([*state.params, *state.opt.m, *state.opt.v,
                    state.grad_accum, state.denom, state.max_radii2d,
                    *field.net.parameters(), *ds.m, *ds.v, *aux])
    spans, _ = tracing.drain()
    assert spans
    for a, b in zip(*out):
        assert torch.equal(a, b)


# -------------------------------------------------------------- counters

@pytest.mark.parametrize("times", [[0.1, 0.5], [0.0, 0.25, 0.25, 0.5, 0.9],
                                   [0.3, 0.3]])
def test_rk4_counts_forward_and_recompute(times):
    """4 evaluations a substep, SUBSTEPS substeps a non-empty segment,
    once forward and once more when the backward recomputes each
    checkpointed substep; an integral without autograd counts apart."""
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                              torch.nn.Linear(8, 3))

    def f(t, y):
        return net(torch.cat([y, torch.full_like(y[:, :1], float(t))], 1))

    y0 = torch.randn(5, 3, generator=torch.Generator().manual_seed(1))
    segments = sum(a != b for a, b in zip(times[:-1], times[1:]))
    ys = odeint_grid(f, y0, times, n_substeps=SUBSTEPS)
    assert tracing.counters().get("ode.evals.forward", 0) == \
        4 * SUBSTEPS * segments
    assert "ode.evals.recompute" not in tracing.counters()
    if segments:
        ys.square().sum().backward()
    _, counts = tracing.drain()
    assert counts.get("ode.evals.recompute", 0) == 4 * SUBSTEPS * segments
    assert "ode.evals.nograd" not in counts
    with torch.no_grad():
        odeint_from_zero(f, y0, times[-1], n_substeps=2 * SUBSTEPS)
    counts = tracing.counters()
    assert counts.get("ode.evals.nograd", 0) == \
        4 * 2 * SUBSTEPS * (times[-1] != 0)
    assert "ode.evals.forward" not in counts
    assert "ode.evals.recompute" not in counts


def test_flagship_step_counts_its_evaluations():
    """The flagship's step integrates one trajectory through its K sorted
    times and recomputes it in the backward."""
    step, _ = _flagship()
    step()
    _, counts = tracing.drain()
    evals = 4 * SUBSTEPS * (K - 1)
    assert counts["ode.evals.forward"] == evals
    assert counts["ode.evals.recompute"] == evals
