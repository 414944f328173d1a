"""`benchmark/spans.py` on a synthetic Chrome trace: device operations
charged by correlation to the innermost span (on the launching thread,
else the roots' thread), operations without a launch record counted,
idle time put on span paths, host waits put on their span, threads named
as the trace names them, and `trace.reduce` reading the same numbers
whether or not spans are joined."""
import copy

import pytest

from benchmark import spans as S
from benchmark import trace
from d3gs_tpu_torch.tracing import Span

MAIN, AUTOGRAD = 10, 20
# each thread's pthread_self(); the runtime's events carry its low 32 bits
# read as a signed int, made positive (AUTOGRAD's are over 2**31)
IDENT = {MAIN: 0x7F5B126AE300, AUTOGRAD: 0x7F5A879FF6C0}
TID = {MAIN: 0x126AE300, AUTOGRAD: 0x78600940}


def _span(name, a, b, sid, parent, thread=MAIN, **attrs):
    """A span over [a, b] us of the trace's clock (base 0)."""
    return Span(name, int(a * 1e3), int(b * 1e3), sid, parent, 1, thread,
                IDENT[thread], attrs)


SPANS = [
    _span("train.step", 0, 100, 1, None, cameras=2),
    _span("render", 5, 30, 2, 1),
    _span("render.bin", 10, 25, 3, 2),
    _span("host_read", 15, 22, 4, 3, site="binning"),
    _span("backward", 40, 90, 5, 1),
    _span("blend.bwd", 45, 55, 6, 5, thread=AUTOGRAD),
    _span("backward.deform", 60, 90, 7, 5, thread=AUTOGRAD),
    _span("adam", 92, 99, 8, 1),
]


def _call(name, ts, dur, tid, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": dur, "tid": TID[tid], "args": {"correlation": corr}}


def _kernel(ts, dur, corr, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "tid": "stream 7", "args": {"correlation": corr}}


EVENTS = [
    _call("cudaLaunchKernel", 6, 1, MAIN, 1), _kernel(7, 5, 1),
    _call("cudaLaunchKernel", 11, 1, MAIN, 2), _kernel(12, 3, 2),
    _call("cudaStreamSynchronize", 16, 5, MAIN, 3),
    # the backward's launches, on autograd's thread: before blend.bwd
    # (no span of that thread: the roots' thread's innermost), inside
    # blend.bwd and inside the mark
    _call("cudaLaunchKernel", 41, 1, AUTOGRAD, 4), _kernel(42, 2, 4),
    _call("cudaLaunchKernel", 46, 1, AUTOGRAD, 5), _kernel(47, 4, 5),
    _call("cudaLaunchKernel", 61, 1, AUTOGRAD, 6), _kernel(62, 20, 6),
    _call("cudaLaunchKernel", 93, 1, MAIN, 7), _kernel(94, 2, 7),
    _kernel(96, 1, 99),                       # no launch record
    _call("cudaDeviceSynchronize", 99, 3, MAIN, 100),
]


@pytest.fixture(scope="module")
def joined():
    return S.join(SPANS, copy.deepcopy(EVENTS), 0)


def test_operations_are_charged_to_the_innermost_span(joined):
    us = {k: round(v * 1e6, 6) for k, v in joined["device_s"].items()}
    assert us == {"train.step": 36.0, "render": 8.0, "render.bin": 3.0,
                  "host_read": 0.0, "backward": 26.0, "blend.bwd": 4.0,
                  "backward.deform": 20.0, "adam": 2.0}
    self_us = {k: round(v * 1e6, 6) for k, v in joined["self_s"].items()}
    assert self_us == {"render": 5.0, "render.bin": 3.0, "backward": 2.0,
                       "blend.bwd": 4.0, "backward.deform": 20.0,
                       "adam": 2.0}
    assert joined["outside_spans_s"] == 0.0


def test_operations_without_a_launch_are_counted(joined):
    assert joined["unlaunched"]["ops"] == 1
    assert round(joined["unlaunched"]["s"] * 1e6, 6) == 1.0
    total = sum(joined["self_s"].values()) + joined["unlaunched"]["s"]
    assert round(total * 1e6, 6) == round(joined["device_total_s"] * 1e6, 6)


def test_idle_time_is_put_on_span_paths(joined):
    idle = {n: round(s * 1e6, 6) for n, s in joined["idle_by_span"].items()}
    assert idle == {
        "train.step/render": 28.0,
        "train.step/backward/blend.bwd": 3.0,
        "train.step/backward": 11.0,
        "train.step/backward/backward.deform": 12.0,
        "train.step": 5.0,
    }
    assert round(joined["idle_s"]["render"] * 1e6, 6) == 16.0
    assert round(joined["idle_s"]["backward.deform"] * 1e6, 6) == 10.0


def test_host_waits_are_put_on_their_span(joined):
    assert joined["syncs"] == {
        "train.step/render/render.bin/host_read": 1}
    assert joined["host_reads_without_sync"] == 0


@pytest.mark.parametrize("ident, tid", [
    (0x7F5B126AE300, 0x126AE300), (0x7F5A879FF6C0, 0x78600940),
    (0x80000000, 0x80000000), (0xFFFFFFFF, 1), (0x1234, 0x1234)])
def test_trace_tid_names_a_thread_as_the_trace_does(ident, tid):
    assert S.trace_tid(ident) == tid


def test_reduce_reads_the_same_with_and_without_spans(joined):
    """`trace.reduce` reads the events alone; the join leaves them as
    they were, and its idle time is reduce's window less busy time."""
    events = copy.deepcopy(EVENTS)
    before = trace.reduce(copy.deepcopy(EVENTS))
    j = S.join(SPANS, events, 0)
    assert trace.reduce(events) == before
    assert events == EVENTS
    idle = sum(j["idle_by_span"].values())
    assert abs(idle - (before["window_s"] - before["busy_s"])) < 1e-12
    assert before["syncs"] == sum(j["syncs"].values())


def test_without_spans_everything_is_outside():
    j = S.join([], copy.deepcopy(EVENTS), 0)
    assert dict(j["device_s"]) == {}
    assert round(j["outside_spans_s"] * 1e6, 6) == 36.0
    assert j["syncs"] == {"outside spans": 1}
    assert list(j["idle_by_span"]) == [S.OUTSIDE]


def test_readings_per_view(joined):
    r = S.readings(joined, {"ode.evals.forward": 36,
                            "ode.evals.recompute": 36,
                            "ode.evals.nograd": 100}, SPANS)
    assert r["views"] == 2
    assert r["render_fwd_ms.train"] == pytest.approx(8e-3 / 2)
    assert r["render_bwd_ms.train"] == pytest.approx(6e-3 / 2)
    assert r["deform_bwd_ms.train"] == pytest.approx(20e-3 / 2)
    assert r["adam_ms.train"] == pytest.approx(2e-3 / 2)
    assert r["render_idle_ms.train"] == pytest.approx(16e-3 / 2)
    assert r["ode_evals_per_view.train"] == 36.0
    assert r["phases_share_of_steps_pct"] == pytest.approx(100.0)


def test_the_join_loads_no_jax():
    from benchmark.tests.test_bench_imports import tops_after_import
    tops = tops_after_import(["benchmark.spans", "d3gs_tpu_torch.tracing"])
    assert not tops & {"jax", "jaxlib", "flax", "d3gs_tpu"}, tops
