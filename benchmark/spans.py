"""The program's spans joined with the profiler's trace: the device time,
idle time and host waits of each layer of a train step or a viewer frame.

    from d3gs_tpu_torch import tracing
    tracing.enable()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as p:
        ...                               # steps, each frame in span("frame")
    torch.cuda.synchronize()
    tracing.disable()
    spans, counts = tracing.drain()
    p.export_chrome_trace(path)           # its X events and baseTimeNanoseconds
    j = join(spans, events, base_ns)
    readings(j, counts, spans)

`join`, on the trace's clock (a span at ns lies at (ns - base_ns) / 1e3 us):

  * a device operation (kernel, copy, memset) is charged to the innermost
    span that held its launching runtime call, linked by the events'
    `args.correlation`: a span on the launching thread first (autograd's
    device thread runs the backward), else the innermost span of the
    roots' thread at that time. Operations whose launch is not in the
    trace are counted, not dropped;
  * a span's device time is what is charged to it and to the spans under
    it; its self time what is charged to it alone;
  * the device's idle time is summed over each span name's intervals
    (`idle_s`), and by the path of the deepest span the host was in at
    each idle stretch's midpoint (`idle_by_span`);
  * each synchronizing runtime call is put on the innermost span that
    held it.

The trace names a runtime call's thread as the CUDA runtime does: the low
32 bits of its `pthread_self()` read as a signed int, made positive
(`trace_tid`). `trace.reduce` reads the same events and is not changed by
the join.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from . import trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside spans"


def trace_tid(ident: int) -> int:
    """The thread id a Chrome trace gives the runtime calls of the thread
    whose `threading.get_ident()` is `ident`."""
    low = ident & 0xFFFFFFFF
    return abs(low - (1 << 32) if low >= 1 << 31 else low)


class _Tree:
    """The spans on the trace's clock (us), with their paths and, per
    runtime thread id, the innermost span over each stretch of time."""

    def __init__(self, spans, base_ns: int):
        self.spans = {s.id: s for s in spans}
        self.t = {s.id: ((s.start_ns - base_ns) / 1e3,
                         (s.end_ns - base_ns) / 1e3) for s in spans}
        self.depth, self.path = {}, {}
        for s in spans:
            chain = [self.spans[a].name for a in self.ancestors(s.id)]
            self.depth[s.id] = len(chain)
            self.path[s.id] = "/".join(reversed(chain))
        by_thread = defaultdict(list)
        for s in spans:
            by_thread[trace_tid(s.ident)].append(s.id)
        self.main = next((trace_tid(s.ident) for s in spans
                          if s.parent is None), None)
        self.segments = {tid: self._segments(ids)
                         for tid, ids in by_thread.items()}

    def _segments(self, ids):
        """(starts, innermost span id or None) of the thread's stretches."""
        bounds = sorted({x for i in ids for x in self.t[i]})
        starts, owner = [], []
        for a, b in zip(bounds[:-1], bounds[1:]):
            mid = 0.5 * (a + b)
            live = [i for i in ids if self.t[i][0] <= mid < self.t[i][1]]
            starts.append(a)
            owner.append(max(live, key=lambda i: (self.depth[i],
                                                  self.t[i][0]))
                         if live else None)
        if bounds:
            starts.append(bounds[-1])
            owner.append(None)
        return starts, owner

    def _on(self, tid, t):
        starts, owner = self.segments.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        return owner[i] if i >= 0 else None

    def at(self, tid, t):
        """The innermost span holding the runtime's thread `tid` at t,
        else the roots' thread's; None outside every span."""
        sid = self._on(tid, t)
        if sid is None and tid != self.main:
            sid = self._on(self.main, t)
        return sid

    def deepest(self, t):
        """The deepest span open at t on any thread."""
        found = [s for s in (self._on(tid, t) for tid in self.segments)
                 if s is not None]
        return max(found, key=lambda i: (self.depth[i], self.t[i][0]),
                   default=None)

    def ancestors(self, sid):
        while sid is not None and sid in self.spans:
            yield sid
            sid = self.spans[sid].parent


def _gaps(dev, w0, w1):
    """Idle stretches of the device in [w0, w1] (us)."""
    gaps, at = [], w0
    for a, b in trace._merge([(max(a, w0), min(b, w1))
                              for a, b in map(trace._span, dev)
                              if b > w0 and a < w1]):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    return gaps


def _overlap(intervals, gaps) -> float:
    """Length (us) of the union of `intervals` inside the gaps."""
    return sum(max(0.0, min(b, g1) - max(a, g0))
               for a, b in trace._merge(intervals) for g0, g1 in gaps)


def _charge(tree: _Tree, events, dev):
    """-> (device s of each span id alone, s outside every span, [count,
    s] of operations with no launch in the trace)."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    own, outside, unlaunched = defaultdict(float), 0.0, [0, 0.0]
    for e in dev:
        d = float(e["dur"]) * 1e-6
        rt = launches.get(e.get("args", {}).get("correlation"))
        if rt is None:
            unlaunched[0] += 1
            unlaunched[1] += d
            continue
        sid = tree.at(rt.get("tid"), float(rt["ts"]))
        if sid is None:
            outside += d
        else:
            own[sid] += d
    return own, outside, unlaunched


def join(spans, events, base_ns: int) -> dict:
    """Device seconds, idle seconds and host waits of the spans (module
    docstring)."""
    tree = _Tree(spans, base_ns)
    runtime = sorted((e for e in events if e.get("cat") == "cuda_runtime"),
                     key=lambda e: float(e["ts"]))
    dev = [e for e in events if e.get("cat") in trace.DEVICE_CATS]
    own, outside, unlaunched = _charge(tree, events, dev)
    total = defaultdict(float)
    for sid, d in own.items():
        for a in tree.ancestors(sid):
            total[a] += d
    device, self_s = defaultdict(float), defaultdict(float)
    for sid, s in tree.spans.items():
        if not any(tree.spans[a].name == s.name
                   for a in tree.ancestors(s.parent)):
            device[s.name] += total[sid]
    for sid, d in own.items():
        self_s[tree.spans[sid].name] += d

    closing = max(runtime, key=lambda e: trace._span(e)[1])
    gaps = _gaps(dev, float(runtime[0]["ts"]), trace._span(closing)[1])
    intervals = defaultdict(list)
    for sid, s in tree.spans.items():
        intervals[s.name].append(tree.t[sid])
    idle_by_span = defaultdict(float)
    for a, b in gaps:
        sid = tree.deepest(0.5 * (a + b))
        idle_by_span[OUTSIDE if sid is None else tree.path[sid]] += \
            (b - a) * 1e-6

    syncs = [e for e in runtime if e.get("name") in trace.SYNC_CALLS
             and e is not closing]
    sync_at = defaultdict(int)
    for e in syncs:
        sid = tree.at(e.get("tid"), 0.5 * sum(trace._span(e)))
        sync_at[OUTSIDE if sid is None else tree.path[sid]] += 1
    reads_without = sum(
        1 for sid, s in tree.spans.items() if s.name == "host_read"
        and not any(tree.t[sid][0] <= trace._span(e)[0]
                    and trace._span(e)[1] <= tree.t[sid][1] for e in syncs))
    return {
        "device_s": dict(device), "self_s": dict(self_s),
        "idle_s": {n: _overlap(iv, gaps) * 1e-6
                   for n, iv in intervals.items()},
        "idle_by_span": dict(idle_by_span),
        "device_total_s": sum(float(e["dur"]) for e in dev) * 1e-6,
        "kernel_total_s": sum(float(e["dur"]) for e in dev
                              if e["cat"] == "kernel") * 1e-6,
        "outside_spans_s": outside,
        "unlaunched": {"ops": unlaunched[0], "s": unlaunched[1]},
        "syncs": dict(sync_at), "host_reads_without_sync": reads_without,
    }


def readings(j: dict, counts: dict, spans) -> dict:
    """The per-layer numbers a cell's traced run would report from the
    join and the counters' increments over it: per view (training, roots
    `train.step`) or per frame (any other root)."""
    roots = [s for s in spans if s.parent is None]
    d, idle = j["device_s"], j["idle_s"]
    if any(s.name == "train.step" for s in roots):
        views = sum(s.attrs.get("cameras", 0) for s in roots
                    if s.name == "train.step")
        ms = lambda name: 1e3 * d.get(name, 0.0) / views  # noqa: E731
        out = {"views": views,
               "deform_fwd_ms.train": ms("deform"),
               "deform_bwd_ms.train": ms("backward.deform"),
               "render_fwd_ms.train": ms("render"),
               "render_bwd_ms.train": ms("backward") - ms("backward.deform"),
               "adam_ms.train": ms("adam"),
               "loss_ms.train": ms("loss"),
               "render_idle_ms.train": 1e3 * idle.get("render", 0.0) / views,
               "ode_evals_per_view.train": (
                   counts.get("ode.evals.forward", 0)
                   + counts.get("ode.evals.recompute", 0)) / views}
        covered = sum(d.get(n, 0.0) for n in ("deform", "render", "adam",
                                              "backward"))
    else:
        views = len(roots)
        out = {"frames": views,
               "deform_ms.view.spans": 1e3 * d.get("deform", 0.0) / views,
               "render_ms.view.spans": 1e3 * d.get("render", 0.0) / views,
               "render_idle_ms.view": 1e3 * idle.get("render", 0.0) / views,
               "ode_evals_per_frame.view": (
                   counts.get("ode.evals.nograd", 0)
                   + counts.get("ode.evals.forward", 0)) / views}
        covered = d.get("deform", 0.0) + d.get("render", 0.0)
    in_roots = sum(d.get(s, 0.0) for s in {r.name for r in roots})
    out["phases_share_of_steps_pct"] = 100.0 * covered / in_roots \
        if in_roots else None
    out["steps_share_of_device_pct"] = 100.0 * in_roots / \
        j["device_total_s"] if j["device_total_s"] else None
    return out
