"""The traced sub-window: `torch.profiler` over the last steps of a
`--trace 1` run, reduced to what the per-layer metrics read.

The profiler records the device's activity only (kernels, copies and
memsets, and the CUDA runtime calls that launched or waited for them), not
PyTorch's CPU operators: recording those made the host ~3x slower in the
training cell's traced steps, and the device's idle share read 84 %
against ~53 % untraced. The trace is written as a Chrome trace into the
run's TMPDIR, read back and deleted. The sub-window starts after a
synchronize and ends with one, so every device operation of its steps lies
inside it: it spans from the first runtime call to the end of the closing
synchronize, which the sync count leaves out.
"""
from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def profiled(body):
    """Run body(step) under the profiler (step(fn) calls fn); -> (what
    body returned, the Chrome trace's complete events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = body(lambda fn: fn())
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, [e for e in events if e.get("ph") == "X" and "dur" in e]


def _span(e):
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list) -> dict:
    """busy_s, window_s, launches, syncs, per-kernel durations (in launch
    order) and the breakdown of the traced sub-window."""
    runtime = sorted((e for e in events if e.get("cat") == "cuda_runtime"),
                     key=lambda e: float(e["ts"]))
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not runtime or not dev:
        raise RuntimeError("the profiler's trace holds no runtime calls or "
                           "no device operations")
    closing = max(runtime, key=lambda e: _span(e)[1])
    w0, w1 = float(runtime[0]["ts"]), _span(closing)[1]
    busy = _merge([(max(a, w0), min(b, w1)) for a, b in map(_span, dev)
                   if b > w0 and a < w1])
    kernels = sorted((e for e in dev if e["cat"] == "kernel"),
                     key=lambda e: float(e["ts"]))
    syncs = sum(1 for e in runtime if e.get("name") in SYNC_CALLS
                and e is not closing)
    durs = defaultdict(list)
    for e in kernels:
        durs[e["name"]].append(float(e["dur"]) * 1e-6)
    top = sorted(((n, sum(d)) for n, d in durs.items()),
                 key=lambda x: -x[1])[:10]
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "launches": len(kernels),
        "syncs": syncs,
        "kernel_s": dict(durs),
        "breakdown": {"device_ops": [[n[:160], s] for n, s in top],
                      "idle_gaps": _idle_gaps(runtime, busy, w0, w1)},
    }


def _idle_gaps(runtime, busy, w0, w1):
    """The device's idle time in the window, summed by the CUDA runtime
    call the host was in at each gap's midpoint (the shortest, where calls
    nest), "host, between runtime calls" where it was in none (Python and
    PyTorch's dispatch): the ten largest."""
    calls = sorted((*_span(e), e["name"]) for e in runtime)
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    total = defaultdict(float)
    active, i = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(calls) and calls[i][0] <= mid:
            s0, s1, name = calls[i]
            heapq.heappush(active, (s1 - s0, s1, name))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        label = active[0][2] if active else "host, between runtime calls"
        total[label[:160]] += (b - a) * 1e-6
    return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:10]]
