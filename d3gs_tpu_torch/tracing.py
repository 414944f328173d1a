"""Spans and counters of the port: where a train step or a viewer frame
spends its host time, on the clock a `torch.profiler` trace uses, and what
the program counts as it runs.

    from d3gs_tpu_torch import tracing
    tracing.enable()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as p:
        ...                                   # train steps, viewer frames
    tracing.disable()
    spans, counters = tracing.drain()
    p.export_chrome_trace(path)

Spans. `with span(name, **attrs):` records a `Span`: its name, start and
end, its parent (the innermost span open on the same thread; on a thread
with none open, such as autograd's device threads during a backward, the
innermost span open on the thread of the current root) and its root (the
outermost span above it: a `train.step` or the caller's `frame`), so every
span of one step or frame shares the root's id. `mark(name)` opens a span
under the enclosing one that the enclosing span's end closes: a hook in
the middle of a backward can start a phase that runs to the backward's
end. Spans are off until `enable()`; while off, `span` and `host_read`
hand back one shared object that does nothing, after one flag test.

Counters. `count(name, n)` adds to a host integer, whether or not spans
are on. The program counts what it decides on the host: dynamics
evaluations, solver steps, reads of device values, bytes a collective
moves. `counters()` is a snapshot, `drain()` hands over both spans and
counters and clears them.

The clock is `time.time_ns()`, the Unix epoch's. A Chrome trace exported
by `torch.profiler` carries `baseTimeNanoseconds`, and its event at `ts`
microseconds lies at ts * 1e3 + baseTimeNanoseconds on the same clock, so
the two join without an anchor. A span's `thread` is the system's id of
the thread that opened it, which the trace's CPU-side events carry, and
its `ident` that thread's `pthread_self()`: the CUDA runtime's events
carry its low 32 bits, read as a signed int and made positive. Nothing
here touches the device: no CUDA event, no
synchronize, no read of a tensor. A span's device time comes from the
profiler's trace, joined with the spans afterwards.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    root: int
    thread: int                   # threading.get_native_id() of its opener
    ident: int                    # and its threading.get_ident()
    attrs: dict


_enabled = False
_spans: list[Span] = []
_counters: dict[str, int] = {}
_count_lock = threading.Lock()
_ids = itertools.count(1)
_stacks: dict[int, list] = {}     # thread -> its open spans, innermost last
_root_thread: int | None = None   # the thread of the open root span


class _Open:
    """An open span; the context manager `span` returns."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "thread", "ident",
                 "start", "marks")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _root_thread
        tid = threading.get_native_id()
        stack = _stacks.setdefault(tid, [])
        outer = _enclosing(stack)
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        self.root = outer.root if outer else self.id
        if outer is None:
            _root_thread = tid
        self.thread, self.ident = tid, threading.get_ident()
        self.marks = []
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _root_thread
        end = time.time_ns()
        _stacks[self.thread].remove(self)
        for m in self.marks:
            _spans.append(Span(m.name, m.start, end, m.id, self.id,
                               self.root, m.thread, m.ident, m.attrs))
        _spans.append(Span(self.name, self.start, end, self.id, self.parent,
                           self.root, self.thread, self.ident, self.attrs))
        if self.parent is None and _root_thread == self.thread:
            _root_thread = None
        return False

    def mark(self, name: str, **attrs) -> None:
        """Open `name` under this span, closed at this span's end; once."""
        if any(m.name == name for m in self.marks):
            return
        m = _Open(name, attrs)
        m.id, m.thread = next(_ids), threading.get_native_id()
        m.ident = threading.get_ident()
        m.start = time.time_ns()
        self.marks.append(m)


class _Off:
    """What `span` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def mark(self, name: str, **attrs) -> None:
        pass


_OFF = _Off()


def _enclosing(stack: list):
    """The innermost open span on this thread, else on the root's."""
    if stack:
        return stack[-1]
    if _root_thread is not None:
        root_stack = _stacks.get(_root_thread)
        if root_stack:
            return root_stack[-1]
    return None


def span(name: str, **attrs):
    """A context manager recording the span `name` while spans are on."""
    if not _enabled:
        return _OFF
    return _Open(name, attrs)


def mark(name: str, **attrs) -> None:
    """Open `name` under the enclosing span (this thread's innermost, else
    the root thread's), to end where that span ends; nothing while spans
    are off or outside every span."""
    if not _enabled:
        return
    outer = _enclosing(_stacks.get(threading.get_native_id(), []))
    if outer is not None:
        outer.mark(name, **attrs)


def count(name: str, n: int = 1) -> None:
    """Add n to the host counter `name`."""
    with _count_lock:
        _counters[name] = _counters.get(name, 0) + n


def host_read(site: str):
    """Count a read of a device value at `site` (`host_reads.<site>`) and
    return the span `host_read` to hold it: the read waits for the device
    to finish the work queued before it."""
    count("host_reads." + site)
    if not _enabled:
        return _OFF
    return _Open("host_read", {"site": site})


def counters() -> dict[str, int]:
    """A snapshot of the counters."""
    with _count_lock:
        return dict(_counters)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def drain() -> tuple[list[Span], dict[str, int]]:
    """-> (the finished spans, the counters), clearing both. Spans still
    open are recorded when they end."""
    global _spans
    with _count_lock:
        out, _spans = _spans, []
        counts = dict(_counters)
        _counters.clear()
    return out, counts
