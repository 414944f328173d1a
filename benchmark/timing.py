"""CUDA-event timing of back-to-back calls: a copy of the port's
`d3gs_tpu_torch/tools/timing.py::time_ms`, card only (it never falls back
to a host clock)."""
from __future__ import annotations

import torch


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() over `reps` back-to-back calls after
    `warmup` calls, between two CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
