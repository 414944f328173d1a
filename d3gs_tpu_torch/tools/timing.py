"""Timing for the port's dev tools: CUDA events on the card, the host clock
on the CPU, each labelled with what it measured."""
from __future__ import annotations

import time

import torch


def clock(device: torch.device) -> str:
    """What `time_ms` reads on `device`."""
    if device.type == "cuda":
        return f"CUDA events on {torch.cuda.get_device_name(device)}"
    return "host clock (CPU run; not a device time)"


def time_ms(fn, device: torch.device, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() over `reps` calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps
