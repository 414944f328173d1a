"""Share of the f32 peak (67 TFLOP/s) the training steps reach: the
model FLOPs of `benchmark/counts.py::train_step_flops` per view, times the
views of the traced run's steps before the profiled sub-window, over their
time (host clock)."""
from benchmark.counts import F32_PEAK_FLOPS


def read(r):
    if "flops_per_view" not in r:
        return None
    return 100.0 * r["flops_per_view"] * r["window_views"] / (
        r["window_s"] * F32_PEAK_FLOPS)
