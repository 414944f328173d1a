"""Share of the f32 peak (67 TFLOP/s) the viewer's frames reach: the
FLOPs of `benchmark/counts.py::view_flops` of the last traced frame,
times the frames before the profiled sub-window, over their time (host
clock)."""
from benchmark.counts import F32_PEAK_FLOPS


def read(r):
    if "flops_per_frame" not in r:
        return None
    return 100.0 * r["flops_per_frame"] * r["window_frames"] / (
        r["window_s"] * F32_PEAK_FLOPS)
