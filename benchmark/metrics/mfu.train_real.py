"""Share of the f32 peak (67 TFLOP/s) the real-scene training steps
reach: the model FLOPs of `benchmark/counts.py::train_step_flops` of a
view (the field's three forwards of the 8x256 MLP with PE(t, 10) and no
time net, SH, projection, losses, the last traced view's pairs, both
Adams), times the views of the traced run's steps before the profiled
sub-window, over their time (host clock)."""
from benchmark.counts import F32_PEAK_FLOPS


def read(r):
    if "flops_per_view" not in r:
        return None
    return 100.0 * r["flops_per_view"] * r["window_views"] / (
        r["window_s"] * F32_PEAK_FLOPS)
