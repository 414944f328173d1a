"""Milliseconds of device time a view in the deformation field, forward
and backward: the spans `deform` and `backward.deform` of the traced
sub-window's steps (`d3gs_tpu_torch/tracing.py`), joined with the
profiler's trace by `benchmark/spans.py` (`deform_fwd_ms.train` +
`deform_bwd_ms.train` of its `readings`). `backward.deform` starts where
autograd has the whole gradient of d_xyz, so backward work on d_rotation
and d_scaling after that point counts here. None without spans."""


def read(r):
    s = r.get("span_readings")
    if not s:
        return None
    return s["deform_fwd_ms.train"] + s["deform_bwd_ms.train"]
