"""Mean milliseconds of the render in a frame (SH, projection, binning,
the forward blend): CUDA events around the view loop's own `render(...)`
call, in the traced run's frames before the profiled sub-window."""


def read(r):
    d = r.get("render_ms")
    return sum(d) / len(d) if d else None
