"""Mean milliseconds of the field's step in a frame (the integral from 0
to t for the ODE field): CUDA events the view loop records around its own
`field.step(xyz, t)` call, in the traced run's frames before the profiled
sub-window. The events see the stream, so time the device waited for the
host's launches counts."""


def read(r):
    d = r.get("deform_ms")
    return sum(d) / len(d) if d else None
