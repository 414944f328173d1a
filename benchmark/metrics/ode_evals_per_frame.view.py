"""Evaluations of the ODE's dynamics net per viewer frame (the integral
from 0 to the frame's time; none at t = 0): the program's counters of
forward integrals, `ode.evals.nograd` and `ode.evals.forward`
(`d3gs_tpu_torch.tracing`), over every frame of the run, over the frames
rendered (`render.calls`). None for a program without the counters."""


def read(r):
    if "window_frames" not in r:
        return None
    try:
        from d3gs_tpu_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    frames = c.get("render.calls", 0)
    evals = c.get("ode.evals.nograd", 0) + c.get("ode.evals.forward", 0)
    return evals / frames if frames else None
