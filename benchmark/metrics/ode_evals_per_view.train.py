"""Evaluations of the ODE's dynamics net per view trained, in the forward
integral and in the backward's recompute: the program's counters
`ode.evals.forward` and `ode.evals.recompute` (`d3gs_tpu_torch.tracing`)
over every training step of the run, over the views those steps rendered
(`render.calls`). Integrals run without autograd (`ode.evals.nograd`,
such as the harness's replay after the window) are not counted. None for a
program without the counters."""


def read(r):
    if "window_views" not in r:
        return None
    try:
        from d3gs_tpu_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    views = c.get("render.calls", 0)
    evals = c.get("ode.evals.forward", 0) + c.get("ode.evals.recompute", 0)
    return evals / views if views else None
