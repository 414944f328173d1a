"""Share of the training steps' dynamics evaluations that ran in the fused
RK4 kernel (`d3gs_tpu_torch/ops/ode_rk4.py`), in %: the program's fused
evaluations under autograd over its forward and recompute evaluations,
`ode.evals.forward` + `ode.evals.recompute` (`d3gs_tpu_torch.tracing`),
over every step of the run. The counter `ode.evals.fused` also counts the
integrals run without autograd (`ode.evals.nograd`: the harness's replay
after the window, the same field on the same card, so fused as well);
those are taken off it. The backward's recompute runs the plain step, so
a fully fused forward reads 50. None for a program without the fused
kernel, or without evaluations."""
import importlib.util


def read(r):
    if "window_views" not in r:
        return None
    try:
        if importlib.util.find_spec("d3gs_tpu_torch.ops.ode_rk4") is None:
            return None
        from d3gs_tpu_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    evals = c.get("ode.evals.forward", 0) + c.get("ode.evals.recompute", 0)
    fused = c.get("ode.evals.fused", 0) - c.get("ode.evals.nograd", 0)
    return 100.0 * fused / evals if evals else None
