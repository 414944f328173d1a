"""Share of the viewer's dynamics evaluations that ran in the fused RK4
kernel (`d3gs_tpu_torch/ops/ode_rk4.py`), in %: the program's counter
`ode.evals.fused` over its forward integrals' `ode.evals.nograd` and
`ode.evals.forward` (`d3gs_tpu_torch.tracing`), over every frame of the
run. None for a program without the fused kernel, or without evaluations."""
import importlib.util


def read(r):
    if "window_frames" not in r:
        return None
    try:
        if importlib.util.find_spec("d3gs_tpu_torch.ops.ode_rk4") is None:
            return None
        from d3gs_tpu_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    evals = c.get("ode.evals.nograd", 0) + c.get("ode.evals.forward", 0)
    return 100.0 * c.get("ode.evals.fused", 0) / evals if evals else None
