"""Share of the deformation MLP's evaluations that ran in the fused kernels
(`d3gs_tpu_torch/ops/mlp_field.py`), in %: the program's counter
`deform.mlp.fused` over `deform.mlp.evals` (`d3gs_tpu_torch.tracing`, one
each a `DeformMLP` evaluation), over every step of the run. 100 says that
every training step's field ran the fused forward and, through autograd,
the fused backward. None for a program without the fused path, or without
evaluations."""
import importlib.util


def read(r):
    if "window_views" not in r:
        return None
    try:
        if importlib.util.find_spec("d3gs_tpu_torch.ops.mlp_field") is None:
            return None
        from d3gs_tpu_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    evals = c.get("deform.mlp.evals", 0)
    return 100.0 * c.get("deform.mlp.fused", 0) / evals if evals else None
