"""Share of the training window's views whose field evaluation saw AST's
jittered time, in %: the program's counter `deform.ast`
(`train/baseline.py::make_deform_fn`, one a jittered evaluation) over the
steps before the profiled sub-window, as `loops/train_real.py` snapshots
it, over those steps' views. None where the loop took no snapshot."""


def read(r):
    if "ast_evals" not in r or not r.get("window_views"):
        return None
    return 100.0 * r["ast_evals"] / r["window_views"]
