"""Kernels launched per view in the traced sub-window (torch.profiler's
device kernels over the views of its steps)."""


def read(r):
    if "sub_views" not in r:
        return None
    return r["trace"]["launches"] / r["sub_views"]
