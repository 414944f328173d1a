"""Kernels launched per frame in the traced sub-window (torch.profiler's
device kernels over its frames)."""


def read(r):
    if "sub_frames" not in r:
        return None
    return r["trace"]["launches"] / r["sub_frames"]
