"""Host waits on the device per view in the traced sub-window: the CUDA
runtime's stream, device and event synchronizes and synchronous copies
called inside the steps (torch.profiler's CPU side)."""


def read(r):
    if "sub_views" not in r:
        return None
    return r["trace"]["syncs"] / r["sub_views"]
