"""Share of the traced sub-window of a viewing cell in which no kernel,
copy or memset ran on the device (torch.profiler's timeline)."""


def read(r):
    if "window_frames" not in r or "trace" not in r:
        return None
    t = r["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
