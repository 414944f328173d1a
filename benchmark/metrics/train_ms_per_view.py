"""Milliseconds of training per camera view fitted: the whole window over
the views of its completed steps (host clock, the window ending with a
synchronize)."""


def read(r):
    if "window_views" not in r:
        return None
    return 1e3 * r["window_s"] / r["window_views"]
