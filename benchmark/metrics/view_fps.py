"""Frames delivered to the viewer (the image on the host) per second over
the whole window (host clock)."""


def read(r):
    if "window_frames" not in r:
        return None
    return r["window_frames"] / r["window_s"]
