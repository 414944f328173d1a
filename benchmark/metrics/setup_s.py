"""Seconds from process start to the first timed step (host clock)."""


def read(r):
    return r.get("setup_s")
