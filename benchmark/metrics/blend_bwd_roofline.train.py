"""Share of its roofline the backward blend kernel reaches in the last
traced step: the least time of the pairs that step's views need (counted
by the plain reference, times the operations per pair of
`benchmark/counts.py`, or the bytes of the records and the image if those
bound it) over the kernel's device time in that step (torch.profiler)."""


def read(r):
    least = r.get("blend_bwd_least_s")
    if not least or "trace" not in r:
        return None
    times = [t for name, ts in r["trace"]["kernel_s"].items()
             if "blend_bwd_kernel" in name for t in ts]
    last = times[-len(least):]
    if len(last) < len(least) or sum(last) <= 0:
        return None
    return 100.0 * sum(least) / sum(last)
