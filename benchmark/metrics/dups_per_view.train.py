"""(tile, Gaussian) duplicates the binning kept per view: the program's
counter `StepAux.dup_total`, summed over the window's steps, over their
views."""


def read(r):
    if "window_views" not in r:
        return None
    return r["dups_sum"] / r["window_views"]
