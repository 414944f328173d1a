"""(tile, Gaussian) duplicates the binning kept per frame: the program's
counter `render(...).counts`, summed over the window's frames, over
them."""


def read(r):
    if "window_frames" not in r:
        return None
    return r["dups_sum"] / r["window_frames"]
