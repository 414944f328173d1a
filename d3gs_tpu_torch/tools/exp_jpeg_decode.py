"""Decode JPEG files with the port's decoder (`data/jpeg.py`) and time it
on the host, per file and per megapixel.

    python -m d3gs_tpu_torch.tools.exp_jpeg_decode FILE.jpg [...] [--reps 3]

Prints one JSON object: per file its shape, the best of `--reps` decodes
in ms and in ms per megapixel, and, where a PNG of the same name lies
beside it (tests/torch_port_jpeg/ keeps Pillow's decode of each fixture
so), whether the decode equals it bit for bit. Decoding runs on the host
CPU only (entropy decoding in Python, the rest in numpy), so the numbers
are the host's.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..data.image_io import read_image
from ..data.jpeg import read_jpeg


def decode_times(paths: list[str], reps: int = 3) -> dict:
    """-> {basename: {"shape", "ms", "ms_per_mp", "equal_to_png"}}."""
    out = {}
    for path in paths:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            img = read_jpeg(path)
            times.append(time.perf_counter() - t0)
        png = os.path.splitext(path)[0] + ".png"
        equal = None
        if os.path.exists(png):
            want = read_image(png)
            equal = bool(img.shape == want.shape
                         and np.array_equal(img, want))
        ms = 1e3 * min(times)
        out[os.path.basename(path)] = {
            "shape": list(img.shape), "ms": ms,
            "ms_per_mp": ms / (img.shape[0] * img.shape[1] / 1e6),
            "equal_to_png": equal}
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="+")
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    out = decode_times(args.paths, args.reps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
