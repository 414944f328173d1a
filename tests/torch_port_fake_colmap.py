"""A stand-in for the `colmap` binary, for the convert CLIs' tests and
chip_smoke.py (the card's machine has no COLMAP):

    exe = write_fake_colmap(bin_dir)   # -> the path of an executable

Each call appends its argv as a JSON line to $FAKE_COLMAP_LOG where that
is set, and exits with code 3 when its command is $FAKE_COLMAP_FAIL.
`image_undistorter` does what the real one leaves behind for the CLIs:
<output_path>/images is a copy of --image_path, and <output_path>/sparse
holds the model of --input_path (cameras.bin, images.bin, points3D.bin)
copied, or three placeholder files of those names where there is none.
The other commands do nothing. Standard library only.
"""
from __future__ import annotations

import os
import sys

SCRIPT = """#!{python}
import json, os, shutil, sys
log = os.environ.get("FAKE_COLMAP_LOG")
if log:
    with open(log, "a") as f:
        f.write(json.dumps(sys.argv[1:]) + "\\n")
if sys.argv[1] == os.environ.get("FAKE_COLMAP_FAIL"):
    sys.exit(3)
if sys.argv[1] == "image_undistorter":
    a = dict(zip(sys.argv[2::2], sys.argv[3::2]))
    out = a["--output_path"]
    shutil.copytree(a["--image_path"], os.path.join(out, "images"))
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        model = os.path.join(a["--input_path"], name)
        if os.path.exists(model):
            shutil.copy(model, os.path.join(out, "sparse", name))
        else:
            with open(os.path.join(out, "sparse", name), "wb") as f:
                f.write(name.encode())
"""


def write_fake_colmap(bin_dir: str) -> str:
    """-> the path of an executable `colmap` in bin_dir (made if needed)."""
    os.makedirs(bin_dir, exist_ok=True)
    exe = os.path.join(bin_dir, "colmap")
    with open(exe, "w") as f:
        f.write(SCRIPT.format(python=sys.executable))
    os.chmod(exe, 0o755)
    return exe
