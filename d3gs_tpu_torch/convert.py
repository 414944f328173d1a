"""CLI: COLMAP preprocessing for custom image sets (counterpart of the
repository's `convert.py`, the reference convert.py:30-96): feature
extraction, exhaustive matching and mapping (unless --skip_matching), the
undistortion into <source>/images and <source>/sparse, `sparse/*` moved
into `sparse/0`, and with --resize the images_2/, images_4/, images_8/
pyramid.

    python -m d3gs_tpu_torch.convert -s <source> [--camera OPENCV]
        [--colmap_executable colmap] [--no_gpu] [--skip_matching] [--resize]

The same `colmap` command lines run in the same order with the same flags,
and the CLI exits with the same codes: 1 when the executable is not on
PATH, a failed command's own code otherwise. It runs on the host only:
nothing here uses torch or the card.

--resize reads each undistorted image with `data/image_io.py`, resizes it
to (width // d, height // d) with `data/resize.py` (Pillow's default
bicubic, bit for bit) and writes it under the same name. The port writes
PNG only, so it resizes PNG sets. The one deviation from the JAX CLI: the
port has no JPEG encoder, so --resize on a set whose input images are JPEG
raises a ValueError naming the missing encoder before any `colmap` command
runs (the JAX CLI writes the pyramid back as JPEG through Pillow). An RGBA
image raises too: Pillow resizes it with premultiplied alpha.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from .data.image_io import read_image, write_png
from .data.jpeg import SIGNATURE as JPEG_SIGNATURE
from .data.resize import resize


def run(cmd: list[str]) -> None:
    print("+", " ".join(cmd))
    rc = subprocess.call(cmd)
    if rc != 0:
        print(f"command failed with code {rc}", file=sys.stderr)
        sys.exit(rc)


def _jpeg_images(folder: str) -> list[str]:
    names = []
    for name in sorted(os.listdir(folder)) if os.path.isdir(folder) else []:
        with open(os.path.join(folder, name), "rb") as f:
            if f.read(3) == JPEG_SIGNATURE:
                names.append(name)
    return names


def resize_pyramid(src: str) -> None:
    """<src>/images -> images_2/, images_4/, images_8/ at size // d."""
    img_dir = os.path.join(src, "images")
    for div in (2, 4, 8):
        out_dir = os.path.join(src, f"images_{div}")
        os.makedirs(out_dir, exist_ok=True)
        for name in os.listdir(img_dir):
            img = read_image(os.path.join(img_dir, name))
            if img.ndim == 3 and img.shape[2] == 4:
                raise ValueError(
                    f"{name}: RGBA; Pillow resizes it with premultiplied "
                    "alpha, which the port's resize does not do")
            h, w = img.shape[:2]
            write_png(os.path.join(out_dir, name),
                      resize(img, (w // div, h // div)))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="colmap")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--resize", action="store_true",
                        help="emit images_2/, images_4/, images_8/")
    args = parser.parse_args(argv)

    colmap = args.colmap_executable
    if shutil.which(colmap) is None:
        print(f"colmap executable {colmap!r} not found on PATH",
              file=sys.stderr)
        sys.exit(1)
    use_gpu = "0" if args.no_gpu else "1"
    src = args.source_path
    if args.resize:
        jpegs = _jpeg_images(os.path.join(src, "input"))
        if jpegs:
            raise ValueError(
                f"--resize: {len(jpegs)} input images are JPEG (first "
                f"{jpegs[0]!r}) and the port has no JPEG encoder to write "
                "the pyramid; convert the set's images to PNG, or run "
                "without --resize")

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted/sparse"), exist_ok=True)
        run([colmap, "feature_extractor",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--ImageReader.single_camera", "1",
             "--ImageReader.camera_model", args.camera,
             "--SiftExtraction.use_gpu", use_gpu])
        run([colmap, "exhaustive_matcher",
             "--database_path", f"{src}/distorted/database.db",
             "--SiftMatching.use_gpu", use_gpu])
        run([colmap, "mapper",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--output_path", f"{src}/distorted/sparse",
             "--Mapper.ba_global_function_tolerance=0.000001"])

    run([colmap, "image_undistorter",
         "--image_path", f"{src}/input",
         "--input_path", f"{src}/distorted/sparse/0",
         "--output_path", src, "--output_type", "COLMAP"])

    sparse_dir = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse_dir, "0"), exist_ok=True)
    for f in os.listdir(sparse_dir):
        if f != "0":
            shutil.move(os.path.join(sparse_dir, f),
                        os.path.join(sparse_dir, "0", f))

    if args.resize:
        resize_pyramid(src)
    print("Done.")


if __name__ == "__main__":
    main()
