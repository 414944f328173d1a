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

--resize reads each undistorted image once with `data/image_io.py`,
resizes it to (width // d, height // d) for d = 2, 4, 8 with
`data/resize.py` (Pillow's default bicubic, bit for bit; RGBA and gray +
alpha with Pillow's premultiplied alpha) and writes it under the same
name in the format its extension names, case-insensitive, as Pillow's
`save` picks it: `.jpg`, `.jpeg`, `.jpe` and `.jfif` through
`data/jpeg_encode.py` (Pillow's default JPEG encode, byte for byte: quality
75, 4:2:0, the input's COM comment carried over), `.png` and `.apng` as
PNG with the input's ICC profile and tRNS transparency. The pyramid is the
JAX CLI's, JPEG bytes equal and PNG pixels and Pillow `info` equal.

It raises where Pillow raises, and in three places Pillow does not:
- RGBA or gray + alpha to a JPEG name raises an OSError ("cannot write
  mode RGBA as JPEG"), as Pillow's save does;
- another extension raises a ValueError (Pillow would write TIFF, BMP,
  ...; the port writes JPEG and PNG only);
- palette, 16-bit gray and 1-bit gray images raise a ValueError from the
  reader: Pillow resizes the first and last with NEAREST and the second in
  16 bits, which the port does not do.
The JAX CLI opens each image once per level; the port decodes it once for
all three, with the same output.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from .data.image_io import read_image, write_png
from .data.jpeg_encode import encode_jpeg
from .data.resize import resize


def run(cmd: list[str]) -> None:
    print("+", " ".join(cmd))
    rc = subprocess.call(cmd)
    if rc != 0:
        print(f"command failed with code {rc}", file=sys.stderr)
        sys.exit(rc)


JPEG_EXTENSIONS = (".jpg", ".jpeg", ".jpe", ".jfif")
PNG_EXTENSIONS = (".png", ".apng")


def _save_like_pillow(path: str, img, info: dict) -> None:
    """Write `img` with the `info` of `read_image(..., info=True)` as
    Pillow's `Image.save(path)` does for an image opened with that info:
    the format from the extension, JPEG with the comment, PNG with the ICC
    profile and transparency."""
    ext = os.path.splitext(path)[1].lower()
    if ext in JPEG_EXTENSIONS:
        if img.ndim == 3 and img.shape[2] in (2, 4):
            mode = "LA" if img.shape[2] == 2 else "RGBA"
            raise OSError(f"cannot write mode {mode} as JPEG")
        with open(path, "wb") as f:
            f.write(encode_jpeg(img, comment=info.get("comment")))
    elif ext in PNG_EXTENSIONS:
        write_png(path, img, icc_profile=info.get("icc_profile"),
                  transparency=info.get("transparency"))
    else:
        raise ValueError(f"{path}: the port writes JPEG and PNG only "
                         f"(extension {ext!r})")


def resize_pyramid(src: str) -> None:
    """<src>/images -> images_2/, images_4/, images_8/ at size // d."""
    img_dir = os.path.join(src, "images")
    for div in (2, 4, 8):
        os.makedirs(os.path.join(src, f"images_{div}"), exist_ok=True)
    for name in os.listdir(img_dir):
        img, info = read_image(os.path.join(img_dir, name), info=True)
        h, w = img.shape[:2]
        for div in (2, 4, 8):
            _save_like_pillow(os.path.join(src, f"images_{div}", name),
                           resize(img, (w // div, h // div)), info)


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
