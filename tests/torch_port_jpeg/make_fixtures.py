"""Regenerate the JPEG decoder's fixtures in this folder (needs Pillow; runs
the port on the CPU):

    python tests/torch_port_jpeg/make_fixtures.py

- <name>.jpg, one per kind the decoder covers, and <name>.png, Pillow's
  decode of it (`np.asarray(Image.open(jpg))`), which the CPU tests and
  chip_smoke.py phase 4m-a hold the decoder to bit for bit:
    render_420: a 640x400 render of bench.py's scene (0.256 MP), quality
      90, 4:2:0 (Pillow's default);
    progressive_444: progressive, 4:4:4, quality 20;
    gray_restart: grayscale, a restart marker every 2 MCU rows;
    optimized_422: optimized Huffman tables, 4:2:2, quality 50;
    keep_rgb: RGB with an Adobe transform of 0 (`keep_rgb=True`);
    sof1_16bit: extended sequential (SOF1) with a 16-bit table;
    sampling_440: 4:4:0, written by tests/torch_port_jpeg_encoder.py (Pillow
      cannot write it);
- colmap/: a COLMAP set of six 161x121 JPEG views of bench.py's scene
  (`images/0.jpg` .. `5.jpg`, quality 90, 4:2:0, on a radius-4 orbit),
  rendered through the port's plain blend from the cameras its COLMAP
  reader makes, with `sparse/0/{cameras,images,points3D}.bin` written by
  the port's `colmap_loader` writers (PINHOLE; 2,000 of the scene's points
  as the initial cloud);
- the JPEG encoder's and `convert --resize`'s references, all written by
  Pillow, which chip_smoke.py phase 4n and the CPU tests hold the port to:
    encode/render_420_q75.jpg: the pixels of render_420.png saved with
      Pillow's default JPEG encode (quality 75, 4:2:0);
    colmap_pyramid/images_{2,4,8}/0.jpg .. 5.jpg: the JAX `convert.py`
      pyramid of colmap/images/ (`Image.resize` to size // d, then
      `save`): 18 files at 80x60, 40x30 and 20x15;
    rgba/input/0.png .. 2.png: three RGBA images (97x73, 64x48, 33x129;
      alpha 0, 255 and values between), and rgba/images_{2,4,8}/: their
      Pillow pyramid (premultiplied alpha).
"""
from __future__ import annotations

import math
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, os.path.dirname(HERE)]

COLMAP_VIEWS = 6
COLMAP_SIZE = (161, 121)         # width, height: MCUs cropped in both axes
COLMAP_POINTS = 2000


def _render(state, cam, bg):
    import chip_smoke
    from d3gs_tpu_torch.ops import blend as B
    records, bins, grid = chip_smoke.stages(state, cam, None, bg)
    img = B.blend_forward_torch(records, bins, bg, **grid).image
    return (255 * img.clamp(0, 1)).round().byte().numpy()


def _camera(width, height, fovx, c2w_blender, name="0"):
    """The port's camera for a Blender-convention camera-to-world pose."""
    from d3gs_tpu_torch.data.cameras import CameraInfo, camera_from_info
    from d3gs_tpu_torch.ops.camera_math import focal2fov, fov2focal
    c2w = np.array(c2w_blender, np.float64)
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    fovy = focal2fov(fov2focal(fovx, width), height)
    info = CameraInfo(uid=0, R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=fovx,
                      fovy=fovy, image=np.zeros((height, width, 3),
                                                np.float32),
                      image_path="", image_name=name, width=width,
                      height=height, fid=0.0)
    return camera_from_info(info, device="cpu"), w2c


def _save(name, img, **kw):
    from PIL import Image
    jpg = os.path.join(HERE, f"{name}.jpg")
    Image.fromarray(img).save(jpg, "JPEG", **kw)
    _save_reference(name)


def _save_reference(name):
    from PIL import Image
    jpg = os.path.join(HERE, f"{name}.jpg")
    ref = np.asarray(Image.open(jpg))
    Image.fromarray(ref).save(os.path.join(HERE, f"{name}.png"),
                              optimize=True)


def _pattern(h, w, seed):
    """Smooth structure plus a little noise, uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / (5 + 3 * c)) * np.cos(yy / 7.0)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 6, (h, w, 3)), 0,
                   255).astype(np.uint8)


def write_colmap_set(root, state, bg):
    from PIL import Image
    from d3gs_tpu_torch.data import colmap_loader as cl
    from d3gs_tpu_torch.tools.exp_empty_views import bench_points, orbit_c2w
    import chip_smoke
    width, height = COLMAP_SIZE
    fovx = math.radians(60)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "sparse", "0"), exist_ok=True)
    focal = width / (2 * math.tan(fovx / 2))
    cl.write_cameras_binary(
        os.path.join(root, "sparse", "0", "cameras.bin"),
        {1: cl.ColmapCamera(1, "PINHOLE", width, height,
                            np.array([focal, focal, width / 2,
                                      height / 2]))})
    images = {}
    for k in range(COLMAP_VIEWS):
        c2w = orbit_c2w(k * 2 * math.pi / COLMAP_VIEWS + 0.3)
        cam, w2c = _camera(width, height, fovx, c2w, str(k))
        img = _render(state, cam, bg)
        Image.fromarray(img).save(os.path.join(root, "images", f"{k}.jpg"),
                                  "JPEG", quality=90)
        images[k + 1] = cl.ColmapImage(
            id=k + 1, qvec=cl.rotmat2qvec(w2c[:3, :3]), tvec=w2c[:3, 3],
            camera_id=1, name=f"{k}.jpg", xys=np.zeros((0, 2)),
            point3D_ids=np.zeros(0, np.int64))
    cl.write_images_binary(os.path.join(root, "sparse", "0", "images.bin"),
                           images)
    pts, cols = bench_points(chip_smoke.N_BENCH)
    keep = np.random.default_rng(0).choice(len(pts), COLMAP_POINTS,
                                           replace=False)
    cl.write_points3d_binary(
        os.path.join(root, "sparse", "0", "points3D.bin"),
        pts[np.sort(keep)].astype(np.float64),
        (cols[np.sort(keep)] * 255).round().astype(np.uint8))


PYRAMID = (2, 4, 8)
RGBA_SIZES = ((73, 97), (48, 64), (129, 33))     # height, width


def _pillow_pyramid(src_dir, out_root):
    """convert.py's --resize: each image of src_dir resized to size // d
    and saved under its name into out_root/images_d/."""
    from PIL import Image
    for div in PYRAMID:
        out = os.path.join(out_root, f"images_{div}")
        os.makedirs(out, exist_ok=True)
        for name in sorted(os.listdir(src_dir)):
            im = Image.open(os.path.join(src_dir, name))
            im.resize((im.width // div, im.height // div)).save(
                os.path.join(out, name))


def write_encoder_fixtures():
    from PIL import Image
    os.makedirs(os.path.join(HERE, "encode"), exist_ok=True)
    Image.open(os.path.join(HERE, "render_420.png")).save(
        os.path.join(HERE, "encode", "render_420_q75.jpg"))
    _pillow_pyramid(os.path.join(HERE, "colmap", "images"),
                    os.path.join(HERE, "colmap_pyramid"))
    rgba_in = os.path.join(HERE, "rgba", "input")
    os.makedirs(rgba_in, exist_ok=True)
    rng = np.random.default_rng(5)
    for k, (h, w) in enumerate(RGBA_SIZES):
        img = _pattern(h, w, 10 + k)
        yy, xx = np.mgrid[0:h, 0:w]
        alpha = np.clip(255 * (1.5 - np.hypot(yy / h - 0.5, xx / w - 0.5)
                               * 3), 0, 255).astype(np.uint8)
        alpha[rng.random((h, w)) < 0.05] = 3
        Image.fromarray(np.dstack([img, alpha]), "RGBA").save(
            os.path.join(rgba_in, f"{k}.png"), optimize=True)
    _pillow_pyramid(rgba_in, os.path.join(HERE, "rgba"))


def main():
    import torch
    import chip_smoke
    from d3gs_tpu_torch.models.gaussians import gaussians_from_numpy
    sys.path.insert(0, os.path.dirname(HERE))
    from torch_port_jpeg_encoder import encode_baseline
    torch.manual_seed(0)
    state = gaussians_from_numpy(*chip_smoke.bench_params("cpu"), 3, 3,
                                 "cpu")
    bg = torch.zeros(3)
    from d3gs_tpu_torch.tools.exp_empty_views import orbit_c2w
    cam, _ = _camera(640, 400, math.radians(60), orbit_c2w(0.3))
    _save("render_420", _render(state, cam, bg), quality=90)
    pat = _pattern(65, 129, 0)
    _save("progressive_444", pat, quality=20, progressive=True,
          subsampling=0)
    _save("gray_restart", pat[..., 1], quality=90, restart_marker_rows=2)
    _save("optimized_422", pat, quality=50, optimize=True, subsampling=1)
    _save("keep_rgb", pat, quality=90, keep_rgb=True, subsampling=0)
    _save("sof1_16bit", pat, qtables=[[300] + [4] * 63, [6] * 64])
    with open(os.path.join(HERE, "sampling_440.jpg"), "wb") as f:
        f.write(encode_baseline(_pattern(33, 47, 1),
                                ((1, 2), (1, 1), (1, 1))))
    _save_reference("sampling_440")
    write_colmap_set(os.path.join(HERE, "colmap"), state, bg)
    write_encoder_fixtures()


if __name__ == "__main__":
    main()
