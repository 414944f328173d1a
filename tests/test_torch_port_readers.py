"""The port's dataset readers, scene dispatch, image decoding and camera
resize against the JAX package on the CPU.

Readers: on the sets that tests/test_dataset_readers.py writes (COLMAP bin
and txt, Nerfies under each split rule, DTU, Plenoptic Video, dynamic360)
and a Blender set, each package reads its own copy; every `CameraInfo`
field, the splits, the normalization and the point cloud (which each
package writes into its copy when the set has none) are equal exactly: the
same numpy math on the same PNG bytes; and so on the same sets with JPEG
images. The resize equals Pillow's default `Image.resize` bit for bit.
"""
import json
import math
import os
import shutil

import numpy as np
import pytest

from d3gs_tpu import config as JC
from d3gs_tpu.data import cameras as JCam
from d3gs_tpu.data import dataset_readers as jdr
from d3gs_tpu.data import scene as JS
from d3gs_tpu_torch import config as TC
from d3gs_tpu_torch.data import cameras as TCam
from d3gs_tpu_torch.data import dataset_readers as tdr
from d3gs_tpu_torch.data import scene as TS
from d3gs_tpu_torch.data.image_io import write_png
from d3gs_tpu_torch.data.resize import resize
from tests.test_dataset_readers import _make_colmap_fixture, _rot, _write_png
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


def _nerfies_set(parent, dirname, ratio, ids, train_ids=None, val_ids=None):
    """tests/test_dataset_readers.py's Nerfies fixture under any parent
    directory name (the name picks the split rule)."""
    root = os.path.join(parent, dirname, "data")
    sub = int(1 / ratio)
    os.makedirs(os.path.join(root, "camera"))
    os.makedirs(os.path.join(root, "rgb", f"{sub}x"))
    with open(os.path.join(root, "scene.json"), "w") as f:
        json.dump({"scale": 2.0, "center": [0.1, 0.2, 0.3]}, f)
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump({i: {"time_id": k} for k, i in enumerate(ids)}, f)
    ds = {"ids": ids}
    if train_ids is not None:
        ds["train_ids"], ds["val_ids"] = train_ids, val_ids
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump(ds, f)
    rng = np.random.default_rng(1)
    for i in ids:
        cam = {"orientation": _rot(0.2 + rng.uniform()).tolist(),
               "position": rng.normal(size=3).tolist(),
               "focal_length": 20.0, "principal_point": [4.0, 4.0],
               "image_size": [8 * sub, 8 * sub]}
        with open(os.path.join(root, "camera", f"{i}.json"), "w") as f:
            json.dump(cam, f)
        _write_png(os.path.join(root, "rgb", f"{sub}x", f"{i}.png"),
                   value=int(rng.integers(0, 256)))
    np.save(os.path.join(root, "points.npy"), rng.normal(size=(6, 3)))
    return root


def _dtu_set(root):
    os.makedirs(os.path.join(root, "image"))
    K = np.array([[20.0, 0, 4.0], [0, 22.0, 4.0], [0, 0, 1.0]])
    rng = np.random.default_rng(2)
    mats = {}
    for i in range(2):
        R = _rot(0.4 * i + 0.1)
        t = -R @ rng.normal(size=3)
        w = np.eye(4)
        w[:3, :4] = K @ np.concatenate([R, t[:, None]], axis=1)
        mats[f"world_mat_{i}"] = w
        mats[f"scale_mat_{i}"] = np.eye(4)
        _write_png(os.path.join(root, "image", f"{i:03d}.png"), value=40 * i)
    np.savez(os.path.join(root, "cameras_sphere.npz"), **mats)
    return root


def _plenoptic_set(root, n_cams=3, n_frames=4):
    rng = np.random.default_rng(3)
    poses = np.zeros((n_cams, 3, 5))
    for i in range(n_cams):
        c2w = np.eye(4)
        c2w[:3, :3] = _rot(0.2 * i)
        c2w[:3, 3] = rng.normal(size=3)
        poses[i, :, 0] = -c2w[:3, 1]
        poses[i, :, 1] = c2w[:3, 0]
        poses[i, :, 2:4] = c2w[:3, 2:4]
        poses[i, :, 4] = [8, 8, 21.0]
    pb = np.concatenate([poses.reshape(n_cams, 15),
                         np.tile([0.1, 10.0], (n_cams, 1))], axis=1)
    os.makedirs(root, exist_ok=True)
    np.save(os.path.join(root, "poses_bounds.npy"), pb)
    for i in range(n_cams):
        d = os.path.join(root, "frames", f"cam{i:02d}")
        os.makedirs(d)
        for f in range(n_frames):
            _write_png(os.path.join(d, f"{f:04d}.png"), value=10 * f + i)
    return root


def _transforms_set(root, name, n, rgba=False):
    """A Blender-layout transforms file with random 8x8 images."""
    rng = np.random.default_rng(len(name) + n)
    os.makedirs(root, exist_ok=True)
    frames = []
    for i in range(n):
        c2w = np.eye(4)
        c2w[:3, :3] = _rot(0.5 * i)
        c2w[2, 3] = 4.0
        fname = f"{name.split('.')[0]}_{i}"
        write_png(os.path.join(root, fname + ".png"), rng.integers(
            0, 256, (8, 8, 4 if rgba else 3)).astype(np.uint8))
        frames.append({"file_path": f"./{fname}", "time": i / max(n - 1, 1),
                       "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, name), "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    return root


def _blender_set(root):
    _transforms_set(root, "transforms_train.json", 3, rgba=True)
    return _transforms_set(root, "transforms_test.json", 2, rgba=True)


def _twin(tmp_path, write):
    """The set written once, copied: (JAX's copy, the port's copy)."""
    src = write(str(tmp_path / "j"))
    dst = str(tmp_path / "t") + src[len(str(tmp_path / "j")):]
    shutil.copytree(str(tmp_path / "j"), str(tmp_path / "t"))
    return src, dst


def _same(a, b, root_a, root_b, what):
    if isinstance(b, str) and b.startswith(root_b):
        assert os.path.relpath(a, root_a) == os.path.relpath(b, root_b), what
    elif isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and np.array_equal(a, b), what
    elif isinstance(b, dict):
        assert list(a) == list(b), what
        for k in b:
            _same(a[k], b[k], root_a, root_b, f"{what}.{k}")
    else:
        assert a == b and type(a) is type(b), (what, a, b)


def assert_scenes_equal(t, j, root_t, root_j):
    for split in ("train_cameras", "test_cameras"):
        tc, jc = getattr(t, split), getattr(j, split)
        assert len(tc) == len(jc), split
        for k, (a, b) in enumerate(zip(tc, jc)):
            for f in b._fields:
                _same(getattr(a, f), getattr(b, f), root_t, root_j,
                      f"{split}[{k}].{f}")
    _same(t.nerf_normalization, j.nerf_normalization, root_t, root_j, "norm")
    _same(t.ply_path, j.ply_path, root_t, root_j, "ply_path")
    for f in ("points", "colors", "normals"):
        _same(getattr(t.point_cloud, f), getattr(j.point_cloud, f), root_t,
              root_j, f)


def _colmap(text):
    def write(root):
        _make_colmap_fixture(root, text=text)
        return root
    return write


def _nerfies(dirname, ratio, train_val):
    ids = [f"f{i:02d}" for i in range(8)]
    extra = dict(train_ids=ids[:5], val_ids=ids[5:]) if train_val else {}
    return lambda root: _nerfies_set(root, dirname, ratio, ids, **extra)


# (reader call, set writer) per case: the readers' own entry points
READERS = {
    "colmap_bin": (lambda r, p: r.read_colmap_scene(p, eval_split=True,
                                                    llffhold=2),
                   _colmap(False)),
    "colmap_txt": (lambda r, p: r.read_colmap_scene(p, eval_split=True),
                   _colmap(True)),
    "nerfies_vrig": (lambda r, p: r.read_nerfies_scene(p, eval_split=True),
                     _nerfies("vrig_scene", 0.25, True)),
    "nerfies_nerf": (lambda r, p: r.read_nerfies_scene(p, eval_split=True),
                     _nerfies("NeRF_scene", 1.0, True)),
    "nerfies_interp": (lambda r, p: r.read_nerfies_scene(p, eval_split=True),
                       _nerfies("interp_scene", 0.5, False)),
    "nerfies_hyper": (lambda r, p: r.read_nerfies_scene(p, eval_split=True),
                      _nerfies("hyper_scene", 0.5, False)),
    "nerfies_bare": (lambda r, p: r.read_nerfies_scene(p, eval_split=True),
                     _nerfies("scene", 0.5, False)),
    "dtu": (lambda r, p: r.read_dtu_scene(p), _dtu_set),
    "plenoptic": (lambda r, p: r.read_plenoptic_scene(
        p, eval_split=True, num_images=4, hold_id=(1,)), _plenoptic_set),
    "dynamic360": (lambda r, p: r.read_dynamic360_scene(p),
                   lambda root: _transforms_set(root, "transforms.json", 3)),
}


@pytest.mark.parametrize("case", list(READERS))
def test_reader_matches_jax(tmp_path, case):
    read, write = READERS[case]
    root_j, root_t = _twin(tmp_path, write)
    j = read(jdr, root_j)
    t = read(tdr, root_t)
    assert len(j.train_cameras) > 0
    assert_scenes_equal(t, j, root_t, root_j)


def test_registry_matches_jax():
    assert list(tdr.scene_load_type_callbacks) == list(
        jdr.scene_load_type_callbacks)


# the sets by the kind that `sniff_dataset_type` should find
KINDS = {"colmap": _colmap(False), "blender": _blender_set,
         "dtu": _dtu_set, "nerfies": _nerfies("vrig_scene", 0.25, True),
         "plenoptic": _plenoptic_set,
         "dynamic360": lambda root: _transforms_set(root, "transforms.json",
                                                    2)}


@pytest.mark.parametrize("kind", list(KINDS))
def test_load_scene_data_dispatch_matches_jax(tmp_path, kind):
    """`sniff_dataset_type` and `load_scene_data` with JAX's arguments
    (model.images, model.eval, plenoptic's 24 frames)."""
    root_j, root_t = _twin(tmp_path, KINDS[kind])
    assert TS.sniff_dataset_type(root_t) == JS.sniff_dataset_type(root_j) \
        == kind
    j = JS.load_scene_data(JC.ModelParams(source_path=root_j, eval=True,
                                          white_background=True))
    t = TS.load_scene_data(TC.ModelParams(source_path=root_t, eval=True,
                                          white_background=True))
    assert_scenes_equal(t, j, root_t, root_j)


def test_sniff_rejects_unknown_sets(tmp_path):
    for sniff in (TS.sniff_dataset_type, JS.sniff_dataset_type):
        with pytest.raises(ValueError, match="scene type"):
            sniff(str(tmp_path))


def test_jpeg_and_other_formats_raise(tmp_path):
    """A JPEG decodes to Pillow's arrays (it raised before the port had a
    decoder); any other format still raises; a COLMAP set of JPEGs loads
    to the JAX reader's arrays."""
    from PIL import Image
    img = _image(8, 8)
    jpg = str(tmp_path / "a.jpg")
    Image.fromarray(img).save(jpg)
    got = tdr.load_image(jpg)
    assert got.dtype == np.float32
    assert np.array_equal(got, jdr._load_image(jpg))
    gif = str(tmp_path / "a.gif")
    Image.fromarray(img).save(gif)
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        tdr.load_image(gif)
    # a COLMAP set whose images are JPEG (under their .png names)
    root_j, root_t = str(tmp_path / "colmap_j"), str(tmp_path / "colmap_t")
    _make_colmap_fixture(root_j)
    _to_jpeg(root_j)
    shutil.copytree(root_j, root_t)
    assert_scenes_equal(tdr.read_colmap_scene(root_t),
                        jdr.read_colmap_scene(root_j), root_t, root_j)


def _to_jpeg(root, seed=0):
    """Every image of a set rewritten as JPEG bytes under its own name: a
    fresh pattern of the same size, quality 90, 4:2:0 (odd sizes crop)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for dirpath, _, names in sorted(os.walk(root)):
        for name in sorted(names):
            if not name.endswith(".png"):
                continue
            path = os.path.join(dirpath, name)
            h, w = np.asarray(Image.open(path)).shape[:2]
            Image.fromarray(_image(h, w, int(rng.integers(1 << 30)))).save(
                path, "JPEG", quality=90)
    return root


@pytest.mark.parametrize("kind", list(KINDS))
def test_load_scene_data_jpeg_sets_match_jax(tmp_path, kind):
    """Each reader of `load_scene_data` on a set whose images are all JPEG
    loads the JAX reader's arrays exactly."""
    root_j, root_t = _twin(tmp_path, lambda r: _to_jpeg(KINDS[kind](r)))
    j = JS.load_scene_data(JC.ModelParams(source_path=root_j, eval=True,
                                          white_background=True))
    t = TS.load_scene_data(TC.ModelParams(source_path=root_t, eval=True,
                                          white_background=True))
    assert_scenes_equal(t, j, root_t, root_j)


def test_committed_colmap_jpeg_set_matches_jax(tmp_path):
    """tests/torch_port_jpeg/colmap/ (the set chip_smoke.py trains on):
    six 161x121 JPEG views, read by both packages from their own copies."""
    src = os.path.join(os.path.dirname(__file__), "torch_port_jpeg",
                       "colmap")
    root_j, root_t = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(src, root_j)
    shutil.copytree(src, root_t)
    j = JS.load_scene_data(JC.ModelParams(source_path=root_j, eval=True))
    t = TS.load_scene_data(TC.ModelParams(source_path=root_t, eval=True))
    assert len(t.train_cameras) + len(t.test_cameras) == 6
    assert t.train_cameras[0].image.shape == (121, 161, 3)
    assert_scenes_equal(t, j, root_t, root_j)


def _image(h, w, seed=0):
    """Smooth structure plus noise, uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / (5 + 3 * c)) * np.cos(yy / 7.0)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 20, (h, w, 3)), 0,
                   255).astype(np.uint8)


RESIZES = {"half": ((400, 400), (200, 200)),
           "quarter": ((400, 400), (100, 100)),
           "eighth": ((800, 800), (100, 100)),
           "clamp_1600": ((2000, 1125), (1600, 900)),
           "non_integer": ((403, 301), (257, 190)),
           "width_only": ((400, 300), (200, 300)),
           "height_only": ((400, 300), (400, 150)),
           "upscale": ((64, 48), (200, 130))}


@pytest.mark.parametrize("case", list(RESIZES))
def test_resize_equals_pillow(case):
    from PIL import Image
    (w, h), size = RESIZES[case]
    img = _image(h, w)
    got = resize(img, size)
    want = np.asarray(Image.fromarray(img).resize(size))
    assert got.shape == want.shape == (size[1], size[0], 3)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("resolution,size", [(2, (400, 400)),
                                             (4, (403, 301)),
                                             (-1, (2000, 1125))])
def test_camera_resize_matches_jax(resolution, size):
    """camera_from_info's resolution policy and resize against JAX's (which
    resizes with Pillow): the same image, size and matrices."""
    w, h = size
    info = JCam.CameraInfo(
        uid=0, R=_rot(0.3), T=np.array([0.1, -0.2, 4.0]), fovx=0.9,
        fovy=2 * math.atan(math.tan(0.45) * h / w),
        image=_image(h, w, seed=1).astype(np.float32) / 255.0,
        image_path="", image_name="v", width=w, height=h, fid=0.5)
    j = JCam.camera_from_info(info, resolution=resolution)
    t = TCam.camera_from_info(TCam.CameraInfo(*info), device="cpu",
                              resolution=resolution)
    assert (t.width, t.height) == (j.width, j.height)
    assert (t.width, t.height) == {2: (200, 200), 4: (101, 75),
                                   -1: (1600, 900)}[resolution]
    assert np.array_equal(t.image.numpy(), np.asarray(j.image))
    for name in ("viewmatrix", "projmatrix", "campos"):
        assert np.array_equal(getattr(t, name).numpy(),
                              np.asarray(getattr(j, name))), name
