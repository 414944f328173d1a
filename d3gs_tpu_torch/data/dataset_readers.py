"""Dataset readers (counterpart of `d3gs_tpu/data/dataset_readers.py`):
the Blender / D-NeRF reader. The other readers are not ported yet
(ROADMAP.md, Queue 1)."""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from ..ops.camera_math import focal2fov, fov2focal
from ..ops.sh import sh2rgb
from .cameras import CameraInfo
from .image_io import read_png
from .ply import read_pointcloud_ply, write_pointcloud_ply


class BasicPointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


class SceneData(NamedTuple):
    point_cloud: Optional[BasicPointCloud]
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str


def load_image(path: str) -> np.ndarray:
    """PNG -> float32 in [0, 1], (H, W) or (H, W, C)."""
    return read_png(path).astype(np.float32) / 255.0


def get_nerfpp_norm(cam_infos) -> dict:
    """Camera-extent normalization (reference dataset_readers.py:77-99)."""
    centers = []
    for cam in cam_infos:
        Rt = np.zeros((4, 4))
        Rt[:3, :3] = cam.R.T
        Rt[:3, 3] = cam.T
        Rt[3, 3] = 1.0
        centers.append(np.linalg.inv(Rt)[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = np.max(np.linalg.norm(centers - avg, axis=0))
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def read_cameras_from_transforms(path, transformsfile, white_background,
                                 extension=".png"):
    """Reference dataset_readers.py:223-266 semantics, incl. the D-NeRF pose
    flip (R = -(c2w^-1)[:3,:3]^T with first column re-negated, T = -t) and
    white/black alpha pre-compositing; per-axis FoV from camera_angle_x."""
    infos = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        if not os.path.splitext(file_path)[1]:
            file_path = file_path + extension
        image_path = os.path.join(path, file_path)
        fid = float(frame.get("time", 0.0))

        matrix = np.linalg.inv(np.array(frame["transform_matrix"]))
        R = -np.transpose(matrix[:3, :3])
        R[:, 0] = -R[:, 0]
        T = -matrix[:3, 3]

        im_data = load_image(image_path)
        if im_data.ndim == 2:
            im_data = np.repeat(im_data[..., None], 3, axis=-1)
        if im_data.shape[-1] == 4:
            alpha = im_data[..., 3:4]
            bg = np.ones(3) if white_background else np.zeros(3)
            rgb = im_data[..., :3] * alpha + bg * (1 - alpha)
            mask = alpha.astype(np.float32)
        else:
            rgb = im_data[..., :3]
            mask = None

        h, w = rgb.shape[:2]
        fovy = focal2fov(fov2focal(fovx, w), h)
        infos.append(CameraInfo(
            uid=idx, R=R, T=T, fovx=fovx, fovy=fovy,
            image=rgb.astype(np.float32), image_path=image_path,
            image_name=Path(image_path).stem, width=w, height=h,
            fid=fid, mask=mask))
    return infos


def read_nerf_synthetic(path, white_background=False, eval_split=True,
                        extension=".png", rng_seed=0):
    """Blender/D-NeRF scene (reference dataset_readers.py:269-306)."""
    train = read_cameras_from_transforms(path, "transforms_train.json",
                                         white_background, extension)
    test = read_cameras_from_transforms(path, "transforms_test.json",
                                        white_background, extension)
    if not eval_split:
        train = train + test
        test = []
    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        rng = np.random.default_rng(rng_seed)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        write_pointcloud_ply(ply_path, xyz, sh2rgb(shs) * 255)
    pts, colors, normals = read_pointcloud_ply(ply_path)
    if colors is None:
        colors = np.full_like(pts, 0.5)
    if normals is None:
        normals = np.zeros_like(pts)
    pcd = BasicPointCloud(pts, colors, normals)
    return SceneData(pcd, train, test, norm, ply_path)
