"""Scene: dataset sniffing, camera lists, Gaussian init and checkpoints
(counterpart of `d3gs_tpu/data/scene.py`). Without a saved iteration the
Gaussians come from the reader's point cloud (`create_from_pcd`, kNN scale
init), and the cameras go to `cameras.json`, as the JAX package writes it."""
from __future__ import annotations

import json
import math
import os
import random

import numpy as np
import torch

from .. import config as cfg
from ..models.gaussians import (GaussianState, create_from_pcd,
                                gaussians_from_numpy, round_capacity)
from .cameras import Camera, CameraInfo, camera_from_info
from .dataset_readers import (SceneData, read_colmap_scene, read_dtu_scene,
                              read_dynamic360_scene, read_nerf_synthetic,
                              read_nerfies_scene, read_plenoptic_scene)
from .ply import read_ply_columns, write_ply


def sniff_dataset_type(source_path: str) -> str:
    """Marker-file dispatch (reference scene/__init__.py:45-63)."""
    markers = (("sparse", "colmap"), ("transforms_train.json", "blender"),
               ("cameras_sphere.npz", "dtu"), ("dataset.json", "nerfies"),
               ("poses_bounds.npy", "plenoptic"),
               ("transforms.json", "dynamic360"))
    for marker, kind in markers:
        if os.path.exists(os.path.join(source_path, marker)):
            return kind
    raise ValueError(f"Could not recognize scene type at {source_path}")


def load_scene_data(model: cfg.ModelParams) -> SceneData:
    """The sniffed reader with the JAX package's arguments."""
    kind = sniff_dataset_type(model.source_path)
    src = model.source_path
    if kind == "colmap":
        return read_colmap_scene(src, model.images, model.eval)
    if kind == "blender":
        return read_nerf_synthetic(src, model.white_background, model.eval)
    if kind == "nerfies":
        return read_nerfies_scene(src, model.eval)
    if kind == "dtu":
        return read_dtu_scene(src)
    if kind == "plenoptic":
        return read_plenoptic_scene(src, model.eval, 24)
    return read_dynamic360_scene(src)


def search_for_max_iteration(folder: str) -> int:
    return max(int(f.split("_")[-1]) for f in os.listdir(folder)
               if f.startswith("iteration_"))


def camera_to_json(idx: int, info: CameraInfo) -> dict:
    """Reference cameras.json entry (utils/camera_utils.py:69-88)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = info.R.T
    Rt[:3, 3] = info.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": idx, "img_name": info.image_name,
        "width": info.width, "height": info.height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [r.tolist() for r in W2C[:3, :3]],
        "fy": info.height / (2 * math.tan(info.fovy / 2)),
        "fx": info.width / (2 * math.tan(info.fovx / 2)),
    }


class Scene:
    """Cameras + Gaussians on `device`: those of a saved iteration
    (`load_iteration` -1 for the latest), or with `load_iteration=None`
    fresh ones from the point cloud."""

    def __init__(self, model: cfg.ModelParams, *, load_iteration=None,
                 shuffle: bool = True, resolution_scales=(1.0,),
                 capacity: int = 0, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.model_path = model.model_path
        self.loaded_iter = None
        if load_iteration is not None:
            self.loaded_iter = (search_for_max_iteration(
                os.path.join(self.model_path, "point_cloud"))
                if load_iteration == -1 else load_iteration)
        info = load_scene_data(model)
        self.scene_info = info

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            cams = list(info.test_cameras) + list(info.train_cameras)
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(cams)],
                          f)

        train_infos = list(info.train_cameras)
        test_infos = list(info.test_cameras)
        if shuffle:
            rng = random.Random(seed)
            rng.shuffle(train_infos)
            rng.shuffle(test_infos)

        self.cameras_extent = float(info.nerf_normalization["radius"])
        self.train_cameras: dict[float, list[Camera]] = {}
        self.test_cameras: dict[float, list[Camera]] = {}
        for rs in resolution_scales:
            self.train_cameras[rs] = [
                camera_from_info(c, device=device, resolution_scale=rs,
                                 resolution=model.resolution)
                for c in train_infos]
            self.test_cameras[rs] = [
                camera_from_info(c, device=device, resolution_scale=rs,
                                 resolution=model.resolution)
                for c in test_infos]

        if self.loaded_iter:
            self.gaussians = load_gaussians_ply(
                os.path.join(self.model_path, "point_cloud",
                             f"iteration_{self.loaded_iter}",
                             "point_cloud.ply"),
                sh_degree=model.sh_degree,
                spatial_lr_scale=self.cameras_extent,
                max_gaussians=model.max_gaussians, capacity=capacity,
                seed=seed, device=device)
        else:
            pcd = info.point_cloud
            self.gaussians = create_from_pcd(
                np.asarray(pcd.points, np.float32),
                np.asarray(pcd.colors, np.float32),
                sh_degree=model.sh_degree,
                spatial_lr_scale=self.cameras_extent,
                max_gaussians=model.max_gaussians, capacity=capacity,
                seed=seed, device=device)

    def get_train_cameras(self, scale: float = 1.0):
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0):
        return self.test_cameras[scale]


def save_gaussians_ply(path: str, state: GaussianState) -> None:
    """Write the alive rows in the standard 3DGS PLY layout (reference
    gaussian_model.py:168-190; features flattened channel-major)."""
    alive = state.alive.cpu().numpy()
    p = {k: v.detach().cpu().numpy()[alive]
         for k, v in state.params._asdict().items()}
    n = p["xyz"].shape[0]
    arrays = {"x": p["xyz"][:, 0], "y": p["xyz"][:, 1], "z": p["xyz"][:, 2],
              "nx": np.zeros(n), "ny": np.zeros(n), "nz": np.zeros(n)}
    dc = p["features_dc"].transpose(0, 2, 1).reshape(n, -1)
    rest = p["features_rest"].transpose(0, 2, 1).reshape(n, -1)
    arrays.update({f"f_dc_{i}": dc[:, i] for i in range(dc.shape[1])})
    arrays.update({f"f_rest_{i}": rest[:, i] for i in range(rest.shape[1])})
    arrays["opacity"] = p["opacity"][:, 0]
    arrays.update({f"scale_{i}": p["scaling"][:, i] for i in range(3)})
    arrays.update({f"rot_{i}": p["rotation"][:, i] for i in range(4)})
    write_ply(path, {k: np.asarray(v, np.float32) for k, v in arrays.items()})


def load_gaussians_ply(path: str, *, sh_degree: int = 3,
                       spatial_lr_scale: float = 1.0,
                       max_gaussians: int = 500_000, capacity: int = 0,
                       seed: int = 0,
                       device: str | torch.device = "cuda") -> GaussianState:
    """Load a 3DGS-format checkpoint PLY (reference load_ply :192-240, incl.
    max_gaussians subsampling) into a padded state with every band active."""
    v, names = read_ply_columns(path)
    n = len(v["x"])
    sel = np.arange(n)
    if n > max_gaussians:
        sel = np.random.default_rng(seed).choice(n, max_gaussians,
                                                 replace=False)
    n = len(sel)
    k = (sh_degree + 1) ** 2
    col = lambda names_: np.stack([v[nm] for nm in names_],  # noqa: E731
                                  axis=-1)[sel].astype(np.float32)

    xyz = col(["x", "y", "z"])
    f_dc = col([f"f_dc_{i}" for i in range(3)]).reshape(n, 3, 1) \
        .transpose(0, 2, 1)
    rest_names = sorted((nm for nm in names if nm.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    if rest_names:
        rest = col(rest_names).reshape(n, 3, k - 1).transpose(0, 2, 1)
    else:
        rest = np.zeros((n, k - 1, 3), np.float32)
    cap = capacity or round_capacity(n)

    def padded(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, np.float32)
        out[:n] = a
        return out

    rotation = padded(col([f"rot_{i}" for i in range(4)]))
    rotation[n:, 0] = 1.0
    params = {"xyz": padded(xyz), "features_dc": padded(f_dc),
              "features_rest": padded(rest),
              "scaling": padded(col([f"scale_{i}" for i in range(3)])),
              "rotation": rotation, "opacity": padded(col(["opacity"]))}
    return gaussians_from_numpy(params, np.arange(cap) < n,
                                active_sh_degree=sh_degree,
                                max_sh_degree=sh_degree, device=device,
                                spatial_lr_scale=spatial_lr_scale)
