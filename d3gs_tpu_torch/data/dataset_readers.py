"""Dataset readers: Blender/D-NeRF, COLMAP, Nerfies/HyperNeRF, DTU,
Plenoptic Video and dynamic360 (counterpart of
`d3gs_tpu/data/dataset_readers.py`, the reference's
scene/dataset_readers.py). Each reader returns a `SceneData` of host-side
`CameraInfo`s and an init point cloud; the per-frame normalized time
(`fid`) carries the dynamic axis. The random init clouds come from
`np.random.default_rng(rng_seed)`, so both packages write the same
`points3d.ply`.

Images are read by `load_image`, which decodes PNG and JPEG
(`image_io.read_image`; JPEG equal to Pillow's decode bit for bit, so a
JPEG set, as COLMAP scenes usually are, loads to the JAX readers' arrays).
Any other format raises a ValueError that names it, where the JAX package
reads whatever Pillow reads.
"""
from __future__ import annotations

import glob
import json
import os
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from ..ops.camera_math import focal2fov, fov2focal
from ..ops.sh import sh2rgb
from . import colmap_loader as cl
from .cameras import CameraInfo
from .image_io import read_image
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
    """PNG or JPEG -> float32 in [0, 1], (H, W) or (H, W, C); any other
    format raises ValueError."""
    return read_image(path).astype(np.float32) / 255.0


def _write_random_cloud(ply_path: str, rng_seed: int,
                        num_pts: int = 100_000) -> None:
    """The reference's random init: points uniform in [-1.3, 1.3]^3, SH DC
    colours uniform in [0, 1/255)."""
    rng = np.random.default_rng(rng_seed)
    xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
    shs = rng.random((num_pts, 3)) / 255.0
    write_pointcloud_ply(ply_path, xyz, sh2rgb(shs) * 255)


def _read_cloud(ply_path: str) -> BasicPointCloud:
    pts, colors, normals = read_pointcloud_ply(ply_path)
    if colors is None:
        colors = np.full_like(pts, 0.5)
    if normals is None:
        normals = np.zeros_like(pts)
    return BasicPointCloud(pts, colors, normals)


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
        _write_random_cloud(ply_path, rng_seed)
    return SceneData(_read_cloud(ply_path), train, test, norm, ply_path)


# ---------------------------------------------------------------------------
# COLMAP (real scenes; fid derived from integer image name)
# ---------------------------------------------------------------------------

def read_colmap_cameras(extrinsics, intrinsics, images_folder):
    infos = []
    num_frames = len(extrinsics)
    for key in sorted(extrinsics):
        extr = extrinsics[key]
        intr = intrinsics[extr.camera_id]
        R = cl.qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            fovy = focal2fov(intr.params[0], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        elif intr.model == "PINHOLE":
            fovy = focal2fov(intr.params[1], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {intr.model}; undistort "
                "first (PINHOLE/SIMPLE_PINHOLE only)")
        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        image_name = os.path.basename(image_path).split(".")[0]
        image = load_image(image_path)[..., :3]
        # frame time from the integer image name (reference :136)
        fid = int(image_name) / (num_frames - 1) if num_frames > 1 else 0.0
        infos.append(CameraInfo(
            uid=intr.id, R=R, T=T, fovx=fovx, fovy=fovy,
            image=image.astype(np.float32), image_path=image_path,
            image_name=image_name, width=intr.width, height=intr.height,
            fid=fid))
    infos.sort(key=lambda c: c.image_name)
    return infos


def read_colmap_scene(path, images=None, eval_split=False, llffhold=8):
    """Reference dataset_readers.py:172-220: every llffhold-th view is a
    test view under `eval_split`."""
    sparse = os.path.join(path, "sparse/0")
    try:
        extr = cl.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = cl.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = cl.read_images_text(os.path.join(sparse, "images.txt"))
        intr = cl.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    reading_dir = "images" if images is None else images
    infos = read_colmap_cameras(extr, intr, os.path.join(path, reading_dir))
    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []
    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = cl.read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = cl.read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        write_pointcloud_ply(ply_path, xyz, rgb)
    return SceneData(_read_cloud(ply_path), train, test, norm, ply_path)


# ---------------------------------------------------------------------------
# Nerfies / HyperNeRF (dataset.json + scene.json + camera/*.json)
# ---------------------------------------------------------------------------

def _nerfies_camera_from_json(path, scale):
    """utils/camera_utils.py:91-112 subset."""
    with open(path) as fp:
        cj = json.load(fp)
    return dict(
        orientation=np.array(cj["orientation"]),
        position=np.array(cj["position"]),
        focal_length=cj["focal_length"] * scale,
        principal_point=np.array(cj["principal_point"]) * scale,
        image_size=np.array((int(round(cj["image_size"][0] * scale)),
                             int(round(cj["image_size"][1] * scale)))),
    )


def read_nerfies_cameras(path):
    """Reference readNerfiesCameras (dataset_readers.py:398-474), split by
    the parent directory's name: vrig/NeRF scenes use the dataset's
    train/val ids; interp/hyper scenes hold out every 4th (offset 2); a
    bare HyperNeRF scene trains on every 4th only."""
    with open(os.path.join(path, "scene.json")) as f:
        scene_json = json.load(f)
    with open(os.path.join(path, "metadata.json")) as f:
        meta_json = json.load(f)
    with open(os.path.join(path, "dataset.json")) as f:
        dataset_json = json.load(f)

    coord_scale = scene_json["scale"]
    scene_center = np.array(scene_json["center"])

    name = path.rstrip("/").split("/")[-2] if "/" in path.rstrip("/") else ""
    if name.startswith("vrig"):
        train_img = dataset_json["train_ids"]
        val_img = dataset_json["val_ids"]
        all_img = list(train_img) + list(val_img)
        ratio = 0.25
    elif name.lower().startswith("nerf"):
        train_img = dataset_json["train_ids"]
        val_img = dataset_json["val_ids"]
        all_img = list(train_img) + list(val_img)
        ratio = 1.0
    elif name.startswith("interp") or name.startswith("hyper"):
        all_id = dataset_json["ids"]
        train_img = all_id[::4]
        val_img = all_id[2::4]
        all_img = list(train_img) + list(val_img)
        ratio = 0.5
    else:
        train_img = dataset_json["ids"][::4]
        all_img = list(train_img)
        ratio = 0.5
    train_num = len(train_img)

    all_time = [meta_json[i]["time_id"] for i in all_img]
    max_time = max(all_time) if all_time else 1
    all_time = [t / max_time if max_time > 0 else 0.0 for t in all_time]

    infos = []
    for idx, im in enumerate(all_img):
        cam = _nerfies_camera_from_json(
            os.path.join(path, "camera", im + ".json"), ratio)
        position = (cam["position"] - scene_center) * coord_scale
        # reference: R = orientation.T, T = -position @ orientation.T
        R = cam["orientation"].T
        T = -position @ R
        image_path = os.path.join(path, "rgb", f"{int(1 / ratio)}x",
                                  im + ".png")
        image = load_image(image_path)[..., :3]
        h, w = image.shape[:2]
        focal = cam["focal_length"]
        infos.append(CameraInfo(
            uid=idx, R=R, T=T,
            fovx=focal2fov(focal, w), fovy=focal2fov(focal, h),
            image=image.astype(np.float32), image_path=image_path,
            image_name=Path(image_path).stem, width=w, height=h,
            fid=all_time[idx]))
    return infos, train_num, scene_center, coord_scale


def read_nerfies_scene(path, eval_split=False, rng_seed=0):
    """Reference readNerfiesInfo (dataset_readers.py:476-509)."""
    infos, train_num, scene_center, coord_scale = read_nerfies_cameras(path)
    if eval_split:
        train, test = infos[:train_num], infos[train_num:]
    else:
        train, test = infos, []
    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        pts = np.load(os.path.join(path, "points.npy"))
        pts = (pts - scene_center) * coord_scale
        shs = np.random.default_rng(rng_seed).random((len(pts), 3)) / 255.0
        write_pointcloud_ply(ply_path, pts, sh2rgb(shs) * 255)
    return SceneData(_read_cloud(ply_path), train, test, norm, ply_path)


# ---------------------------------------------------------------------------
# DTU (cameras_sphere.npz, Tensor4D style)
# ---------------------------------------------------------------------------

def _decompose_projection(P):
    """K, c2w pose from a 3x4 projection (cv2.decomposeProjectionMatrix in
    the reference's dataset_readers.py:53-74): RQ decomposition with a
    positive-diagonal K."""
    import scipy.linalg
    M = P[:3, :3]
    K, R = scipy.linalg.rq(M)
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1
    K = K * signs[None, :]
    R = R * signs[:, None]
    t = np.linalg.solve(K, P[:3, 3])
    cam_center = -R.T @ t
    K = K / K[2, 2]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = cam_center
    return K, pose


def read_dtu_cameras(path, render_camera):
    """Reference readDTUCameras (dataset_readers.py:366-...): world_mat_i ·
    scale_mat_i projections from cameras_sphere.npz; images in image/."""
    camera_dict = np.load(os.path.join(path, render_camera))
    images_lis = sorted(
        os.path.join(path, "image", f) for f in
        os.listdir(os.path.join(path, "image")))
    n_images = len(images_lis)
    infos = []
    for idx in range(n_images):
        image_path = images_lis[idx]
        image = load_image(image_path)[..., :3]
        world_mat = camera_dict[f"world_mat_{idx}"].astype(np.float32)
        scale_mat = camera_dict[f"scale_mat_{idx}"].astype(np.float32)
        P = (world_mat @ scale_mat)[:3, :4]
        K, pose = _decompose_projection(P)
        R = pose[:3, :3]          # cam-to-world rotation
        T = -pose[:3, :3].T @ pose[:3, 3]
        h, w = image.shape[:2]
        infos.append(CameraInfo(
            uid=idx, R=R, T=T, fovx=focal2fov(K[0, 0], w),
            fovy=focal2fov(K[1, 1], h),
            image=image.astype(np.float32), image_path=image_path,
            image_name=Path(image_path).stem, width=w, height=h,
            fid=idx / max(n_images - 1, 1)))
    return infos


def read_dtu_scene(path, render_camera="cameras_sphere.npz",
                   object_camera="cameras_sphere.npz", rng_seed=0):
    train = read_dtu_cameras(path, render_camera)
    norm = get_nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        _write_random_cloud(ply_path, rng_seed)
    return SceneData(_read_cloud(ply_path), train, [], norm, ply_path)


# ---------------------------------------------------------------------------
# Plenoptic Video / Neu3D (poses_bounds.npy + frames/<cam>/<frame>.png)
# ---------------------------------------------------------------------------

def read_plenoptic_cameras(path, npy_file, split, hold_id, num_images):
    """Reference readCamerasFromNpy (dataset_readers.py:512-556)."""
    infos = []
    video_paths = sorted(glob.glob(os.path.join(path, "frames/*")))
    poses_bounds = np.load(os.path.join(path, npy_file))
    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    H, W, focal = poses[0, :, -1]
    n_cameras = poses.shape[0]
    poses = np.concatenate(
        [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
    bottoms = np.tile(np.array([0, 0, 0, 1.0]).reshape(1, 1, 4),
                      (poses.shape[0], 1, 1))
    poses = np.concatenate([poses, bottoms], axis=1)
    poses = poses @ np.diag([1, -1, -1, 1])

    i_test = np.array(hold_id)
    video_list = i_test if split != "train" else sorted(
        set(range(n_cameras)) - set(i_test))

    for i in video_list:
        video_path = video_paths[i]
        matrix = np.linalg.inv(np.array(poses[i]))
        R = np.transpose(matrix[:3, :3])
        T = matrix[:3, 3]
        image_names = sorted(os.listdir(video_path))[:num_images]
        for idx, image_name in enumerate(image_names):
            image_path = os.path.join(video_path, image_name)
            image = load_image(image_path)[..., :3]
            h, w = image.shape[:2]
            infos.append(CameraInfo(
                uid=idx, R=R, T=T,
                fovx=focal2fov(focal, w), fovy=focal2fov(focal, h),
                image=image.astype(np.float32), image_path=image_path,
                image_name=image_name, width=w, height=h,
                fid=idx / max(num_images - 1, 1)))
    return infos


def read_plenoptic_scene(path, eval_split=False, num_images=24,
                         hold_id=(0,), rng_seed=0):
    """Reference readPlenopticVideoDataset (dataset_readers.py:559-597)."""
    train = read_plenoptic_cameras(path, "poses_bounds.npy", "train",
                                   list(hold_id), num_images)
    test = read_plenoptic_cameras(path, "poses_bounds.npy", "test",
                                  list(hold_id), num_images)
    if not eval_split:
        train = train + test
        test = []
    norm = get_nerfpp_norm(train)
    ply_path = os.path.join(path, "points3D.ply")
    if not os.path.exists(ply_path):
        _write_random_cloud(ply_path, rng_seed)
    return SceneData(_read_cloud(ply_path), train, test, norm, ply_path)


def read_dynamic360_scene(path, rng_seed=0):
    """One transforms.json read by the Blender reader (the reference
    registers "dynamic360" in Scene but ships no callback)."""
    infos = read_cameras_from_transforms(path, "transforms.json", False)
    norm = get_nerfpp_norm(infos)
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        _write_random_cloud(ply_path, rng_seed)
    return SceneData(_read_cloud(ply_path), infos, [], norm, ply_path)


# the reference's sceneLoadTypeCallbacks (dataset_readers.py:599-605)
scene_load_type_callbacks = {
    "colmap": read_colmap_scene,
    "blender": read_nerf_synthetic,
    "dtu": read_dtu_scene,
    "nerfies": read_nerfies_scene,
    "plenoptic": read_plenoptic_scene,
    "dynamic360": read_dynamic360_scene,
}
