"""Novel-view camera paths (spherical orbit, wander) for offline rendering.

Numpy copy of `d3gs_tpu/render_eval/pose_paths.py` (the reference's
utils/pose_utils.py:59-99): `pose_spherical` produces the blender-convention
orbit c2w used by interpolate_all; `wander_path` the forward-facing spiral
used by interpolate_view.
"""
from __future__ import annotations

import math

import numpy as np

from ..ops.camera_math import fov2focal


def _trans_t(t):
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi):
    m = np.eye(4, dtype=np.float32)
    m[1, 1] = m[2, 2] = math.cos(phi)
    m[1, 2] = -math.sin(phi)
    m[2, 1] = math.sin(phi)
    return m


def _rot_theta(th):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[2, 2] = math.cos(th)
    m[0, 2] = -math.sin(th)
    m[2, 0] = math.sin(th)
    return m


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Orbit c2w (blender convention), pose_utils.py:59-64."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi_deg / 180.0 * math.pi) @ c2w
    c2w = _rot_theta(theta_deg / 180.0 * math.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    dtype=np.float32)
    return flip @ c2w


def wander_path(R: np.ndarray, T: np.ndarray, fovy: float, height: int,
                num_frames: int = 60, max_disp: float = 5000.0) -> list[np.ndarray]:
    """Forward-facing spiral around a reference pose (pose_utils.py:67-99).
    Returns c2w-style 4x4 render poses."""
    focal = fov2focal(fovy, height)
    Rm = R.copy()
    Rm[:, 1] = -Rm[:, 1]
    Rm[:, 2] = -Rm[:, 2]
    pose = np.concatenate([Rm, -T.reshape(3, 1)], axis=-1)
    ref_pose = np.concatenate(
        [pose, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
    max_trans = max_disp / focal
    out = []
    for i in range(num_frames):
        x = max_trans * math.sin(2 * math.pi * i / num_frames)
        y = max_trans * math.cos(2 * math.pi * i / num_frames) / 3.0
        z = max_trans * math.cos(2 * math.pi * i / num_frames) / 3.0
        i_pose = np.eye(4)
        i_pose[:3, 3] = [x, y, z]
        out.append(ref_pose @ np.linalg.inv(i_pose))
    return out


def pose_to_blender_rt(pose: np.ndarray):
    """c2w pose -> (R, T) with the D-NeRF flip applied (render.py:232-236)."""
    matrix = np.linalg.inv(np.asarray(pose))
    R = -matrix[:3, :3].T
    R[:, 0] = -R[:, 0]
    T = -matrix[:3, 3]
    return R, T
