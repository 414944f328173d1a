"""Camera matrix construction (world→view, perspective projection, FoV).

Numpy copy of `d3gs_tpu/ops/camera_math.py`, same conventions as the
reference (utils/graphics_utils.py:34-84, scene/cameras.py:55-61):
  * `world_to_view(R, t)`: R is the COLMAP cam-to-world rotation (transposed
    inside), t the world-to-cam translation; optional recentering translate
    and uniform scale applied to the camera center.
  * callers store the matrices ROW-VECTOR convention (transposed), i.e.
    points transform as x_row @ M.
"""
from __future__ import annotations

import math

import numpy as np


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world→view matrix (column-vector convention, not yet transposed)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        tr = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + tr) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def perspective_projection(znear: float, zfar: float, fovx: float,
                           fovy: float) -> np.ndarray:
    """4x4 perspective projection (column-vector convention), with the
    reference's depth mapping (utils/graphics_utils.py:56-77)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))
