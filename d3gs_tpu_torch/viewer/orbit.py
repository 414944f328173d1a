"""Orbit camera for interactive viewing (a copy of
`d3gs_tpu/viewer/orbit.py`, the reference utils/gui_utils.py:65-151).

Pure numpy/scipy; produces reference-convention matrices that feed straight
into a `Camera`/`MiniCam` for rendering (the reference GUI's custom
GL-convention projection, train_gui.py:41-54, is reproduced by `mvp`).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R


class OrbitCamera:
    def __init__(self, width, height, r=2.0, fovy_deg=60.0, near=0.01,
                 far=100.0):
        self.W = width
        self.H = height
        self.radius = r
        self.fovy = np.deg2rad(fovy_deg)
        self.near = near
        self.far = far
        self.center = np.zeros(3, dtype=np.float32)
        self.rot = R.from_matrix(np.array([[1.0, 0.0, 0.0],
                                           [0.0, 0.0, -1.0],
                                           [0.0, 1.0, 0.0]]))

    @property
    def fovx(self):
        return 2 * np.arctan(np.tan(self.fovy / 2) * self.W / self.H)

    @property
    def pose(self):
        res = np.eye(4, dtype=np.float32)
        res[2, 3] = self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot.as_matrix()
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    @property
    def campos(self):
        return self.pose[:3, 3]

    @property
    def view(self):
        return np.linalg.inv(self.pose)

    @property
    def perspective(self):
        y = np.tan(self.fovy / 2)
        aspect = self.W / self.H
        return np.array([
            [1 / (y * aspect), 0, 0, 0],
            [0, -1 / y, 0, 0],
            [0, 0, -(self.far + self.near) / (self.far - self.near),
             -(2 * self.far * self.near) / (self.far - self.near)],
            [0, 0, -1, 0]], dtype=np.float32)

    @property
    def mvp(self):
        return self.perspective @ np.linalg.inv(self.pose)

    def orbit(self, dx, dy):
        side = self.rot.as_matrix()[:3, 0]
        up = self.rot.as_matrix()[:3, 1]
        rotvec_x = up * np.radians(-0.05 * dx)
        rotvec_y = side * np.radians(-0.05 * dy)
        self.rot = R.from_rotvec(rotvec_x) * R.from_rotvec(rotvec_y) * self.rot

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0.0):
        self.center += 0.0001 * self.rot.as_matrix()[:3, :3] @ \
            np.array([-dx, -dy, dz])
