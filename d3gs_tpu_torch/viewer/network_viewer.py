"""SIBR-compatible network viewer endpoint (a copy of
`d3gs_tpu/viewer/network_viewer.py`; numpy and the socket module).

Wire-compatible re-implementation of the reference's socket viewer protocol
(gaussian_renderer/network_gui.py:27-91): a remote client (the SIBR viewer
or any test harness) connects over TCP, sends length-prefixed JSON camera
messages, and receives raw RGB bytes + a length-prefixed verify string.

Message fields (reference receive()): resolution_x/y, train, fov_x/y,
z_near/z_far, shs_python, rot_scale_python, keep_alive, scaling_modifier,
view_matrix (16 floats, row-major), view_projection_matrix (16 floats);
columns 1 and 2 of the view matrix (and column 1 of the VP matrix) are
sign-flipped on receipt, exactly as the reference does.
"""
from __future__ import annotations

import json
import socket
from typing import Callable, Optional

import numpy as np


class ViewerCamera:
    """Decoded client camera (reference MiniCam, scene/cameras.py:78-89)."""

    def __init__(self, width, height, fovx, fovy, znear, zfar,
                 world_view_transform, full_proj_transform):
        self.width = width
        self.height = height
        self.fovx = fovx
        self.fovy = fovy
        self.znear = znear
        self.zfar = zfar
        self.world_view_transform = world_view_transform
        self.full_proj_transform = full_proj_transform
        self.camera_center = np.linalg.inv(world_view_transform)[3, :3]


class NetworkViewer:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None
        self.port = self.listener.getsockname()[1]

    def try_connect(self):
        if self.conn is not None:
            return
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout):
            pass

    def _read_exact(self, nbytes: int) -> bytes:
        buf = b""
        while len(buf) < nbytes:
            chunk = self.conn.recv(nbytes - len(buf))
            if not chunk:
                raise ConnectionError("client closed")
            buf += chunk
        return buf

    def read_message(self) -> dict:
        length = int.from_bytes(self._read_exact(4), "little")
        return json.loads(self._read_exact(length).decode("utf-8"))

    def receive(self):
        """-> (ViewerCamera | None, do_training, shs_python,
        rot_scale_python, keep_alive, scaling_modifier)."""
        msg = self.read_message()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, None, None
        wvt = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wvt[:, 1] = -wvt[:, 1]
        wvt[:, 2] = -wvt[:, 2]
        vpt = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        vpt[:, 1] = -vpt[:, 1]
        cam = ViewerCamera(width, height, msg["fov_x"], msg["fov_y"],
                           msg["z_near"], msg["z_far"], wvt, vpt)
        return (cam, bool(msg["train"]), bool(msg["shs_python"]),
                bool(msg["rot_scale_python"]), bool(msg["keep_alive"]),
                msg["scaling_modifier"])

    def send(self, image_bytes: Optional[bytes], verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def disconnect(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def close(self):
        self.disconnect()
        self.listener.close()

    def serve_once(self, render_fn: Callable, verify: str) -> bool:
        """Handle one message if a client is connected. `render_fn(cam,
        scaling_modifier) -> (H, W, 3) float image or None`. Returns True if
        a message was handled."""
        self.try_connect()
        if self.conn is None:
            return False
        try:
            cam, do_train, _, _, keep_alive, scale_mod = self.receive()
            img_bytes = None
            if cam is not None:
                img = render_fn(cam, scale_mod)
                if img is not None:
                    arr = np.asarray(img)
                    img_bytes = memoryview(
                        (np.clip(arr, 0, 1) * 255).astype(np.uint8)).tobytes()
            self.send(img_bytes, verify)
            return True
        except Exception:
            self.disconnect()
            return False
