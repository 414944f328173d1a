"""Camera structures: host-side CameraInfo and a Camera of tensors
(counterpart of `d3gs_tpu/data/cameras.py`). Matrix conventions are the
reference's (row-vector transforms, znear=0.01, zfar=100)."""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.camera_math import perspective_projection, world_to_view
from .resize import resize

ZNEAR = 0.01
ZFAR = 100.0


class CameraInfo(NamedTuple):
    """Host-side record straight out of a dataset reader
    (reference scene/dataset_readers.py:31-43)."""
    uid: int
    R: np.ndarray            # (3,3) cam-to-world rotation (COLMAP convention)
    T: np.ndarray            # (3,) world-to-cam translation
    fovx: float
    fovy: float
    image: np.ndarray        # (H, W, 3) float32 in [0,1], alpha pre-composited
    image_path: str
    image_name: str
    width: int
    height: int
    fid: float               # normalized frame time in [0, 1]
    mask: Optional[np.ndarray] = None   # (H, W, 1) alpha, if present
    depth: Optional[np.ndarray] = None


@dataclasses.dataclass
class Camera:
    viewmatrix: torch.Tensor     # (4,4) row-vector world→view
    projmatrix: torch.Tensor     # (4,4) row-vector full (view·proj)
    campos: torch.Tensor         # (3,)
    fid: float                   # frame time in [0, 1]
    image: torch.Tensor          # (H, W, 3) ground truth
    width: int
    height: int
    fovx: float
    fovy: float
    image_name: str = ""
    uid: int = 0

    @property
    def device(self) -> torch.device:
        return self.viewmatrix.device

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx / 2)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy / 2)


def camera_from_matrices(V: np.ndarray, fovx: float, fovy: float, *,
                         fid: float, image: np.ndarray,
                         device: str | torch.device, image_name: str = "",
                         uid: int = 0) -> Camera:
    """Camera from a row-vector world→view matrix V and the FoVs."""
    P = perspective_projection(ZNEAR, ZFAR, fovx, fovy).T
    full = (V @ P).astype(np.float32)
    campos = np.linalg.inv(V)[3, :3].astype(np.float32)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                     device=device)
    return Camera(viewmatrix=as_t(V), projmatrix=as_t(full),
                  campos=as_t(campos), fid=float(fid), image=as_t(image),
                  width=image.shape[1], height=image.shape[0],
                  fovx=float(fovx), fovy=float(fovy),
                  image_name=image_name, uid=uid)


def camera_from_info(info: CameraInfo, *, device: str | torch.device,
                     trans=None, scale: float = 1.0,
                     resolution_scale: float = 1.0,
                     resolution: int = -1) -> Camera:
    """Device Camera under the reference's resolution policy
    (utils/camera_utils.py:21-57: -1 => 1.6k-width clamp; 1/2/4/8 =>
    divisors; other positive => target width). A resize goes through
    `data/resize.py`, equal to the PIL `Image.resize(res)` that the JAX
    package calls: the image truncated to uint8, resampled bicubic, / 255."""
    orig_w, orig_h = info.width, info.height
    if resolution in (1, 2, 4, 8):
        res = (round(orig_w / (resolution_scale * resolution)),
               round(orig_h / (resolution_scale * resolution)))
    else:
        if resolution == -1:
            global_down = orig_w / 1600 if orig_w > 1600 else 1
        else:
            global_down = orig_w / resolution
        s = float(global_down) * float(resolution_scale)
        res = (int(orig_w / s), int(orig_h / s))
    image = info.image
    if (res[0], res[1]) != (orig_w, orig_h):
        arr8 = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        image = resize(arr8, res).astype(np.float32) / 255.0
    V = world_to_view(info.R, info.T, translate=trans, scale=scale).T
    return camera_from_matrices(V, info.fovx, info.fovy, fid=info.fid,
                                image=image, device=device,
                                image_name=info.image_name, uid=info.uid)
