"""Quaternion helpers and the SE(3) exponential, batched over leading axes
(counterpart of `d3gs_tpu/ops/transforms.py`). Quaternions are (w, x, y,
z)."""
from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions along the last axis."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(eps)


def quat_to_rotmat_cols(q: torch.Tensor):
    """(..., 4) wxyz quaternion -> the 9 rotation entries r00..r22, each
    (...,), row-major (reference build_rotation layout)."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


# ---------------------------------------------------------------------------
# SE(3) / SO(3) exponential maps (Modern Robotics eqns 3.51 / 3.88), for the
# 6DoF deformation head (reference utils/rigid_utils.py:40-86)
# ---------------------------------------------------------------------------

def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    zeros = torch.zeros_like(w[..., 0])
    row0 = torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1)
    row1 = torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1)
    row2 = torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def exp_so3(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis, (...,) angle -> (..., 3, 3) rotation."""
    W = skew(w)
    th = theta[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + torch.sin(th) * W + (1.0 - torch.cos(th)) * (W @ W)


def exp_se3(S: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Screw-axis exponential: (..., 6) screw, (...,) angle -> (..., 4, 4)."""
    w, v = S[..., :3], S[..., 3:]
    W = skew(w)
    W2 = W @ W
    R = exp_so3(w, theta)
    th = theta[..., None, None]
    eye = torch.eye(3, dtype=S.dtype, device=S.device).expand(W.shape)
    G = th * eye + (1.0 - torch.cos(th)) * W + (th - torch.sin(th)) * W2
    p = (G @ v[..., None])[..., 0]
    top = torch.cat([R, p[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=S.dtype,
                          device=S.device).expand(top[..., :1, :].shape)
    return torch.cat([top, bottom], dim=-2)


def to_homogeneous(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


def from_homogeneous(v: torch.Tensor) -> torch.Tensor:
    return v[..., :3] / v[..., -1:]


def apply_se3(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transforms applied to (..., 3) points -> (..., 3)."""
    return from_homogeneous((T @ to_homogeneous(x)[..., None])[..., 0])
