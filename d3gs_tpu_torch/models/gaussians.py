"""Explicit 3D-Gaussian state for rendering (counterpart of
`d3gs_tpu/models/gaussians.py`).

The padded capacity and the `alive` mask of the JAX state are kept, so a
state carried across from JAX compares one to one. Parameters are the
reference's pre-activation storage:
  xyz (C,3) · features_dc (C,1,3) · features_rest (C,K-1,3) ·
  scaling (C,3, log) · rotation (C,4, unnormalized wxyz) · opacity (C,1, logit)
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.transforms import quat_normalize

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity")


class GaussianParams(NamedTuple):
    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor


@dataclasses.dataclass
class GaussianState:
    params: GaussianParams
    alive: torch.Tensor            # (C,) bool
    active_sh_degree: int
    max_sh_degree: int

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.params.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        return quat_normalize(self.params.rotation)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity)

    @property
    def get_features(self) -> torch.Tensor:
        return torch.cat([self.params.features_dc,
                          self.params.features_rest], dim=1)


def round_capacity(n: int) -> int:
    """The JAX package's padded buffer size for n Gaussians."""
    return max(1024, int(np.ceil(n / 1024)) * 1024)


def gaussians_from_numpy(params: dict[str, np.ndarray], alive: np.ndarray,
                         active_sh_degree: int, max_sh_degree: int,
                         device: str | torch.device) -> GaussianState:
    """Carry a (JAX or file) state across: numpy arrays keyed by the six
    parameter names, the alive mask, and the SH degrees."""
    return GaussianState(
        params=GaussianParams(**{
            k: torch.as_tensor(np.asarray(params[k], np.float32),
                               device=device) for k in PARAM_NAMES}),
        alive=torch.as_tensor(np.asarray(alive, bool), device=device),
        active_sh_degree=int(active_sh_degree),
        max_sh_degree=int(max_sh_degree))
