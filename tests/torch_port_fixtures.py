"""Shared inputs for the torch-port parity tests (tests/test_torch_port_*.py).

Every input is made with numpy from a seed and handed to both packages as
numpy arrays. The three blend scenes are those of tests/test_pallas_blend.py:
a random scene, a saturated tile (64 near-opaque Gaussians stacked in depth
on tile (0, 0)) and the same stack under a 48-duplicate budget.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.models import gaussians as G
from d3gs_tpu.ops.camera_math import perspective_projection, world_to_view
from d3gs_tpu.ops.projection import project_gaussians
from d3gs_tpu.ops.transforms import cov3d_packed

W = H = 64
TX = TY = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread for the module's tests (autouse where a
    test module imports it). Their tensors are small, and tier-1 runs six
    pytest workers on the same cores: with PyTorch's default of a thread
    per core the workers oversubscribe the CPU, and the JAX tests beside
    them slow down with the port's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
FOV = math.radians(60)


def camera_mats(z: float):
    """Row-vector (view, view·proj) for a camera at (0, 0, -z) looking +z."""
    V = world_to_view(np.eye(3), np.array([0, 0, z])).T
    P = perspective_projection(0.01, 100.0, FOV, FOV).T
    return V.astype(np.float32), (V @ P).astype(np.float32)


def _project(state, colors, z):
    V, VP = camera_mats(z)
    tan = math.tan(FOV / 2)
    cov = cov3d_packed(state.get_scaling, state.params.rotation)
    return project_gaussians(
        state.params.xyz, cov, state.get_opacity[:, 0], jnp.asarray(colors),
        jnp.asarray(V), jnp.asarray(VP), tan, tan, W, H, alive=state.alive)


def random_scene_splats():
    """JAX ProjectedSplats of test_pallas_blend.py's `scene` fixture."""
    n, cap = 300, 512
    rng = np.random.default_rng(3)
    pts = (rng.random((n, 3)) * 2.0 - 1.0).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    state = G.create_from_pcd(pts, cols, sh_degree=1, capacity=cap)
    state = state.replace(params=state.params._replace(
        opacity=jnp.asarray(rng.uniform(-1, 3, (cap, 1)), jnp.float32)))
    return _project(state, rng.uniform(0, 1, (cap, 3)).astype(np.float32), 3.0)


def saturated_splats():
    """64 near-opaque Gaussians centred on tile (0, 0), distinct depths."""
    n, cap = 64, 128
    xyz = np.stack([np.zeros(n), np.zeros(n), np.linspace(2.0, 3.0, n)],
                   axis=1).astype(np.float32)
    state = G.create_from_pcd(xyz, np.full((n, 3), 0.5, np.float32),
                              sh_degree=0, capacity=cap)
    state = state.replace(params=state.params._replace(
        opacity=jnp.full((cap, 1), 8.0), scaling=jnp.full((cap, 3), -3.0)))
    return _project(state, np.full((cap, 3), 0.7, np.float32), 4.0)


# (name, splats factory, dup_capacity, bg). The budget rounds up to a
# multiple of 512, so test_pallas_blend.py's 48-duplicate case keeps all 256
# duplicates of the stack; the random scene under a 512 budget really drops
# its deepest Gaussians' duplicates.
BLEND_CASES = [
    ("random", random_scene_splats, 0, (0.1, 0.2, 0.3)),
    ("saturated", saturated_splats, 0, (0.0, 0.0, 0.0)),
    ("overflow48", saturated_splats, 48, (0.0, 0.0, 0.0)),
    ("random_budget512", random_scene_splats, 512, (0.1, 0.2, 0.3)),
]


def to_numpy(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def splats_to_torch(splats):
    from d3gs_tpu_torch.ops.projection import ProjectedSplats
    return ProjectedSplats(**{k: torch.from_numpy(v.copy())
                              for k, v in to_numpy(splats).items()})


def bins_to_torch(bins):
    from d3gs_tpu_torch.ops.binning import RecordBins
    return RecordBins(**{k: torch.from_numpy(v.astype(np.int32))
                         for k, v in to_numpy(bins).items()})
