"""Scene, cameras and weights of a cell, made on the device from the seed.

The layout is that of the port's bench scene (`d3gs_tpu_torch/bench.py`
`bench_scene` / `bench_cameras`, itself the root bench.py's): points
uniform in [-1.3, 1.3]^3, uniform colours as the DC band, scales from the
mean squared distance to the 3 nearest neighbours, identity rotations,
opacity logit 0.5, all SH bands active. Rewritten here so that the
yardstick stays fixed: it draws from a `torch.Generator` on the device in a
few large calls, computes its own kNN, and imports nothing of the program.

The cameras stand on a sphere around the scene and look at its centre
(OpenCV axes: x right, y down, z forward; the world's up is +z). Their
poses are the same for every seed: a seed changes the scene, the weights
and the order in which the loops visit the poses, not the set of poses.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814
ZNEAR, ZFAR = 0.01, 100.0
PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity")


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded with `seed` (any whole number)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def capacity_for(n: int) -> int:
    """The trainers' padded buffer for n Gaussians: a multiple of 1024."""
    return max(1024, -(-n // 1024) * 1024)


def knn_log_scales(points: torch.Tensor, k: int = 3,
                   chunk: int = 1024) -> torch.Tensor:
    """(N,) log sqrt of the mean squared distance to the k nearest other
    points, floored at 1e-7 (the reference's `distCUDA2` scale init), by
    exact differences in chunks of rows."""
    n = points.shape[0]
    out = []
    for s in range(0, n, chunk):
        a = points[s:s + chunk]
        d = sum((a[:, None, j] - points[None, :, j]) ** 2 for j in range(3))
        rows = torch.arange(d.shape[0], device=points.device)
        d[rows, rows + s] = float("inf")
        out.append(d.topk(k, dim=1, largest=False).values.mean(dim=1))
    return torch.log(torch.sqrt(torch.cat(out).clamp_min(1e-7)))


def gaussians(n: int, capacity: int, sh_degree: int, gen: torch.Generator,
              device) -> tuple[dict, torch.Tensor]:
    """The teacher's Gaussians: the six parameters (pre-activation, as the
    trainers store them) in a `capacity` buffer, and the alive mask. Rows
    past n are dead: identity rotations, zeros elsewhere, opacity logit of
    0.1."""
    k = (sh_degree + 1) ** 2
    u = torch.rand((n, 6), generator=gen, device=device)
    pts = u[:, :3] * 2.6 - 1.3
    rgb = u[:, 3:]
    p = {
        "xyz": torch.zeros((capacity, 3), device=device),
        "features_dc": torch.zeros((capacity, 1, 3), device=device),
        "features_rest": torch.zeros((capacity, k - 1, 3), device=device),
        "scaling": torch.zeros((capacity, 3), device=device),
        "rotation": torch.zeros((capacity, 4), device=device),
        "opacity": torch.full((capacity, 1), math.log(0.1 / 0.9),
                              device=device),
    }
    p["xyz"][:n] = pts
    p["features_dc"][:n, 0] = (rgb - 0.5) / SH_C0
    p["scaling"][:n] = knn_log_scales(pts)[:, None]
    p["rotation"][:, 0] = 1.0
    p["opacity"][:n] = 0.5
    alive = torch.arange(capacity, device=device) < n
    return p, alive


def perturb(params: dict, alive: torch.Tensor, gen: torch.Generator,
            colour_sd: float, opacity_sd: float) -> dict:
    """The student: the teacher with its DC colours and opacity logits
    moved by normals of the given spreads (alive rows only)."""
    n = params["xyz"].shape[0]
    z = torch.randn((n, 4), generator=gen, device=alive.device)
    z = z * alive[:, None].to(z.dtype)
    out = {k: v.clone() for k, v in params.items()}
    out["features_dc"][:, 0] += colour_sd * z[:, :3]
    out["opacity"][:, 0] += opacity_sd * z[:, 3]
    return out


def linear_weights(shapes: list[tuple[int, int]], gen: torch.Generator,
                   device, last: int = 0, last_scale: float = 1.0
                   ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(weight (out, in), bias (out,)) per layer, each entry uniform in
    ±1/sqrt(in) (nn.Linear's default init), the `last` layers' in
    ±last_scale/sqrt(in), from one draw."""
    sizes = [o * i + o for i, o in shapes]
    u = torch.rand((sum(sizes),), generator=gen, device=device) * 2.0 - 1.0
    out, at = [], 0
    for j, ((i, o), size) in enumerate(zip(shapes, sizes)):
        scale = last_scale if j >= len(shapes) - last else 1.0
        chunk = u[at:at + size] * (scale * i ** -0.5)
        out.append((chunk[:o * i].reshape(o, i).contiguous(),
                    chunk[o * i:].contiguous()))
        at += size
    return out


class View(NamedTuple):
    """One camera: row-vector world->view and full projection matrices,
    its centre, the time it sees, and its image size and FoVs."""
    viewmatrix: torch.Tensor   # (4, 4), points transform as x_row @ M
    projmatrix: torch.Tensor   # (4, 4), view @ projection
    campos: torch.Tensor       # (3,)
    fid: float
    width: int
    height: int
    fovx: float
    fovy: float


def projection(fovx: float, fovy: float) -> np.ndarray:
    """The reference's perspective matrix (utils/graphics_utils.py
    getProjectionMatrix, symmetric frustum), column-vector convention."""
    top, right = math.tan(fovy / 2) * ZNEAR, math.tan(fovx / 2) * ZNEAR
    P = np.zeros((4, 4))
    P[0, 0] = ZNEAR / right
    P[1, 1] = ZNEAR / top
    P[3, 2] = 1.0
    P[2, 2] = ZFAR / (ZFAR - ZNEAR)
    P[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    return P


def look_at(position, fid: float, width: int, height: int, fovx: float,
            device) -> View:
    """A camera at `position` looking at the origin."""
    pos = np.asarray(position, np.float64)
    z = -pos / np.linalg.norm(pos)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    w2c = np.eye(4)
    w2c[:3, :3] = np.stack([x, y, z])
    w2c[:3, 3] = -w2c[:3, :3] @ pos
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    V = w2c.T
    full = V @ projection(fovx, fovy).T
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                    device=device)
    return View(f32(V), f32(full), f32(pos), float(fid), width, height,
                float(fovx), float(fovy))


def sphere_pose(i: int, count: int, radius: float) -> np.ndarray:
    """Pose i of `count` on a golden-angle spiral over the band of
    elevations 10-60 degrees (the Blender sets' upper hemisphere)."""
    elev = math.radians(10.0 + 50.0 * (i + 0.5) / count)
    azim = i * math.pi * (3.0 - math.sqrt(5.0))
    return radius * np.array([math.cos(elev) * math.cos(azim),
                              math.cos(elev) * math.sin(azim),
                              math.sin(elev)])


def train_views(count: int, radius: float, size: int, fovx: float,
                device) -> list[View]:
    """The training cameras, sorted by time: view i sees t = i / (count -
    1) from `sphere_pose(i)`."""
    return [look_at(sphere_pose(i, count, radius), i / max(count - 1, 1),
                    size, size, fovx, device) for i in range(count)]


def orbit_view(i: int, period: int, radius: float, elevation_deg: float,
               size: int, fovx: float, device) -> View:
    """Frame i of the viewer's orbit: one turn and t from 0 to 1 every
    `period` frames."""
    j = i % period
    azim = 2 * math.pi * j / period
    elev = math.radians(elevation_deg)
    pos = radius * np.array([math.cos(elev) * math.cos(azim),
                             math.cos(elev) * math.sin(azim),
                             math.sin(elev)])
    return look_at(pos, j / max(period - 1, 1), size, size, fovx, device)
