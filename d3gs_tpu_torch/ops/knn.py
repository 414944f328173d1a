"""k-nearest-neighbour mean squared distance for the Gaussian scale init
(counterpart of `d3gs_tpu/ops/knn.py`, the reference's simple-knn
`distCUDA2`): the mean squared distance from each point to its 3 nearest
other points.

Chunked brute force on the points' device: `torch.cdist` without the
matrix-product expansion (exact differences, no |a|² + |b|² − 2ab
cancellation), then the k smallest per row. Each chunk's distance tile is
bounded to chunk × N × 4 B ≤ 256 MB. The JAX package hands clouds above
150k points to a host C++ kNN; the port uses this version for every N.
"""
from __future__ import annotations

import torch


def _auto_chunk(n: int) -> int:
    return max(256, min(4096, (64 * 1024 * 1024) // max(n, 1)))


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3,
                     chunk: int = 0) -> torch.Tensor:
    """(N, 3) points -> (N,) mean squared distance to the k nearest other
    points (self excluded)."""
    n = points.shape[0]
    chunk = chunk or _auto_chunk(n)
    out = []
    for s in range(0, n, chunk):
        d = torch.cdist(points[s:s + chunk], points,
                        compute_mode="donot_use_mm_for_euclid_dist") ** 2
        rows = torch.arange(d.shape[0], device=points.device)
        d[rows, rows + s] = float("inf")
        out.append(d.topk(k, dim=1, largest=False).values.mean(dim=1))
    return torch.cat(out)


def knn_log_scales(points: torch.Tensor) -> torch.Tensor:
    """`create_from_pcd`'s scale init: (N, 3) log sqrt of the kNN mean
    squared distance (floored at 1e-7), the same on all three axes."""
    d2 = knn_mean_sq_dist(points).clamp_min(1e-7)
    return torch.log(torch.sqrt(d2))[:, None].expand(-1, 3).contiguous()
