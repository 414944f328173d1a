"""Annealing smooth training (AST; Yang et al. 2024, arXiv:2309.13101,
github.com/ingra14m/Deformable-3D-Gaussians train.py, kept by the fork as
train_baseline.py:112-115): for a scene that is not Blender's, the
deformation field of a training step sees

    t = fid + N(0, 1) * time_interval * noise(iteration)
    noise(i) = 0.1 (1 - s) + 1e-15 s,  s = min(i / 20000, 1)

with time_interval one over the number of training frames. Evaluation
sees fid.

Departures from the published code, each as the port's trainers run it:
one draw a step from a generator on the host seeded from the run's seed,
`torch.Generator().manual_seed(seed mod 2^63)`, in step order, where the
published code draws a (1, 1) normal on the card; the time reaches the
field as a float32 column of the host's float64 sum.

`jittered` gives the reference the times of a run's steps, drawn from its
own generator in the program's order: one draw per step, none for a
Blender scene.
"""
from __future__ import annotations

import torch

LR_INIT, LR_FINAL, MAX_STEPS = 0.1, 1e-15, 20000


def noise(iteration) -> float:
    """The annealed noise scale at `iteration`."""
    s = min(max(float(iteration) / MAX_STEPS, 0.0), 1.0)
    return LR_INIT * (1 - s) + LR_FINAL * s


def jittered(fids, iteration0: int, seed: int, time_interval: float,
             is_blender: bool) -> list[float]:
    """The times the field sees in the steps from `iteration0`, one a step
    with the step's frame time in `fids`."""
    if is_blender:
        return [float(f) for f in fids]
    gen = torch.Generator().manual_seed(int(seed) % 2 ** 63)
    return [f + float(torch.randn((), generator=gen)) * time_interval
            * noise(iteration0 + i) for i, f in enumerate(fids)]
