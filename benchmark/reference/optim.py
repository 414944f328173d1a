"""Adam as the trainers run it (torch semantics: bias correction, eps
1e-15 outside the square root) and the learning-rate schedules of the
reference (utils/general_utils.py get_expon_lr_func; the deformation's
lr is position_lr_init x 5 decaying to position_lr_final over
deform_lr_max_steps, scene/deform_model.py)."""
from __future__ import annotations

import math

import torch

B1, B2, EPS = 0.9, 0.999, 1e-15


def expon_lr(step, lr_init, lr_final, delay_mult=1.0, max_steps=1_000_000,
             delay_steps=0):
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    if delay_steps > 0:
        delay = delay_mult + (1 - delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1 - t)
                            + math.log(lr_final) * t)


def gaussian_lrs(opt: dict, step: int, spatial_lr_scale: float) -> dict:
    return {
        "xyz": expon_lr(step, opt["position_lr_init"] * spatial_lr_scale,
                        opt["position_lr_final"] * spatial_lr_scale,
                        opt["position_lr_delay_mult"],
                        opt["position_lr_max_steps"]),
        "features_dc": opt["feature_lr"],
        "features_rest": opt["feature_lr"] / 20.0,
        "scaling": opt["scaling_lr"], "rotation": opt["rotation_lr"],
        "opacity": opt["opacity_lr"]}


def deform_lr(opt: dict, step: int, k: int) -> float:
    scale = k if opt.get("scale_lr", False) else 1
    return expon_lr(step, opt["position_lr_init"] * 5.0 * scale,
                    opt["position_lr_final"] * scale,
                    opt["position_lr_delay_mult"], opt["deform_lr_max_steps"])


class Adam:
    """Moments of a list of tensors; `step` updates them and returns the
    new tensors."""

    def __init__(self, params):
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    def step(self, params, grads, lrs):
        self.count += 1
        c1, c2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        out = []
        for i, (p, g, lr) in enumerate(zip(params, grads, lrs)):
            self.m[i] = B1 * self.m[i] + (1 - B1) * g
            self.v[i] = B2 * self.v[i] + (1 - B2) * g * g
            out.append(p - lr * (self.m[i] / c1)
                       / (torch.sqrt(self.v[i] / c2) + EPS))
        return out
