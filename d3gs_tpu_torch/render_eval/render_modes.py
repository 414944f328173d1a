"""Offline rendering of splits (counterpart of
`d3gs_tpu/render_eval/render_modes.py`, `render` mode). The time, view,
pose, all and original modes are not ported yet (ROADMAP.md, Queue 1)."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..data.cameras import Camera
from ..data.image_io import write_png
from ..models.renderer import render


def to8b(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def make_render_fn(gaussians, field, pipe_cfg, *, is_6dof=False,
                   direct_compute=False):
    """-> render_at(state, field_or_None, camera, bg) -> RenderOutput, with
    the deformation at the camera's time."""
    @torch.no_grad()
    def render_at(state, field_, camera: Camera, bg):
        if field_ is not None:
            dx, dr, ds = field_.step(state.params.xyz, camera.fid)
        else:
            dx, dr, ds = 0.0, 0.0, 0.0
        return render(state, camera, d_xyz=dx, d_rotation=dr, d_scaling=ds,
                      is_6dof=is_6dof, direct_compute=direct_compute, bg=bg,
                      dup_capacity=pipe_cfg.dup_capacity,
                      antialias=pipe_cfg.antialias)

    return render_at


def camera_with_fid(cam: Camera, fid: float) -> Camera:
    return dataclasses.replace(cam, fid=float(fid))


def _dump(render_at, state, field, cam, bg, render_path, depth_path, i):
    out = render_at(state, field, cam, bg)
    img8 = to8b(out.image)
    write_png(os.path.join(render_path, f"{i:05d}.png"), img8)
    d = out.depth.detach().cpu().numpy()
    write_png(os.path.join(depth_path, f"{i:05d}.png"),
              to8b(d / (d.max() + 1e-5)))
    return img8


def render_split(model_path, name, iteration, views, state, field,
                 render_at, bg):
    """Per-view renders + depth + gt dump (render.py::render_set core)."""
    base = os.path.join(model_path, name, f"ours_{iteration}")
    render_path = os.path.join(base, "renders")
    gts_path = os.path.join(base, "gt")
    depth_path = os.path.join(base, "depth")
    for p in (render_path, gts_path, depth_path):
        os.makedirs(p, exist_ok=True)
    for i, view in enumerate(views):
        _dump(render_at, state, field, view, bg, render_path, depth_path, i)
        write_png(os.path.join(gts_path, f"{i:05d}.png"), to8b(view.image))
