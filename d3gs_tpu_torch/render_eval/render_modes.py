"""Offline render modes (counterpart of `d3gs_tpu/render_eval/render_modes.py`,
the reference's render.py:30-442).

Modes: `render` (train/test splits), `time`, `view`, `pose`, `all` and
`original`. Each dumps renders/ and depth/ (and for `render` gt/) PNGs
through `data/image_io.py::write_png`, and the interpolation modes an mp4
through imageio where it imports and can write one (the card's machine has
no imageio: the export is skipped with a printed line, as JAX skips it
without a codec). A mode's cameras come from its `*_cameras` function: the
poses are computed in numpy on the float32 matrices exactly as JAX computes
them, with the reference's znear 0.01 / zfar 100.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..data.cameras import ZFAR, ZNEAR, Camera
from ..data.image_io import write_png
from ..models.renderer import render
from ..ops.camera_math import perspective_projection, world_to_view
from .pose_paths import pose_spherical, pose_to_blender_rt, wander_path


def to8b(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def _save_video(path: str, frames: list[np.ndarray], fps: int = 30):
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(path, np.stack(frames, 0), fps=fps, quality=8)
    except Exception as e:  # no imageio, or no codec
        print(f"[render] video export skipped ({e})")


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


def _with_viewmatrix(cam: Camera, vm: np.ndarray) -> Camera:
    """`cam` seen through the float32 row-vector world→view matrix vm."""
    P = perspective_projection(ZNEAR, ZFAR, cam.fovx, cam.fovy).T
    as_t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=cam.device)
    return dataclasses.replace(cam, viewmatrix=as_t(vm),
                               projmatrix=as_t(vm @ P),
                               campos=as_t(np.linalg.inv(vm)[3, :3]))


def camera_with_pose(cam: Camera, R: np.ndarray, T: np.ndarray) -> Camera:
    """Re-pose a camera (the reference's reset_extrinsic)."""
    return _with_viewmatrix(cam, world_to_view(R, T).T)


def reference_rt(view: Camera):
    """(R, T) of a view, from its viewmatrix as JAX's render.py:72-79
    derives the wander path's reference pose."""
    Vt = view.viewmatrix.cpu().numpy().T
    return Vt[:3, :3].T, Vt[:3, 3]


def _lerp_viewmatrix(v0: Camera, v1: Camera, a: float) -> np.ndarray:
    return ((1 - a) * v0.viewmatrix.cpu().numpy()
            + a * v1.viewmatrix.cpu().numpy())


def time_cameras(view: Camera, frames: int = 150) -> list[Camera]:
    """One view with time sweeping over [0, 1]."""
    return [camera_with_fid(view, t / (frames - 1)) for t in range(frames)]


def view_cameras(view: Camera, R: np.ndarray, T: np.ndarray) -> list[Camera]:
    """`wander_path`'s 60 poses around (R, T), at the view's time."""
    return [camera_with_pose(view, *pose_to_blender_rt(pose))
            for pose in wander_path(R, T, view.fovy, view.height)]


def all_cameras(view: Camera, frames: int = 150) -> list[Camera]:
    """A spherical orbit with time sweeping (render.py:256-295)."""
    cams = []
    for i in range(frames):
        pose = pose_spherical(-180 + 360 * i / frames, -30.0, 4.0)
        cams.append(camera_with_fid(
            camera_with_pose(view, *pose_to_blender_rt(pose)),
            i / (frames - 1)))
    return cams


def pose_cameras(v0: Camera, v1: Camera, frames: int = 150,
                 fid: float = 0.0) -> list[Camera]:
    """A lerp between two real poses at a fixed time (render.py:298-340)."""
    return [_with_viewmatrix(camera_with_fid(v0, fid),
                             _lerp_viewmatrix(v0, v1, i / (frames - 1)))
            for i in range(frames)]


def original_cameras(views: list[Camera], frames: int = 150) -> list[Camera]:
    """Piecewise-lerped real poses with time sweeping (render.py:343-396)."""
    cams = []
    n_seg = max(len(views) - 1, 1)
    for i in range(frames):
        t = i / max(frames - 1, 1)
        seg = min(int(t * n_seg), n_seg - 1)
        a = t * n_seg - seg
        v0, v1 = views[seg], views[min(seg + 1, len(views) - 1)]
        cams.append(_with_viewmatrix(camera_with_fid(v0, t),
                                     _lerp_viewmatrix(v0, v1, a)))
    return cams


def _dump(render_at, state, field, cam, bg, render_path, depth_path, i):
    out = render_at(state, field, cam, bg)
    img8 = to8b(out.image)
    write_png(os.path.join(render_path, f"{i:05d}.png"), img8)
    d = out.depth.detach().cpu().numpy()
    write_png(os.path.join(depth_path, f"{i:05d}.png"),
              to8b(d / (d.max() + 1e-5)))
    return img8


def _dump_frames(base, cams, state, field, render_at, bg) -> int:
    """renders/, depth/ and video.mp4 of `cams` under `base` -> frames."""
    render_path = os.path.join(base, "renders")
    depth_path = os.path.join(base, "depth")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(depth_path, exist_ok=True)
    imgs = [_dump(render_at, state, field, cam, bg, render_path, depth_path,
                  i) for i, cam in enumerate(cams)]
    _save_video(os.path.join(render_path, "video.mp4"), imgs)
    return len(imgs)


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


def interpolate_time(model_path, name, iteration, views, state, field,
                     render_at, bg, frames=150, view_idx=0) -> int:
    return _dump_frames(
        os.path.join(model_path, name, f"interpolate_{iteration}"),
        time_cameras(views[view_idx], frames), state, field, render_at, bg)


def interpolate_view(model_path, name, iteration, views, state, field,
                     render_at, bg, R, T, view_idx=0) -> int:
    return _dump_frames(
        os.path.join(model_path, name, f"interpolate_view_{iteration}"),
        view_cameras(views[view_idx], R, T), state, field, render_at, bg)


def interpolate_all(model_path, name, iteration, views, state, field,
                    render_at, bg, frames=150, view_idx=0) -> int:
    return _dump_frames(
        os.path.join(model_path, name, f"interpolate_all_{iteration}"),
        all_cameras(views[view_idx], frames), state, field, render_at, bg)


def interpolate_poses(model_path, name, iteration, views, state, field,
                      render_at, bg, frames=150, fid: float = 0.0) -> int:
    return _dump_frames(
        os.path.join(model_path, name, f"interpolate_pose_{iteration}"),
        pose_cameras(views[0], views[-1], frames, fid), state, field,
        render_at, bg)


def interpolate_view_original(model_path, name, iteration, views, state,
                              field, render_at, bg, frames=150) -> int:
    return _dump_frames(
        os.path.join(model_path, name, f"interpolate_hyper_view_{iteration}"),
        original_cameras(views, frames), state, field, render_at, bg)
