"""Benchmark of the port at the reference's headline configuration (D-NeRF
400x400, 43,132 Gaussians: the reference README's average count,
BASELINE.md), the counterpart of the root `bench.py`:

    python -m d3gs_tpu_torch.bench [--device cuda]

Three numbers, each from CUDA events around back-to-back calls after a
warm-up run, two loop lengths differenced to cancel the fixed cost, the
better of two runs per length kept:

  * a full train step (deform MLP forward, SH + EWA projection, binning,
    the blend kernels forward and backward, L1 + D-SSIM, the backward to
    the Gaussians, the deform net and the screen-space tap, both Adams):
    3 / 23 steps;
  * render only (the deform MLP, projection, binning, the forward blend):
    4 / 44 frames;
  * the flagship step at k = 10 (the baseline MLP kind of `pick_field_spec`
    at the defaults), per camera: 2 / 8 steps.

Every step starts from bench.py's initial state: the Gaussians (the steps
return new tensors), zero Adam moments and the MLP's initial weights, which
its Adam updates in place and one `_foreach_copy_` of its 26 tensors (2.1
MB) restores after each step. So every step does the same work. A loop that
carries its state is not steady on this scene: fitted to a random target,
the first Adam steps grow the splats and M, the duplicates of a frame, goes
from 407,301 to 1.08 M after one train step and to 7.0 M after five (the
H100, chip_smoke.py phase 4o); bench.py's fixed budget truncated that
growth without a word.

Nothing reads the card inside a loop beyond what the step does itself (the
binning's one read of its duplicate total). The binning truncates at the
duplicate budget without a word, so the bench checks M against it: the
bench frame and the ten flagship frames before the loops, and the largest
M of the train and render loops after them. Prints
ONE JSON line with the root bench.py's keys, plus `device`, `power_limit`
(`nvidia-smi --query-gpu=name,power.limit`) and `dup_total` (the bench
frame's M). Any failure prints bench.py's error line instead and exits
non-zero, as does the 2,400 s watchdog.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import traceback
from typing import NamedTuple

import numpy as np
import torch

from . import config as C
from . import resolve_device
from .data.cameras import Camera, camera_from_matrices
from .models import gaussians as G
from .models.deform.fields import (DeformField, DeformFieldSpec,
                                   create_deform_field)
from .models.renderer import render
from .ops.camera_math import world_to_view
from .train.flagship import make_batched_step, pick_field_spec
from .tools.timing import time_ms
from .train.step import make_train_step

WIDTH = HEIGHT = 400
N = 43_132                       # the reference's average Gaussian count
CAP = 44_032                     # padded to a multiple of 1024
K = 10                           # cameras per flagship step
FOV = math.radians(60)
# the duplicate budget, by bench.py's rule (6 % headroom over the
# duplicates observed): on the H100 the bench frame holds 407,301 and the
# flagship frames 259,933-415,661 (chip_smoke.py phase 4o), not the ~332k
# of bench.py's JAX runs; bench.py's 352,256 would truncate them.
# 415,661 · 1.06 rounded up to a multiple of 512
DUP_CAPACITY = 440_832
ITERATION0 = 3001                # the loops' first iteration (deform phase)
LOOPS = {"train": (3, 23), "render": (4, 44), "flagship": (2, 8)}
BASELINE_MRAYS = 28.6            # the reference GPU's render-only Mrays/s
METRIC = "train_step_throughput_43k_gaussians_400x400"
UNIT = "Mrays/s/chip (fwd+bwd+opt)"
WATCHDOG_S = 2400


def bench_scene(n: int, capacity: int, size: int, rng: np.random.Generator,
                device) -> tuple[G.GaussianState, Camera]:
    """bench.py:45-65 at n points in a `capacity` buffer and size x size
    pixels: points uniform in [-1.3, 1.3]^3 and uniform colours from `rng`,
    `create_from_pcd` (kNN scales, spatial_lr_scale 4), opacity logit 0.5
    and SH degree 3 active; the camera at z = 4 looking down the axis, 60°
    FoV, t = 0.5, its target image drawn from `rng` after the cloud."""
    pts = (rng.random((n, 3)) * 2.6 - 1.3).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    state = G.create_from_pcd(pts, cols, sh_degree=3, capacity=capacity,
                              spatial_lr_scale=4.0, device=device)
    state = dataclasses.replace(
        state, active_sh_degree=3, params=state.params._replace(
            opacity=torch.full((capacity, 1), 0.5, device=device)))
    return state, _camera((0.0, 0.0, 4.0), 0.5, size, rng, device)


def bench_cameras(k: int, size: int, rng: np.random.Generator,
                  device) -> list[Camera]:
    """bench.py:157-168: camera i at (0.1 i, -0.1 i, 4 + 0.2 i), t = i /
    (k - 1), each target image drawn from `rng` in turn."""
    return [_camera((0.1 * i, -0.1 * i, 4.0 + 0.2 * i), i / (k - 1), size,
                    rng, device) for i in range(k)]


def _camera(position, fid, size, rng, device) -> Camera:
    V = world_to_view(np.eye(3), np.array(position)).T
    image = rng.random((size, size, 3)).astype(np.float32)
    return camera_from_matrices(V, FOV, FOV, fid=fid, image=image,
                                device=device)


class Bench(NamedTuple):
    state: G.GaussianState
    cam: Camera
    cams: list                   # the flagship's k cameras
    field: DeformField           # the train step's and the render's MLP
    ffield: DeformField          # the flagship's
    step: object                 # make_train_step
    fstep: object                # make_batched_step
    pipe: C.PipelineParams


def build(device, *, n: int = N, capacity: int = CAP, size: int = WIDTH,
          k: int = K, dup_capacity: int = DUP_CAPACITY) -> Bench:
    """bench.py's configuration (at the given sizes): its scene, cameras,
    the baseline Blender MLPs (torch.Generator seed 0) and both steps."""
    rng = np.random.default_rng(0)
    state, cam = bench_scene(n, capacity, size, rng, device)
    cams = bench_cameras(k, size, rng, device)
    pipe = C.PipelineParams(tile_capacity=1024, tile_chunk=25,
                            dup_capacity=dup_capacity)
    field = create_deform_field(DeformFieldSpec(kind="baseline",
                                                is_blender=True),
                                seed=0, device=device)
    step = make_train_step(
        opt_cfg=C.OptimizationParams(), pipe_cfg=pipe,
        deform_fn=lambda xyz, fid, it, gen: field.step(xyz, fid),
        deform_params=list(field.net.parameters()),
        deform_update_fn=field.update)
    model_cfg = C.ModelParams(is_blender=True)
    fopt = C.OptimizationParams(num_cams_per_iter=k)
    ffield = create_deform_field(pick_field_spec(model_cfg, fopt), seed=0,
                                 device=device, opt_cfg=fopt)
    fstep = make_batched_step(opt_cfg=fopt, pipe_cfg=pipe,
                              model_cfg=model_cfg, field=ffield,
                              update_gaussians=True, update_deform=True,
                              use_deform=True)
    return Bench(state, cam, cams, field, ffield, step, fstep, pipe)


class BudgetReached(RuntimeError):
    """A frame's duplicates reached the budget, where the binning
    truncates."""


def budget(dup_capacity: int) -> int:
    """The binning's duplicate budget for `dup_capacity` (a multiple of
    512, ops/binning.py)."""
    return ((dup_capacity + 511) // 512) * 512


def _check_budget(m: int, b: Bench, what: str) -> None:
    cap = budget(b.pipe.dup_capacity)
    if m >= cap:
        raise BudgetReached(f"{what}: M = {m} duplicates reached the budget "
                            f"{cap}; the binning truncates there")


@torch.no_grad()
def frame_dups(b: Bench, field: DeformField, cam: Camera) -> int:
    """M of one render of the initial state at `cam` (a host read)."""
    dx, dr, ds = field.step(b.state.params.xyz, cam.fid)
    out = render(b.state, cam, d_xyz=dx, d_rotation=dr, d_scaling=ds,
                 bg=torch.zeros(3, device=dx.device),
                 dup_capacity=b.pipe.dup_capacity)
    return int(out.counts.sum())


def _restorer(field: DeformField):
    """-> restore(): one copy of the field's initial weights back into its
    parameters (its Adam steps update them in place)."""
    params = list(field.net.parameters())
    w0 = [p.detach().clone() for p in params]

    @torch.no_grad()
    def restore():
        torch._foreach_copy_(params, w0)
    return restore


def per_call_ms(fn, lengths, device) -> float:
    """Milliseconds per fn() call: n back-to-back calls timed for each of
    the two loop lengths n (a warm-up run, then the better of two timed
    runs, each ending in one synchronize) and differenced."""
    def loop(n):
        for _ in range(n):
            fn()
    lo, hi = (min(time_ms(lambda: loop(n), device, reps=1, warmup=w)
                  for w in (1, 0)) for n in lengths)
    return (hi - lo) / (lengths[1] - lengths[0])


def card() -> tuple[str, str]:
    """(name, power limit) as nvidia-smi reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def run_bench(device, *, loops=None, **sizes) -> dict:
    """Build bench.py's configuration (`sizes`: build()'s keywords), time
    its three loops (`loops`: name -> two lengths, LOOPS by default) and
    return the JSON line's fields."""
    loops = loops or LOOPS
    device = torch.device(device)
    b = build(device, **sizes)
    width, height = b.cam.width, b.cam.height
    k = len(b.cams)
    m_frame = frame_dups(b, b.field, b.cam)
    _check_budget(m_frame, b, "bench frame")
    for i, cam in enumerate(b.cams):
        _check_budget(frame_dups(b, b.ffield, cam), b, f"flagship camera {i}")
    bg = torch.zeros(3, device=b.state.params.xyz.device)
    restore, frestore = _restorer(b.field), _restorer(b.ffield)
    dstate0, fdstate0 = b.field.init_state(), b.ffield.init_state()
    dups = []                    # each frame's M, read after the loops

    def train_step():
        _, _, aux = b.step(b.state, dstate0, b.cam, ITERATION0, None, bg)
        restore()
        dups.append(aux.dup_total)

    @torch.no_grad()
    def render_frame():
        dx, dr, ds = b.field.step(b.state.params.xyz, b.cam.fid)
        dups.append(render(b.state, b.cam, d_xyz=dx, d_rotation=dr,
                           d_scaling=ds, bg=bg,
                           dup_capacity=b.pipe.dup_capacity).counts.sum())

    def flagship_step():
        b.fstep(b.state, fdstate0, b.cams, ITERATION0, bg)
        frestore()

    dt = per_call_ms(train_step, loops["train"], device)
    dt_render = per_call_ms(render_frame, loops["render"], device)
    dt_flag = per_call_ms(flagship_step, loops["flagship"], device)
    _check_budget(max(int(m) for m in dups), b, "train and render loops")

    for what, ms in (("train step", dt), ("render", dt_render),
                     ("flagship step", dt_flag)):
        if not ms > 0:
            raise RuntimeError(f"{what}: {ms} ms from the loop difference")
    mrays = width * height / dt / 1e3
    render_mrays = width * height / dt_render / 1e3
    if device.type == "cuda":
        name, limit = card()
    else:
        name, limit = "cpu (host clock, not a device time)", None
    return {
        "metric": METRIC, "value": mrays, "unit": UNIT,
        "vs_baseline": mrays / BASELINE_MRAYS, "train_step_ms": dt,
        "render_only_mrays": render_mrays,
        "render_only_fps": 1000.0 / dt_render,
        "render_vs_baseline": render_mrays / BASELINE_MRAYS,
        "flagship_ms_per_cam_k10": dt_flag / k,
        "device": name, "power_limit": limit, "dup_total": m_frame,
    }


def error_line(msg: str) -> str:
    """bench.py's error line."""
    return json.dumps({"metric": METRIC, "value": 0.0, "unit": UNIT,
                       "vs_baseline": 0.0, "error": msg[:300]})


def guarded(fn) -> int:
    """Print fn()'s JSON line -> 0; on any exception print the error line
    -> 1."""
    try:
        out = fn()
    except Exception as e:  # every failure prints the error line
        traceback.print_exc()
        print(error_line(f"{type(e).__name__}: {e}"), flush=True)
        return 1
    print(json.dumps(out), flush=True)
    return 0


def _watchdog():
    print(error_line(f"bench watchdog: no result within {WATCHDOG_S} s "
                     "(a build, kernel or step that does not return)"),
          flush=True)
    os._exit(1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="train-step, render and flagship throughput of the "
                    "port at the reference's headline configuration")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    timer = threading.Timer(WATCHDOG_S, _watchdog)
    timer.daemon = True
    timer.start()
    try:
        return guarded(lambda: run_bench(resolve_device(args.device)))
    finally:
        timer.cancel()


if __name__ == "__main__":
    sys.exit(main())
