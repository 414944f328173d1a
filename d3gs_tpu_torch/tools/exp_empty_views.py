"""Empty views in baseline training: which steps render nothing, and why.

    python -m d3gs_tpu_torch.tools.exp_empty_views [--device cpu] \
        [--runs 4] [--iterations 1000] [--size 400] [--points 43132] \
        [-s DATASET]

Trains the baseline CLI `--runs` times (warm-up 6, densify passes at 12
and 16 at threshold 1e-8, the opacity reset at 10, 1000 iterations) on
`-s`, or else on `gradient_dataset`: the same screen-space gradient
(red = x, green = y, blue = the view's time) from every pose of a
radius-4 orbit, which no 3-D scene shows, with bench.py's uniform cloud
as its points. There the deform field, the only part that sees the time,
can throw every Gaussian out of a view; the empty render then gives it
no gradient back. `EmptyViewWatch` records every
step whose render is all background, and for the first few of them (and a
few fixed iterations) the state behind it: opacities, the deformation's
displacement |d_xyz|, the view depth of the deformed means and how many
lie in front of the camera and inside its frame. One JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from .. import resolve_device
from ..train import step as step_module

DETAIL_AT = (20, 100, 500, 1000)


def bench_points(n: int, seed: int = 0):
    """bench.py:45-48: n points uniform in [-1.3, 1.3]^3 and uniform RGB
    colours, numpy seed 0."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)) * 2.6 - 1.3).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return pts, cols


def orbit_c2w(angle: float, radius: float = 4.0) -> np.ndarray:
    """A camera-to-world matrix on the radius-4 orbit about the y axis,
    looking at the origin, in the Blender convention the D-NeRF reader
    flips."""
    R = np.array([[math.cos(angle), 0, math.sin(angle)], [0, 1, 0],
                  [-math.sin(angle), 0, math.cos(angle)]])
    Rr = -R
    Rr[:, 0] = -Rr[:, 0]
    inv = np.eye(4)
    inv[:3, :3] = Rr.T
    inv[:3, 3] = -np.array([0.0, 0.0, radius])
    return np.linalg.inv(inv)


def gradient_dataset(root: str, n_points: int, n_train: int = 4,
                     n_test: int = 2, size: int = 400) -> None:
    """D-NeRF layout: transforms_{train,test}.json, RGBA PNGs of the same
    gradient (x, y, t) from every pose, `time` spread over [0, 1], and
    bench.py's cloud as points3d.ply."""
    from ..data.image_io import write_png
    from ..data.ply import write_pointcloud_ply
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1)
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for k in range(n):
            t = k / max(n - 1, 1)
            rgba = np.stack([xx, yy, np.full_like(xx, t),
                             np.ones_like(xx)], -1)
            write_png(os.path.join(root, split, f"r_{k:03d}.png"),
                      (rgba * 255).astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{k:03d}", "time": t,
                           "transform_matrix": orbit_c2w(
                               k * 2 * math.pi / n + 0.3).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": math.radians(60), "frames": frames},
                      f)
    pts, cols = bench_points(n_points)
    write_pointcloud_ply(os.path.join(root, "points3d.ply"), pts,
                         np.round(cols * 255))


def _quantiles(x: torch.Tensor) -> list | None:
    x = x.detach().float().flatten()
    x = x[torch.isfinite(x)]
    if x.numel() == 0:
        return None
    q = torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0], device=x.device)
    return [round(float(v), 4) for v in torch.quantile(x, q)]


@torch.no_grad()
def _state_behind(state, camera, deform_fn, iteration, out) -> dict:
    """Opacities, |d_xyz|, view depths and how many deformed means lie in
    front of the camera (depth > 0.2) and inside its frame."""
    alive = state.alive
    p = state.params
    xyz = p.xyz[alive]
    d = {"alive": int(alive.sum()),
         "opacity_q": _quantiles(torch.sigmoid(p.opacity[alive, 0])),
         "visible": int((out.radii > 0).sum())}
    if deform_fn is not None:
        dx = deform_fn(p.xyz, camera.fid, iteration, None)[0][alive]
        d["d_xyz_norm_q"] = _quantiles(dx.norm(dim=-1))
        xyz = xyz + dx
    h = torch.cat([xyz, torch.ones_like(xyz[:, :1])], -1)
    depth = (h @ camera.viewmatrix)[:, 2]
    clip = h @ camera.projmatrix
    ndc = clip[:, :2] / clip[:, 3:4]
    d["depth_q"] = _quantiles(depth)
    d["in_front_and_frame"] = int(((depth > 0.2)
                                   & (ndc.abs() <= 1).all(-1)).sum())
    return d


class EmptyViewWatch:
    """While active, wraps `train.step.make_loss_and_grads` so that every
    train step records (iteration, the view's time, loss, whether its
    render is all background: no pixel above 0 on a black background);
    `details` holds `_state_behind` for the first `n_detail` empty steps
    and the steps at DETAIL_AT. One host read per step."""

    def __init__(self, n_detail: int = 3):
        self.n_detail, self.n_empty = n_detail, 0
        self.steps, self.details = [], []

    def __enter__(self):
        self.orig = step_module.make_loss_and_grads

        def make(**kw):
            inner = self.orig(**kw)
            deform_fn = kw.get("deform_fn")

            def loss_and_grads(state, camera, iteration, generator, bg,
                               aux_data=None):
                r = inner(state, camera, iteration, generator, bg, aux_data)
                empty = bool(r.out.image.max() <= 0)
                self.steps.append((iteration, round(float(camera.fid), 3),
                                   float(r.loss), empty))
                self.n_empty += empty
                if (empty and self.n_empty <= self.n_detail) \
                        or iteration in DETAIL_AT:
                    self.details.append({
                        "iteration": iteration, "empty": empty,
                        **_state_behind(state, camera, deform_fn, iteration,
                                        r.out)})
                return r
            return loss_and_grads
        step_module.make_loss_and_grads = make
        return self

    def __exit__(self, *exc):
        step_module.make_loss_and_grads = self.orig

    @property
    def empty(self) -> list:
        """(iteration, the view's time) of every empty step."""
        return [(i, t) for i, t, _, e in self.steps if e]


def main(argv=None) -> list:
    from ..train.__main__ import main as train_main
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--points", type=int, default=43_132)
    ap.add_argument("-s", "--source", default="")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    results = []
    with tempfile.TemporaryDirectory(prefix="empty_views_") as tmp:
        data = args.source
        if not data:
            data = os.path.join(tmp, "data")
            gradient_dataset(data, args.points, size=args.size)
        for run in range(args.runs):
            t0 = time.perf_counter()
            with EmptyViewWatch() as watch:
                res = train_main([
                    "-s", data, "-m", os.path.join(tmp, f"run{run}"),
                    "--eval", "--is_blender", "--quiet", "--device",
                    str(dev), "--iterations", str(args.iterations),
                    "--warm_up", "6", "--sh_degree", "3",
                    "--densify_from_iter", "8", "--densify_until_iter", "18",
                    "--densification_interval", "4",
                    "--densify_grad_threshold", "1e-8",
                    "--opacity_reset_interval", "10",
                    "--test_iterations", str(args.iterations),
                    "--save_iterations", str(args.iterations),
                    "--sequence_length", "4"])
            empty = watch.empty
            out = {"run": run, "wall_s": round(time.perf_counter() - t0, 1),
                   "test_psnr": res.test_psnrs, "empty_steps": len(empty),
                   "first_empty": empty[0][0] if empty else None,
                   "empty_times": sorted({t for _, t in empty}),
                   "losses": [(i, round(v, 5)) for i, v in res.losses],
                   "details": watch.details}
            print(json.dumps(out), flush=True)
            results.append(out)
    return results


if __name__ == "__main__":
    main()
