"""`d3gs_tpu_torch/tools/exp_empty_views.py` on the CPU: the watch that
`chip_smoke.py`'s training path uses to fail on a step whose render is all
background, and the tool's CLI at a small size."""
import math

import numpy as np
import torch

from d3gs_tpu_torch import config as C
from d3gs_tpu_torch.data.cameras import camera_from_matrices
from d3gs_tpu_torch.models import gaussians as G
from d3gs_tpu_torch.ops.camera_math import world_to_view
from d3gs_tpu_torch.tools import exp_empty_views as E
from d3gs_tpu_torch.train import step as step_module
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


def _step_at(z: float):
    """One warm-up train step through the watch, 32 Gaussians about the
    origin seen from a camera at (0, 0, z) looking down +z: in front of
    it for z < 0, all behind it for z > 0."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.5, (32, 3)).astype(np.float32)
    state = G.create_from_pcd(pts, rng.uniform(0.2, 1, (32, 3)),
                              sh_degree=0, capacity=64, device="cpu")
    V = world_to_view(np.eye(3), np.array([0.0, 0.0, -z])).T
    fov = math.radians(60)
    cam = camera_from_matrices(V, fov, fov, fid=0.25, device="cpu",
                               image=np.full((32, 32, 3), 0.5, np.float32))
    with E.EmptyViewWatch() as watch:
        loss_and_grads = step_module.make_loss_and_grads(
            opt_cfg=C.OptimizationParams(), pipe_cfg=C.PipelineParams())
        loss_and_grads(state, cam, 7, None, torch.zeros(3))
    assert step_module.make_loss_and_grads is watch.orig
    return watch


def test_watch_flags_a_view_that_renders_nothing():
    seen = _step_at(-4.0)
    assert seen.empty == [] and seen.steps[0][:2] == (7, 0.25)
    behind = _step_at(4.0)
    assert behind.empty == [(7, 0.25)]
    (d,) = behind.details
    assert d["empty"] and d["visible"] == 0 and d["in_front_and_frame"] == 0
    assert d["depth_q"][-1] < 0 and d["alive"] == 32


def test_cli_runs_on_cpu():
    (run,) = E.main(["--device", "cpu", "--runs", "1", "--iterations", "20",
                     "--size", "32", "--points", "300"])
    assert set(run) >= {"test_psnr", "empty_steps", "first_empty",
                        "empty_times", "losses", "details"}
    assert 20 in run["test_psnr"] and np.isfinite(run["test_psnr"][20])
    # the watch reads the state behind step 20 (a deform step)
    (d20,) = [d for d in run["details"] if d["iteration"] == 20]
    assert d20["alive"] > 0 and len(d20["d_xyz_norm_q"]) == 5
