"""`python -m d3gs_tpu_torch.bench` (d3gs_tpu_torch/bench.py), the port of
the root bench.py, on the CPU at a small size:

* `bench_scene` and `bench_cameras` draw bench.py's arrays: the points,
  colours and images from the same `default_rng(0)` draws in bench.py's
  order, the cameras' matrices against the JAX package's `world_to_view` /
  `perspective_projection`, the ten flagship cameras, and the state of
  `create_from_pcd` against JAX's `G.create_from_pcd`;
* one train step's loss against JAX's `make_train_step` with bench.py's
  PipelineParams, on the same recipe with the MLP weights carried over
  (loss rel 1e-5, tests/test_torch_port_train.py's);
* the loops at tiny lengths print one JSON line with every key of
  bench.py's line plus device, power_limit and dup_total; a budget the
  frame's duplicates reach, and a missing card, print bench.py's error line
  and return non-zero.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.config import OptimizationParams, PipelineParams
from d3gs_tpu.data.cameras import Camera
from d3gs_tpu.models import gaussians as JG
from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
from d3gs_tpu.ops.camera_math import perspective_projection, world_to_view
from d3gs_tpu.train.step import make_train_step
from d3gs_tpu_torch import bench as B
from d3gs_tpu_torch.models.deform import fields as TF
from tests.test_torch_port_flagship import _flat
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

N, CAP, SIZE = 400, 1024, 32
TINY_LOOPS = {"train": (1, 4), "render": (1, 4), "flagship": (1, 4)}
KEYS = {"metric", "value", "unit", "vs_baseline", "train_step_ms",
        "render_only_mrays", "render_only_fps", "render_vs_baseline",
        "flagship_ms_per_cam_k10", "device", "power_limit", "dup_total"}


def bench_recipe(n, capacity, size):
    """bench.py:44-65 and 157-168 with the JAX package, at these sizes."""
    rng = np.random.default_rng(0)
    pts = (rng.random((n, 3)) * 2.6 - 1.3).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    state = JG.create_from_pcd(pts, cols, sh_degree=3, capacity=capacity,
                               spatial_lr_scale=4.0)
    state = state.replace(
        active_sh_degree=jnp.asarray(3, jnp.int32),
        params=state.params._replace(
            opacity=jnp.full((capacity, 1), 0.5, jnp.float32)))
    fov = math.radians(60)
    P = perspective_projection(0.01, 100.0, fov, fov).T

    def camera(pos, fid):
        V = world_to_view(np.eye(3), np.array(pos)).T
        return Camera(
            viewmatrix=jnp.asarray(V, jnp.float32),
            projmatrix=jnp.asarray(V @ P, jnp.float32),
            campos=jnp.asarray(np.linalg.inv(V)[3, :3], jnp.float32),
            fid=jnp.asarray(fid),
            image=jnp.asarray(rng.random((size, size, 3)), jnp.float32),
            width=size, height=size, fovx=fov, fovy=fov)
    cam = camera((0.0, 0.0, 4.0), 0.5)
    cams = [camera((0.1 * i, -0.1 * i, 4.0 + 0.2 * i), i / (B.K - 1))
            for i in range(B.K)]
    return pts, cols, state, cam, cams


def _same_camera(t, j):
    for name in ("viewmatrix", "projmatrix", "campos", "image"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert t.fid == pytest.approx(float(j.fid))
    assert (t.width, t.height) == (j.width, j.height)
    assert t.fovx == pytest.approx(j.fovx) and t.fovy == pytest.approx(j.fovy)


def test_scene_and_cameras_follow_bench_recipe():
    pts, cols, js, jcam, jcams = bench_recipe(N, CAP, SIZE)
    rng = np.random.default_rng(0)
    ts, tcam = B.bench_scene(N, CAP, SIZE, rng, "cpu")
    tcams = B.bench_cameras(B.K, SIZE, rng, "cpu")
    np.testing.assert_array_equal(ts.params.xyz.numpy()[:N], pts)
    _same_camera(tcam, jcam)
    assert len(tcams) == B.K
    for t, j in zip(tcams, jcams):
        _same_camera(t, j)
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    assert ts.active_sh_degree == 3 and ts.max_sh_degree == 3
    assert ts.spatial_lr_scale == js.spatial_lr_scale == 4.0
    for name, a, b in zip(JG.GaussianParams._fields, ts.params, js.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # the colours as the DC band
    np.testing.assert_allclose(ts.params.features_dc.numpy()[:N, 0],
                               (cols - 0.5) / 0.28209479177387814, rtol=1e-5,
                               atol=1e-6)


def test_one_train_step_loss_matches_jax():
    _, _, js, jcam, _ = bench_recipe(N, CAP, SIZE)
    dstate, field = create_deform_field(
        DeformFieldSpec(kind="baseline", is_blender=True),
        jax.random.PRNGKey(0))
    pipe = PipelineParams(tile_capacity=1024, tile_chunk=25,
                          dup_capacity=B.DUP_CAPACITY)
    jstep = make_train_step(
        opt_cfg=OptimizationParams(), pipe_cfg=pipe, donate=False,
        deform_fn=lambda dp, xyz, fid, it, key: field.step(dp, xyz, fid),
        deform_update_fn=field.update)
    _, _, jaux = jstep(js, dstate, jcam, float(B.ITERATION0),
                       jax.random.PRNGKey(0), jnp.zeros(3))

    b = B.build("cpu", n=N, capacity=CAP, size=SIZE)
    b.field.net.load_state_dict(TF.params_from_flax(_flat(dstate.params),
                                                    b.field.net))
    _, _, aux = b.step(b.state, b.field.init_state(), b.cam, B.ITERATION0,
                       None, torch.zeros(3))
    assert float(aux.loss) == pytest.approx(float(jaux.loss), rel=1e-5)
    assert int(aux.dup_total) == int(jaux.dup_total) > 0


def _line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_tiny_loops_print_every_key(capsys):
    rc = B.guarded(lambda: B.run_bench("cpu", loops=TINY_LOOPS, n=N,
                                       capacity=CAP, size=SIZE))
    out = _line(capsys)
    assert rc == 0, out
    assert set(out) == KEYS
    assert out["metric"] == B.METRIC and out["unit"] == B.UNIT
    for k in KEYS - {"metric", "unit", "device", "power_limit"}:
        assert out[k] > 0, k
    assert out["value"] == pytest.approx(SIZE * SIZE / out["train_step_ms"]
                                         / 1e3)
    assert out["vs_baseline"] == pytest.approx(out["value"] / 28.6)
    assert out["render_only_fps"] == pytest.approx(
        out["render_only_mrays"] * 1e6 / (SIZE * SIZE))
    assert out["dup_total"] < B.budget(B.DUP_CAPACITY)


def test_budget_reached_prints_the_error_line(capsys):
    rc = B.guarded(lambda: B.run_bench("cpu", loops=TINY_LOOPS, n=N,
                                       capacity=CAP, size=SIZE,
                                       dup_capacity=512))
    out = _line(capsys)
    assert rc != 0
    assert out["value"] == 0.0 and out["metric"] == B.METRIC
    assert out["error"].startswith("BudgetReached: bench frame: M = ")


def test_main_without_a_card_fails(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert B.main([]) != 0
    assert "CUDA" in _line(capsys)["error"]
