"""The port's flagship k-camera / neural-ODE trainer against the JAX package
on the CPU, with the JAX side at the settings of tests/test_train_flagship.py
(SH 1, Blender deform nets, tile_capacity 256, tile_chunk 16):

* `IterativeSchedule` and the camera picks (`random.Random(seed)` over the
  fid-sorted, optionally spread-out stack) equal JAX's exactly;
* one k = 3 step of `make_batched_step` for the MLP and ODE kinds: loss
  (rel 1e-5), the gradients of the six Gaussian parameters, of the deform
  net and the densification statistics, each within 1e-4 of its largest
  entry. JAX's step returns no gradients; its Adam moments after one step
  from zero are m = 0.1·g, and those are compared;
* the CLI `python -m d3gs_tpu_torch.train --trainer flagship --is_ode
  --device cpu` for a few iterations (warm-up, alternating updates,
  densify, eval, save), the checkpoint read by the port's renderer and the
  JAX loaders, and `--base_model_path` freezing the Gaussians.
"""
import dataclasses
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3gs_tpu.train.flagship as JF
from d3gs_tpu.config import ModelParams, OptimizationParams, PipelineParams
from d3gs_tpu.data.cameras import stack_cameras
from d3gs_tpu.data.scene import load_gaussians_ply as jax_load_ply
from d3gs_tpu.models import gaussians as JG
from d3gs_tpu.models.deform import create_deform_field
from d3gs_tpu.models.deform.fields import load_deform_weights as jax_load_npz
from d3gs_tpu.models.renderer import render as jax_render
from d3gs_tpu_torch import config as TC
from d3gs_tpu_torch.models.deform import fields as TF
from d3gs_tpu_torch.train import flagship as TFL
from tests.test_cli_end_to_end import write_blender_dataset
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401
from tests.test_torch_port_gaussians import to_torch
from tests.test_torch_port_train import to_torch_camera
from tests.test_train_static import gt_state, make_camera

CAP = 512


def _flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.mark.parametrize("cfg", [(True, 10, 0.5, 2), (True, 7, 0.9, 5),
                                 (True, 3, 1.0, 0), (False, 10, 0.5, 5)])
def test_iterative_schedule_matches_jax(cfg):
    kw = dict(zip(("enabled", "interval", "decay", "max_switches"), cfg))
    js, ts = JF.IterativeSchedule(**kw), TFL.IterativeSchedule(**kw)
    modes = [ts.mode(i) for i in range(1, 80)]
    assert modes == [js.mode(i) for i in range(1, 80)]
    if cfg == (True, 10, 0.5, 2):
        assert modes[0] == (False, True) and modes[-1] == (True, True)
        assert (True, False) in modes


@pytest.mark.parametrize("spread,seq", [(True, 6), (False, 0)])
def test_camera_picks_match_jax(spread, seq, monkeypatch):
    """JAX's `train_flagship` drives its pick_batch with the step replaced
    by a recorder; the port's `BatchPicker` must pick the same fids."""
    cams = [types.SimpleNamespace(fid=np.float32(f)) for f in
            np.random.default_rng(0).permutation(np.linspace(0, 1, 10))]
    seen = []

    def recorder_factory(**kw):
        def step(state, dstate, batch, *args):
            seen.append([float(c.fid) for c in batch])
            return state, dstate, 0.0, 0.0, 0
        return step

    monkeypatch.setattr(JF, "make_batched_step", recorder_factory)
    monkeypatch.setattr(JF, "stack_cameras", list)
    opt = OptimizationParams(iterations=23, warm_up=5, num_cams_per_iter=3,
                             spread_out_sequence=spread,
                             sequence_length=seq, densify_until_iter=0)
    JF.train_flagship(gaussians=None, train_cams=cams, test_cams=[],
                      cameras_extent=1.0,
                      model_cfg=ModelParams(is_blender=True, D=2, W=8),
                      opt_cfg=opt, pipe_cfg=PipelineParams(), seed=3,
                      progress=False)
    pick = TFL.BatchPicker(cams, k=3, sequence_length=seq, spread_out=spread,
                           seed=3)
    ours = [[float(c.fid) for c in pick()] for _ in range(23)]
    assert len(seen) == 23 and ours == seen
    assert all(b == sorted(b) for b in ours)


@pytest.fixture(scope="module")
def scene():
    """Three views of a GT cloud at three times, and a fresh SH-1 cloud with
    anisotropic rotated Gaussians to fit (as test_torch_port_train.py)."""
    gt = gt_state(n=120, cap=CAP)
    rng = np.random.default_rng(5)
    n = 150
    js = JG.create_from_pcd(rng.normal(0, 0.6, (n, 3)).astype(np.float32),
                            rng.uniform(0.2, 1, (n, 3)).astype(np.float32),
                            sh_degree=1, capacity=CAP, spatial_lr_scale=2.0)
    quats = rng.normal(size=(CAP, 4)).astype(np.float32)
    quats[:, 0] += 2.0
    p = js.params
    js = JG.oneup_sh_degree(js.replace(params=p._replace(
        scaling=p.scaling + jnp.asarray(rng.normal(0, 0.4, (CAP, 3)),
                                        jnp.float32),
        rotation=jnp.asarray(quats),
        features_rest=jnp.asarray(rng.normal(0, 0.1, (CAP, 3, 3)),
                                  jnp.float32))))
    cams = []
    for k, fid in enumerate((0.15, 0.5, 0.8)):
        cam = make_camera(angle=0.4 + 1.1 * k)
        img = jax_render(gt, cam, bg=jnp.zeros(3), tile_capacity=256,
                         tile_chunk=16).image
        cams.append(dataclasses.replace(cam, image=img,
                                        fid=jnp.asarray(fid, jnp.float32)))
    return js, cams


def _rel(got, ref, tol, msg):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0 and np.isfinite(got).all(), msg
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol,
                               err_msg=msg)


@pytest.mark.parametrize("kind", ["mlp", "ode"])
def test_flagship_step_matches_jax(scene, kind):
    js, cams = scene
    mk = dict(is_blender=True, sh_degree=1, D=2, W=32, is_ode=kind == "ode")
    jmodel, tmodel = ModelParams(**mk), TC.ModelParams(**mk)
    ok = dict(num_cams_per_iter=3, position_lr_max_steps=100)
    jopt, topt = OptimizationParams(**ok), TC.OptimizationParams(**ok)
    jspec = JF.pick_field_spec(jmodel, jopt)
    dstate, field = create_deform_field(jspec, jax.random.PRNGKey(4), jopt)
    jstep = JF.make_batched_step(
        opt_cfg=jopt, pipe_cfg=PipelineParams(tile_capacity=256,
                                              tile_chunk=16),
        model_cfg=jmodel, field=field, update_gaussians=True,
        update_deform=True, use_deform=True)
    js1, jd1, jloss, jl1, _ = jstep(js, dstate, stack_cameras(cams),
                                    jnp.asarray(50.0), jax.random.PRNGKey(0),
                                    jnp.zeros(3))

    tfield = TF.create_deform_field(TFL.pick_field_spec(tmodel, topt),
                                    device="cpu", opt_cfg=topt)
    assert tfield.spec.kind == ("ode" if kind == "ode" else "baseline")
    tfield.net.load_state_dict(TF.params_from_flax(_flat(dstate.params),
                                                   tfield.net))
    tcams = [to_torch_camera(c, c.fid) for c in cams]
    tpipe = TC.PipelineParams()
    ts = to_torch(js)
    r = TFL.make_batched_loss_and_grads(
        opt_cfg=topt, pipe_cfg=tpipe, model_cfg=tmodel, field=tfield,
        use_deform=True)(ts, tcams, torch.zeros(3))
    assert float(r.loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(r.l1) == pytest.approx(float(jl1), rel=1e-5)
    alive = ts.alive
    for name, g, m in zip(JG.GaussianParams._fields, r.params, js1.opt.m):
        g = g * alive.reshape((-1,) + (1,) * (g.ndim - 1))
        if name == "xyz" and kind == "ode":
            # direct_compute: the means come from the trajectory of the
            # detached canonical means, so they get no gradient
            assert not g.any() and not np.asarray(m).any()
            continue
        _rel(g.numpy(), np.asarray(m) / 0.1, 1e-4, name)
    ref = TF.params_from_flax(_flat(jd1.m), tfield.net)
    for (name, _), g in zip(tfield.net.named_parameters(), r.deform):
        _rel(g.numpy(), ref[name].numpy() / 0.1, 1e-4, name)

    tstep = TFL.make_batched_step(
        opt_cfg=topt, pipe_cfg=tpipe, model_cfg=tmodel, field=tfield,
        update_gaussians=True, update_deform=True, use_deform=True)
    ts1, td1, aux = tstep(ts, tfield.init_state(), tcams, 50, torch.zeros(3))
    assert float(aux.loss) == pytest.approx(float(jloss), rel=1e-5)
    assert td1.count == 1
    np.testing.assert_array_equal(ts1.denom.numpy(), np.asarray(js1.denom))
    np.testing.assert_array_equal(ts1.max_radii2d.numpy(),
                                  np.asarray(js1.max_radii2d))
    _rel(ts1.grad_accum.numpy(), js1.grad_accum, 1e-4, "grad_accum")
    # the statistic is |Σ_cameras dL/dmean2d|, not Σ |·|: one shared tap
    assert float(r.tap.norm(dim=-1).max()) > 0


def test_ode_batch10_preset_picks_the_ode_field():
    """`--configs configs/ode_batch10.py` selects the 8×256 ODE field."""
    m, o = TC.ModelParams(is_blender=True), TC.OptimizationParams()
    p = TC.PipelineParams()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    TC.apply_config_file(os.path.join(repo, "configs", "ode_batch10.py"),
                         {"model": m, "pipeline": p, "optimization": o})
    spec = TFL.pick_field_spec(m, o)
    assert (spec.kind, spec.D, spec.W, spec.solver) == ("ode", 8, 256, "rk4")
    assert o.num_cams_per_iter == 60 and o.direct_compute
    assert (spec.rtol, spec.atol) == (1e-4, 1e-5)


def _train(data, mp, *extra):
    from d3gs_tpu_torch.train.__main__ import main
    return main([
        "-s", data, "-m", mp, "--eval", "--is_blender", "--device", "cpu",
        "--trainer", "flagship", "--is_ode", "--D", "2", "--W", "32",
        "--sh_degree", "1", "--max_gaussians", "600", "--quiet",
        "--num_cams_per_iter", "3", "--position_lr_max_steps", "10",
        "--deform_lr_max_steps", "10", *extra])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_flagship")
    data = write_blender_dataset(str(root / "data"), n_train=6, n_test=2,
                                 size=32)
    mp = str(root / "model")
    result = _train(
        data, mp, "--iterations", "10", "--warm_up", "3",
        "--use_iterative_update", "--iterative_update_interval", "5",
        "--max_training_switches", "1", "--densify_from_iter", "4",
        "--densify_until_iter", "9", "--densification_interval", "4",
        "--densify_grad_threshold", "1e-9", "--test_iterations", "10")
    return data, mp, result


def test_flagship_cli_trains_on_cpu(trained):
    _, mp, result = trained
    assert result.field.spec.kind == "ode"
    assert all(math.isfinite(v) for _, v in result.losses)
    assert result.best_iteration == 10 and result.best_psnr > 5
    # one densify pass (iteration 8) at a threshold low enough to clone
    [(it, n0, _, n1, _)] = result.densify_events
    assert it == 8 and n1 > n0
    # 7 deform steps, the switch at iteration 5 included
    assert result.deform_state.count == 7
    for f in ("cfg_args", "point_cloud/iteration_10/point_cloud.ply",
              "deform/iteration_10/deform.npz"):
        assert os.path.exists(os.path.join(mp, f)), f


def test_flagship_checkpoint_renders_and_loads_in_jax(trained):
    _, mp, result = trained
    from d3gs_tpu_torch import render as trender
    out = trender.main(["-m", mp, "--mode", "render", "--device", "cpu"])
    assert out == {"iteration": 10, "views": 8}
    jspec = JF.pick_field_spec(ModelParams(is_blender=True, is_ode=True, D=2,
                                           W=32), OptimizationParams())
    dstate, _ = create_deform_field(jspec, jax.random.PRNGKey(0))
    dstate = jax_load_npz(mp, dstate)
    ref = TF.params_from_flax(_flat(dstate.params), result.field.net)
    for name, p in result.field.net.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), ref[name].numpy())
    js = jax_load_ply(os.path.join(mp, "point_cloud", "iteration_10",
                                   "point_cloud.ply"), sh_degree=1)
    assert int(js.num_alive) == result.state.num_alive


def test_base_model_path_freezes_gaussians(trained, tmp_path):
    data, base, _ = trained
    mp = str(tmp_path / "frozen")
    # a budget above the base's count: no subsampling of the loaded PLY
    result = _train(data, mp, "--iterations", "3", "--warm_up", "1",
                    "--max_gaussians", "4000",
                    "--base_model_path", base, "--densify_from_iter", "0",
                    "--densification_interval", "1",
                    "--densify_grad_threshold", "1e-9",
                    "--test_iterations", "3")
    assert result.densify_events == []        # densify is gated off
    assert result.deform_state.count == 3     # no warm-up before 1
    ply = os.path.join("point_cloud", "iteration_{}", "point_cloud.ply")
    a = jax_load_ply(os.path.join(base, ply.format(10)), sh_degree=1)
    b = jax_load_ply(os.path.join(mp, ply.format(3)), sh_degree=1)
    for x, y in zip(a.params, b.params):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
