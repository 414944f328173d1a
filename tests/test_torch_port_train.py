"""The port's training slice against the JAX package on the CPU.

* One deform-phase step: loss and gradients of the six Gaussian parameters,
  the deform MLP's parameters and the screen-space tap, against
  jax.value_and_grad of JAX's render (its `packed` blend, whose gradients
  test_pallas_blend.py holds to the Pallas kernel's) and L1/SSIM loss.
  Tolerances: loss rel 1e-5, gradients 1e-4 of their largest entry.
* Five steps of `make_train_step` in each package (two warm-up, three
  deform): losses within rel 1e-3, parameters within 5 % of their total
  motion (Adam's first steps move by ±lr·sign(g), so noise-level gradients
  may flip a row), visible counts equal, radii within one pixel (ceil'd),
  accumulated tap gradients within 1e-3 of their largest.
* The CLI `python -m d3gs_tpu_torch.train --device cpu` on a small D-NeRF
  dataset, its checkpoint read back by the port's render CLI and by the JAX
  loaders.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.config import OptimizationParams, PipelineParams
from d3gs_tpu.data.scene import load_gaussians_ply as jax_load_ply
from d3gs_tpu.models import gaussians as JG
from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
from d3gs_tpu.models.deform.fields import load_deform_weights as jax_load_npz
from d3gs_tpu.models.renderer import render as jax_render
from d3gs_tpu.ops.losses import l1_loss, ssim
from d3gs_tpu.train.step import make_train_step as jax_make_train_step
from d3gs_tpu_torch import config as TC
from d3gs_tpu_torch.data.cameras import Camera as TCamera
from d3gs_tpu_torch.models.deform import fields as TF
from d3gs_tpu_torch.train import step as TS
from tests.test_cli_end_to_end import write_blender_dataset
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401
from tests.test_torch_port_gaussians import to_torch
from tests.test_train_static import gt_state, make_camera

SPEC = dict(kind="baseline", is_blender=True, D=2, W=32)
CAP = 512


def _flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def to_torch_camera(cam, fid) -> TCamera:
    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    return TCamera(viewmatrix=t(cam.viewmatrix), projmatrix=t(cam.projmatrix),
                   campos=t(cam.campos), fid=float(fid), image=t(cam.image),
                   width=cam.width, height=cam.height, fovx=cam.fovx,
                   fovy=cam.fovy)


@pytest.fixture(scope="module")
def scene():
    """A fresh cloud to fit to GT renders of two views at two times, SH 1
    with live higher bands, a narrow Blender deform MLP in both packages."""
    gt = gt_state(n=120, cap=CAP)
    rng = np.random.default_rng(5)
    n = 150
    js = JG.create_from_pcd(rng.normal(0, 0.6, (n, 3)).astype(np.float32),
                            rng.uniform(0.2, 1, (n, 3)).astype(np.float32),
                            sh_degree=1, capacity=CAP, spatial_lr_scale=2.0)
    # anisotropic, rotated Gaussians: with equal axes the rotation's
    # gradient is rounding noise, which Adam's first steps amplify to ±lr
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
    for k, fid in enumerate((0.2, 0.7)):
        cam = make_camera(angle=0.4 + 1.1 * k)
        img = jax_render(gt, cam, bg=jnp.zeros(3), tile_capacity=256,
                         tile_chunk=16).image
        cams.append(dataclasses.replace(cam, image=img,
                                        fid=jnp.asarray(fid, jnp.float32)))
    dstate, field = create_deform_field(DeformFieldSpec(**SPEC),
                                        jax.random.PRNGKey(3),
                                        OptimizationParams())
    tfield = TF.create_deform_field(TF.DeformFieldSpec(**SPEC), device="cpu",
                                    opt_cfg=TC.OptimizationParams())
    tfield.net.load_state_dict(TF.params_from_flax(_flat(dstate.params),
                                                   tfield.net))
    return js, cams, dstate, field, tfield


def _jax_grads(js, cam, dstate, field, lam=0.2):
    def f(gp, dp, tap):
        st = js.replace(params=gp)
        dx, dr, ds = field.step(dp, jax.lax.stop_gradient(gp.xyz), cam.fid)
        out = jax_render(st, cam, d_xyz=dx, d_rotation=dr, d_scaling=ds,
                         bg=jnp.zeros(3), means2d_tap=tap, binning="packed",
                         tile_capacity=1024, depth_grad=False)
        return (1 - lam) * l1_loss(out.image, cam.image) + lam * (
            1 - ssim(out.image, cam.image))
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2)))(
        js.params, dstate.params, jnp.zeros((CAP, 2)))


def _assert_rel(got, ref, tol, msg):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0 and np.isfinite(got).all(), msg
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol,
                               err_msg=msg)


def test_one_deform_step_gradients_match_jax(scene):
    js, cams, dstate, field, tfield = scene
    cam = cams[1]
    loss, (g_params, g_deform, g_tap) = _jax_grads(js, cam, dstate, field)

    ts = to_torch(js)
    loss_and_grads = TS.make_loss_and_grads(
        opt_cfg=TC.OptimizationParams(), pipe_cfg=TC.PipelineParams(),
        deform_fn=lambda xyz, fid, it, gen: tfield.step(xyz, fid),
        deform_params=list(tfield.net.parameters()))
    r = loss_and_grads(ts, to_torch_camera(cam, cam.fid), 4000, None,
                       torch.zeros(3))
    assert float(r.loss) == pytest.approx(float(loss), rel=1e-5)
    for name, a, b in zip(JG.GaussianParams._fields, r.params, g_params):
        _assert_rel(a.numpy(), b, 1e-4, name)
    _assert_rel(r.tap.numpy(), g_tap, 1e-4, "tap")
    ref = TF.params_from_flax(_flat(g_deform), tfield.net)
    for (name, _), g in zip(tfield.net.named_parameters(), r.deform):
        _assert_rel(g.numpy(), ref[name].numpy(), 1e-4, name)


def test_five_train_steps_match_jax(scene):
    js0, cams, dstate, field, tfield = scene
    opt = OptimizationParams(position_lr_max_steps=100, warm_up=3)
    pipe = PipelineParams(tile_capacity=1024, tile_chunk=16)
    jwarm = jax_make_train_step(opt_cfg=opt, pipe_cfg=pipe, donate=False)
    jdef = jax_make_train_step(
        opt_cfg=opt, pipe_cfg=pipe, donate=False,
        deform_fn=lambda dp, xyz, fid, it, key: field.step(dp, xyz, fid),
        deform_update_fn=field.update)
    topt = TC.OptimizationParams(position_lr_max_steps=100, warm_up=3)
    tpipe = TC.PipelineParams()
    tf = TF.create_deform_field(TF.DeformFieldSpec(**SPEC), device="cpu",
                                opt_cfg=topt)
    tf.net.load_state_dict(tfield.net.state_dict())
    twarm = TS.make_train_step(opt_cfg=topt, pipe_cfg=tpipe)
    tdef = TS.make_train_step(
        opt_cfg=topt, pipe_cfg=tpipe,
        deform_fn=lambda xyz, fid, it, gen: tf.step(xyz, fid),
        deform_params=list(tf.net.parameters()), deform_update_fn=tf.update)

    js, jd, ts, td = js0, dstate, to_torch(js0), tf.init_state()
    key, bg = jax.random.PRNGKey(0), jnp.zeros(3)
    for it in range(1, 6):
        cam = cams[it % 2]
        tcam = to_torch_camera(cam, cam.fid)
        if it < opt.warm_up:
            js, _, jaux = jwarm(js, None, cam, float(it), key, bg)
            ts, _, taux = twarm(ts, None, tcam, it, None, torch.zeros(3))
        else:
            js, jd, jaux = jdef(js, jd, cam, float(it), key, bg)
            ts, td, taux = tdef(ts, td, tcam, it, None, torch.zeros(3))
        assert float(taux.loss) == pytest.approx(float(jaux.loss), rel=1e-3)
        # radii are ceil(3σ) in pixels: once the states drift apart by
        # rounding, a σ on a pixel boundary moves one by 1
        np.testing.assert_allclose(taux.radii.numpy(),
                                   np.asarray(jaux.radii),
                                   atol=0 if it == 1 else 1)
    assert td.count == int(jd.count) == 3

    for name, a, b, a0 in zip(JG.GaussianParams._fields, ts.params,
                              js.params, js0.params):
        moved = np.abs(np.asarray(b) - np.asarray(a0)).max()
        assert moved > 0, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=max(0.05 * moved, 1e-7), err_msg=name)
    ref = TF.params_from_flax(_flat(jd.params), tf.net)
    ref0 = TF.params_from_flax(_flat(dstate.params), tf.net)
    for name, p in tf.net.named_parameters():
        moved = np.abs(ref[name].numpy() - ref0[name].numpy()).max()
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=max(0.05 * moved, 1e-7),
                                   err_msg=name)
    np.testing.assert_array_equal(ts.denom.numpy(), np.asarray(js.denom))
    np.testing.assert_allclose(ts.max_radii2d.numpy(),
                               np.asarray(js.max_radii2d), atol=1)
    ga = np.asarray(js.grad_accum)
    np.testing.assert_allclose(ts.grad_accum.numpy(), ga,
                               atol=1e-3 * np.abs(ga).max())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_train")
    data = write_blender_dataset(str(root / "data"), n_train=4, n_test=2,
                                 size=64)
    mp = str(root / "model")
    from d3gs_tpu_torch.train.__main__ import main
    result = main([
        "-s", data, "-m", mp, "--eval", "--is_blender", "--device", "cpu",
        "--iterations", "40", "--warm_up", "10", "--sequence_length", "4",
        "--sh_degree", "1", "--max_gaussians", "1500", "--D", "2",
        "--W", "32", "--densify_from_iter", "15", "--densify_until_iter",
        "25", "--densification_interval", "10", "--densify_grad_threshold",
        "0.00002", "--test_iterations", "40", "--position_lr_max_steps", "40",
        "--quiet"])
    return mp, result


def test_cli_trains_on_cpu(trained):
    mp, result = trained
    assert all(math.isfinite(v) for _, v in result.losses)
    assert math.isfinite(result.best_psnr) and result.best_psnr > 5
    assert result.best_iteration == 40
    # one densify pass (iteration 20) that changed the cloud
    [(it, n0, cap0, n1, cap1)] = result.densify_events
    assert it == 20 and n1 != n0 and cap0 == cap1 == 2048
    for f in ("cfg_args", "cameras.json",
              "point_cloud/iteration_40/point_cloud.ply",
              "deform/iteration_40/deform.npz"):
        assert os.path.exists(os.path.join(mp, f)), f


def test_checkpoint_loads_in_both_packages(trained):
    mp, result = trained
    ply = os.path.join(mp, "point_cloud", "iteration_40", "point_cloud.ply")
    js = jax_load_ply(ply, sh_degree=1)
    alive = result.state.alive.numpy()
    np.testing.assert_allclose(np.asarray(js.params.xyz)[:alive.sum()],
                               result.state.params.xyz.numpy()[alive],
                               rtol=1e-6)
    dstate, _ = create_deform_field(DeformFieldSpec(**SPEC),
                                    jax.random.PRNGKey(0))
    dstate = jax_load_npz(mp, dstate)
    ref = TF.params_from_flax(_flat(dstate.params), result.field.net)
    for name, p in result.field.net.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), ref[name].numpy())

    from d3gs_tpu_torch import render as trender
    out = trender.main(["-m", mp, "--mode", "render", "--device", "cpu",
                        "--skip_train"])
    assert out == {"iteration": 40, "views": 2}


def test_cli_raises_on_unported_trainers(tmp_path):
    """The flagship trainer and --base_model_path are ported (see
    test_torch_port_flagship.py); the multi-GPU mesh still raises."""
    from d3gs_tpu_torch.train.__main__ import main
    for trainer in ("baseline", "flagship"):
        with pytest.raises(NotImplementedError, match="slice 8"):
            main(["-s", str(tmp_path), "-m", str(tmp_path / "m"),
                  "--device", "cpu", "--trainer", trainer,
                  "--mesh_shape", "2"])
