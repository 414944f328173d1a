"""`tight_cull`, the exact tile cull of the port's binning
(d3gs_tpu_torch/ops/binning.py), against the JAX package on the CPU:

* the culled bins equal `d3gs_tpu.ops.binning.bin_splats_records(...,
  tight_cull=True)`: `starts`, `counts`, `rank_bounds` and each tile's
  Gaussian-id sequence, on every BLEND_CASES scene (two of them under a
  duplicate budget) and on strips at tile_y0 > 0, where the cull must read
  the absolute tile row; on the random scene the cull drops duplicates;
* the port's render with and without the cull: image, depth and alpha at
  the blend's forward tolerance (atol 5e-5 / rtol 1e-4), the parameter
  gradients within 2e-4 of the largest (tests/test_pallas_blend.py's);
  a pixel outside them would have to come from a duplicate whose largest
  alpha over its tile lies within 1e-5 (relative) of 1/255, and none may;
* two baseline train steps of `make_train_step` with the cull against
  JAX's with `tight_cull=True` (its Pallas path in interpret mode, the one
  that culls), at tests/test_torch_port_train.py's tolerances;
* the sharded render and the gauss+tile step with the cull on two gloo
  ranks against the port's single-device render and flagship step
  (tests/test_torch_port_parallel_steps.py's tolerances).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.config import OptimizationParams, PipelineParams
from d3gs_tpu.models import gaussians as JG
from d3gs_tpu.ops.binning import bin_splats_records
from d3gs_tpu.train.step import make_train_step as jax_make_train_step
from d3gs_tpu_torch import config as TC
from d3gs_tpu_torch.data.cameras import camera_from_matrices
from d3gs_tpu_torch.models.deform import fields as TF
from d3gs_tpu_torch.models.renderer import project_splats
from d3gs_tpu_torch.models.renderer import render as port_render
from d3gs_tpu_torch.ops.binning import bin_splats_records as bin_torch
from d3gs_tpu_torch.ops.binning import tile_max_power
from d3gs_tpu_torch.train import flagship as TFL
from d3gs_tpu_torch.train import step as TS
from tests.test_torch_port_flagship import _flat
from tests.test_torch_port_gaussians import to_torch
from tests.test_torch_port_parallel import fresh_cloud
from tests.test_torch_port_train import SPEC, scene, to_torch_camera  # noqa
from tests.test_train_static import gt_state, make_camera
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401
from tests.torch_port_fixtures import (BLEND_CASES, FOV, TX, TY, W,
                                       camera_mats, splats_to_torch, to_numpy)
from tests.torch_port_ranks import (camera_to_numpy, run_ranks,
                                    state_to_numpy)

ATOL, RTOL = 5e-5, 1e-4          # the blend's forward tolerance
GRAD_TOL = 2e-4                  # of the largest gradient
NEAR_ALPHA = 1e-5                # relative distance of a tile-max alpha
#                                  from 1/255 that could flip a pixel

# (tiles_y, tile_y0): the whole frame, the lower half, the last row
STRIPS = [(TY, 0), (2, 2), (1, 3)]


def _bins(make, dup, strip, cull):
    ty, y0 = strip
    splats = make()
    ref = to_numpy(bin_splats_records(splats, tiles_x=TX, tiles_y=ty,
                                      dup_capacity=dup, tile_y0=y0,
                                      tight_cull=cull))
    got = {k: v.numpy() for k, v in bin_torch(
        splats_to_torch(splats), tiles_x=TX, tiles_y=ty, dup_capacity=dup,
        tile_y0=y0, tight_cull=cull)._asdict().items()}
    return ref, got


@pytest.mark.parametrize("strip", STRIPS, ids=lambda s: f"{s[0]}@{s[1]}")
@pytest.mark.parametrize("case", BLEND_CASES, ids=lambda c: c[0])
def test_culled_bins_match_jax(case, strip):
    name, make, dup, _ = case
    ref, got = _bins(make, dup, strip, True)
    for k in ("starts", "counts", "rank_bounds"):
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    total = int(ref["starts"][-1])
    assert int(ref["rank_bounds"][-1]) == total
    np.testing.assert_array_equal(
        got["order"][got["rank_sorted"][:total]],
        ref["order"][ref["rank_sorted"][:total]])
    if name.startswith("random"):
        # the random scene's low-opacity Gaussians leave duplicates that no
        # pixel of their tile includes: the cull drops them
        uncut, _ = _bins(make, dup, strip, False)
        assert 0 < total < int(uncut["starts"][-1])


def _random_state():
    """tests/torch_port_fixtures.py's random scene as a state: 300 points,
    SH 1, opacity logits uniform in [-1, 3] (many faint Gaussians)."""
    n, cap = 300, 512
    rng = np.random.default_rng(3)
    pts = (rng.random((n, 3)) * 2.0 - 1.0).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    js = JG.create_from_pcd(pts, cols, sh_degree=1, capacity=cap)
    p = js.params
    return to_torch(JG.oneup_sh_degree(js.replace(params=p._replace(
        opacity=jnp.asarray(rng.uniform(-1, 3, (cap, 1)), jnp.float32),
        features_rest=jnp.asarray(rng.normal(0, 0.2, (cap, 3, 3)),
                                  jnp.float32)))))


def _saturated_state():
    """64 near-opaque Gaussians stacked in depth over tile (0, 0)."""
    n, cap = 64, 128
    xyz = np.stack([np.zeros(n), np.zeros(n), np.linspace(2.0, 3.0, n)],
                   axis=1).astype(np.float32)
    js = JG.create_from_pcd(xyz, np.full((n, 3), 0.5, np.float32),
                            sh_degree=0, capacity=cap)
    return to_torch(js.replace(params=js.params._replace(
        opacity=jnp.full((cap, 1), 8.0), scaling=jnp.full((cap, 3), -3.0))))


RENDER_SCENES = {"random": (_random_state, 3.0), "saturated": (
    _saturated_state, 4.0)}


def _render(st, cam, cull):
    params = [p.detach().clone().requires_grad_() for p in st.params]
    s = dataclasses.replace(st, params=type(st.params)(*params))
    out = port_render(s, cam, bg=torch.tensor([0.1, 0.2, 0.3]),
                      tight_cull=cull)
    w = torch.linspace(-1.0, 1.0, out.image.numel()).reshape(out.image.shape)
    loss = (w * out.image).sum() + 0.01 * out.depth.sum() + \
        0.1 * out.alpha.sum()
    grads = torch.autograd.grad(loss, params)
    return out, grads


def near_threshold_tiles(splats, tiles_x, tiles_y):
    """(T,) bool: tiles that hold a duplicate whose largest alpha over the
    tile lies within NEAR_ALPHA (relative) of 1/255."""
    bins = bin_torch(splats, tiles_x=tiles_x, tiles_y=tiles_y)
    near = torch.zeros(tiles_x * tiles_y, dtype=torch.bool)
    starts = bins.starts.long()
    gid = bins.order.long()[bins.rank_sorted.long()]
    tile = torch.repeat_interleave(torch.arange(tiles_x * tiles_y),
                                   starts[1:] - starts[:-1])
    mu, con = splats.means2d[gid], splats.conics[gid]
    pmax = tile_max_power(mu[:, 0], mu[:, 1], con[:, 0], con[:, 1],
                          con[:, 2], (tile % tiles_x).float(),
                          (tile // tiles_x).float())
    alpha = splats.opacities[gid] * torch.exp(pmax)
    hit = (alpha * 255.0 - 1.0).abs() <= NEAR_ALPHA
    near[tile[hit]] = True
    return near


@pytest.mark.parametrize("name", list(RENDER_SCENES))
def test_culled_render_equals_unculled(name):
    make, z = RENDER_SCENES[name]
    st = make()
    V, _ = camera_mats(z)
    cam = camera_from_matrices(V, FOV, FOV, fid=0.0,
                               image=np.zeros((W, W, 3), np.float32),
                               device="cpu")
    on, g_on = _render(st, cam, True)
    off, g_off = _render(st, cam, False)
    if name == "random":
        assert int(on.counts.sum()) < int(off.counts.sum())
    bad = torch.zeros((W, W), dtype=torch.bool)
    for a, b in zip((on.image, on.depth, on.alpha),
                    (off.image, off.depth, off.alpha)):
        a, b = a.detach(), b.detach()
        assert torch.isfinite(a).all()
        far = (a - b).abs() > ATOL + RTOL * b.abs()
        bad |= far if far.ndim == 2 else far.any(-1)
    # a flipped pixel must sit in a tile with a duplicate at the threshold
    splats = project_splats(st, cam)
    near = near_threshold_tiles(splats, TX, TX).reshape(TX, TX)
    near_px = near.repeat_interleave(16, 0).repeat_interleave(16, 1)
    assert not (bad & ~near_px).any(), "a pixel flipped away from 1/255"
    assert int(bad.sum()) == 0, f"{int(bad.sum())} flipped pixels"
    for pname, a, b in zip(type(st.params)._fields, g_on, g_off):
        scale = float(b.abs().max()) if b.numel() else 0.0
        if scale == 0:
            assert not a.any(), pname
            continue
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                   atol=GRAD_TOL, err_msg=pname)


def test_pipeline_params_take_the_cull():
    assert TC.PipelineParams(tight_cull=True).tight_cull
    with pytest.raises(ValueError, match="binning"):
        TC.PipelineParams(binning="sort", tight_cull=True)


def test_two_train_steps_with_the_cull_match_jax(scene):  # noqa: F811
    """A warm-up step and a deform step, each package with the cull, from
    the same carried state and MLP weights."""
    js, cams, dstate, field, tfield = scene
    opt = OptimizationParams(position_lr_max_steps=100, warm_up=2)
    # the Pallas path (interpreted on the CPU) is the JAX path that culls
    pipe = PipelineParams(binning="pallas", tight_cull=True)
    jwarm = jax_make_train_step(opt_cfg=opt, pipe_cfg=pipe, donate=False)
    jdef = jax_make_train_step(
        opt_cfg=opt, pipe_cfg=pipe, donate=False,
        deform_fn=lambda dp, xyz, fid, it, key: field.step(dp, xyz, fid),
        deform_update_fn=field.update)
    topt = TC.OptimizationParams(position_lr_max_steps=100, warm_up=2)
    tpipe = TC.PipelineParams(tight_cull=True)
    tf = TF.create_deform_field(TF.DeformFieldSpec(**SPEC), device="cpu",
                                opt_cfg=topt)
    tf.net.load_state_dict(tfield.net.state_dict())
    twarm = TS.make_train_step(opt_cfg=topt, pipe_cfg=tpipe)
    tdef = TS.make_train_step(
        opt_cfg=topt, pipe_cfg=tpipe,
        deform_fn=lambda xyz, fid, it, gen: tf.step(xyz, fid),
        deform_params=list(tf.net.parameters()), deform_update_fn=tf.update)
    uncut = TS.make_train_step(opt_cfg=topt, pipe_cfg=TC.PipelineParams())

    js0, ts = js, to_torch(js)
    jd, td = dstate, tf.init_state()
    key, bg = jax.random.PRNGKey(0), jnp.zeros(3)
    for it in (1, 2):
        cam = cams[it % 2]
        tcam = to_torch_camera(cam, cam.fid)
        if it < opt.warm_up:
            _, _, uaux = uncut(ts, None, tcam, it, None, torch.zeros(3))
            js, _, jaux = jwarm(js, None, cam, float(it), key, bg)
            ts, _, taux = twarm(ts, None, tcam, it, None, torch.zeros(3))
            # the step reports the surviving duplicates: fewer with the cull
            assert int(taux.dup_total) < int(uaux.dup_total)
        else:
            js, jd, jaux = jdef(js, jd, cam, float(it), key, bg)
            ts, td, taux = tdef(ts, td, tcam, it, None, torch.zeros(3))
        assert float(taux.loss) == pytest.approx(float(jaux.loss), rel=1e-3)
        np.testing.assert_allclose(taux.radii.numpy(),
                                   np.asarray(jaux.radii),
                                   atol=0 if it == 1 else 1)
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
    ga = np.asarray(js.grad_accum)
    np.testing.assert_allclose(ts.grad_accum.numpy(), ga,
                               atol=1e-3 * np.abs(ga).max())


# ---------------------------------------------------------------------------
# the strip blends with the cull on two gloo ranks
# ---------------------------------------------------------------------------

SIZE, FIDS, ITERATION = 64, (0.1, 0.5, 0.85), 50
OPT = dict(position_lr_max_steps=100)
MODEL = dict(is_blender=True, sh_degree=1, D=2, W=32)
COLORS = np.broadcast_to(np.array([0.7, 0.4, 0.2], np.float32),
                         (1024, 3)).copy()
BG = np.array([0.1, 0.2, 0.3], np.float32)


@pytest.fixture(scope="module")
def rank_inputs():
    """The port's own GT renders of a chunky cloud at three times, a fresh
    cloud to fit and the narrow Blender MLP; the JAX package only builds
    the two clouds."""
    gt = to_torch(gt_state(n=120, cap=1024))
    cams = []
    for k, fid in enumerate(FIDS):
        cam = to_torch_camera(make_camera(angle=0.4 + 0.9 * k, width=SIZE,
                                          height=SIZE), fid)
        with torch.no_grad():
            img = port_render(gt, cam, bg=torch.zeros(3)).image
        cams.append(dataclasses.replace(cam, image=img))
    tspec = TFL.pick_field_spec(TC.ModelParams(**MODEL),
                                TC.OptimizationParams(**OPT))
    net = TF.create_deform_field(tspec, seed=4, device="cpu").net
    weights = {k: v.detach().numpy().copy()
               for k, v in net.state_dict().items()}
    return gt, to_torch(fresh_cloud(9)), cams, dataclasses.asdict(tspec), \
        weights


@pytest.fixture(scope="module")
def culled_ranks(rank_inputs, tmp_path_factory):
    gt, st, cams, spec, weights = rank_inputs
    cull = {"tight_cull": True}
    render = ("render", "render", dict(
        state=state_to_numpy(gt), cam=camera_to_numpy(cams[0]),
        colors=COLORS, bg=BG, size=SIZE, pipe=cull))
    step = ("gauss_tile", "flagship_step", dict(
        layout="gauss_tile", state=state_to_numpy(st),
        cams=[camera_to_numpy(c) for c in cams],
        field=dict(spec=spec, weights=weights, opt=OPT), opt=OPT,
        model=MODEL, size=SIZE, iteration=ITERATION, pipe=cull))
    return run_ranks(2, str(tmp_path_factory.mktemp("cull_d2")),
                     [render, step])


def _rel(got, ref, tol, msg):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    assert np.isfinite(got).all(), msg
    if scale == 0:
        assert not got.any(), msg
        return
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol,
                               err_msg=msg)


def test_culled_sharded_render_matches_single_device(rank_inputs,
                                                     culled_ranks):
    gt, _, cams, _, _ = rank_inputs
    xyz = gt.params.xyz.clone().requires_grad_()
    out = port_render(dataclasses.replace(
        gt, params=gt.params._replace(xyz=xyz)), cams[0],
        override_color=torch.from_numpy(COLORS), bg=torch.from_numpy(BG))
    (g,) = torch.autograd.grad((out.image ** 2).sum(), [xyz])
    for r in culled_ranks:
        got = r["render"]
        for k in ("image", "depth", "alpha"):
            ref = getattr(out, k).detach().numpy()
            np.testing.assert_allclose(got[k], ref, atol=ATOL, rtol=RTOL,
                                       err_msg=k)
        np.testing.assert_array_equal(got["radii"], out.radii.numpy())
        _rel(got["grad_xyz"], g.numpy(), 1e-4, "grad_xyz")
    # the strips' culled duplicates: fewer than the uncut frame's
    culled = int(culled_ranks[0]["render"]["counts"].sum())
    assert culled < int(out.counts.sum())


def test_culled_gauss_tile_step_matches_single_device(rank_inputs,
                                                      culled_ranks):
    _, st, cams, spec, weights = rank_inputs
    field = TF.create_deform_field(TF.DeformFieldSpec(**spec), device="cpu",
                                   opt_cfg=TC.OptimizationParams(**OPT))
    field.net.load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
    step = TFL.make_batched_step(
        opt_cfg=TC.OptimizationParams(**OPT), pipe_cfg=TC.PipelineParams(),
        model_cfg=TC.ModelParams(**MODEL), field=field,
        update_gaussians=True, update_deform=True, use_deform=True)
    ts, td, aux = step(st, field.init_state(), cams, ITERATION,
                       torch.zeros(3))
    for r, res in enumerate(culled_ranks):
        got, msg = res["gauss_tile"], f"rank {r}"
        assert got["loss"] == pytest.approx(float(aux.loss), rel=1e-5), msg
        assert got["l1"] == pytest.approx(float(aux.l1), rel=1e-5), msg
        s = got["state"]
        for name, m, ref in zip(type(ts.params)._fields, s["m"], ts.opt.m):
            _rel(m, ref.numpy(), 1e-4, f"{msg}: m.{name}")
        np.testing.assert_array_equal(s["denom"], ts.denom.numpy())
        np.testing.assert_array_equal(s["max_radii2d"],
                                      ts.max_radii2d.numpy())
        _rel(s["grad_accum"], ts.grad_accum.numpy(), 1e-4, "grad_accum")
        for (pname, _), m, ref in zip(field.net.named_parameters(),
                                      got["deform_m"], td.m):
            _rel(m, ref.numpy(), 1e-4, f"{msg}: {pname}")


def test_tile_max_power_bounds_every_pixel():
    """The closed form is the maximum of the exponent over the tile's
    pixels (checked on a dense grid of random ellipses)."""
    rng = np.random.default_rng(11)
    n = 400
    mu = torch.from_numpy(rng.uniform(-20, 60, (n, 2)).astype(np.float32))
    a = rng.uniform(0.01, 1.0, n)
    c = rng.uniform(0.01, 1.0, n)
    b = rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c)
    con = torch.from_numpy(np.stack([a, b, c], 1).astype(np.float32))
    pmax = tile_max_power(mu[:, 0], mu[:, 1], con[:, 0], con[:, 1],
                          con[:, 2], torch.ones(n), torch.ones(n))
    px = torch.arange(16.0, 32.0)
    dx = px[None, :, None] - mu[:, None, None, 0]
    dy = px[None, None, :] - mu[:, None, None, 1]
    p = (-0.5 * (con[:, 0, None, None] * dx * dx
                 + con[:, 2, None, None] * dy * dy)
         - con[:, 1, None, None] * dx * dy).amax((1, 2))
    assert (pmax >= p - 1e-4 * (1 + p.abs())).all()
