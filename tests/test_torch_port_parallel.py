"""The port's multi-rank layer (d3gs_tpu_torch/parallel/) against the JAX
package's (d3gs_tpu/parallel/) on the CPU: gloo ranks spawned once per
group of checks (tests/torch_port_ranks.py), JAX's shard_map functions on a
mesh of as many of conftest's CPU devices.

* the strip pieces: `bin_splats_records(tile_y0=...)` equal to JAX's, the
  plain blends at a tile-row offset against the Pallas blend in interpret
  mode (forward atol 5e-5 / rtol 1e-4, backward 2e-4 of the largest
  gradient, tests/test_pallas_blend.py's), strips that concatenate to the
  whole frame;
* the sharded render at D = 2 and 4 against JAX's `make_sharded_render`
  (image atol 1e-5, depth 1e-4, radii exact, tests/test_parallel.py's) and
  against the port's single-device render, and its gradient against the
  single-device one (1e-4 of the largest);
* one step of `make_sharded_train_step` against JAX's (loss rel 1e-5, the
  first Adam moments 1e-4 of the largest, denom and max_radii2d exact);
* a densify pass on the sharded state (gather, densify, re-shard) equal to
  the single-device pass, and the halo exchange with its backward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.config import OptimizationParams, PipelineParams
from d3gs_tpu.models import gaussians as JG
from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
from d3gs_tpu.models.renderer import render as jax_render
from d3gs_tpu.ops.binning import bin_splats_records
from d3gs_tpu.ops.pallas_blend import blend_records_pallas
from d3gs_tpu.ops.rasterize import pack_records
from d3gs_tpu.parallel.mesh import make_mesh, replicate, shard_gaussian_state
from d3gs_tpu.parallel.sharded import (make_sharded_render,
                                       make_sharded_train_step)
from d3gs_tpu_torch import config as TC
from d3gs_tpu_torch.models.deform import fields as TF
from d3gs_tpu_torch.models.renderer import render as port_render
from d3gs_tpu_torch.ops import blend as B
from d3gs_tpu_torch.ops.binning import bin_splats_records as bin_torch
from tests.test_torch_port_flagship import _flat
from tests.test_torch_port_gaussians import to_torch
from tests.test_torch_port_train import to_torch_camera
from tests.test_train_static import gt_state, make_camera
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401
from tests.torch_port_fixtures import (TX, W, random_scene_splats,
                                       splats_to_torch, to_numpy)
from tests.torch_port_ranks import (camera_to_numpy, run_ranks,
                                    state_to_numpy)

CAP = 1024
SIZE = 64
COLORS = np.broadcast_to(np.array([0.7, 0.4, 0.2], np.float32),
                         (CAP, 3)).copy()
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _rel(got, ref, tol, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0 and np.isfinite(got).all(), msg
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# strips: binning and the plain blends at a tile-row offset
# ---------------------------------------------------------------------------

# (tiles_y of the strip, tile_y0): the lower half, a middle row, the last
STRIPS = [(2, 2), (1, 1), (1, 3)]


@pytest.mark.parametrize("strip", STRIPS, ids=lambda s: f"{s[0]}@{s[1]}")
def test_offset_binning_matches_jax(strip):
    ty, y0 = strip
    splats = random_scene_splats()
    ref = to_numpy(bin_splats_records(splats, tiles_x=TX, tiles_y=ty,
                                      tile_y0=y0))
    got = {k: v.numpy() for k, v in bin_torch(
        splats_to_torch(splats), tiles_x=TX, tiles_y=ty,
        tile_y0=y0)._asdict().items()}
    for k in ("starts", "counts", "rank_bounds"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    total = int(ref["starts"][-1])
    assert total > 0
    np.testing.assert_array_equal(got["order"][got["rank_sorted"]],
                                  ref["order"][ref["rank_sorted"][:total]])


def test_offset_binning_at_zero_is_the_unsharded_binning():
    t = splats_to_torch(random_scene_splats())
    a = bin_torch(t, tiles_x=TX, tiles_y=4)
    b = bin_torch(t, tiles_x=TX, tiles_y=4, tile_y0=0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("strip", STRIPS, ids=lambda s: f"{s[0]}@{s[1]}")
def test_offset_plain_blends_match_pallas(strip):
    ty, y0 = strip
    splats = random_scene_splats()
    bins = bin_splats_records(splats, tiles_x=TX, tiles_y=ty, tile_y0=y0)
    records = pack_records(splats)
    grid = dict(tiles_x=TX, tiles_y=ty, width=W, height=16 * ty)
    target = np.full((16 * ty, W, 3), 0.5, np.float32)

    def f(r, b):
        img, dep, alp = blend_records_pallas(r, bins, b, interpret=True,
                                             tile_y0=y0, **grid)
        return ((img - target) ** 2).sum() + 0.01 * dep.sum() \
            + 0.02 * alp.sum(), (img, dep, alp)

    (_, ref), (g_ref, _) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(
        records, jnp.asarray(BG))
    tbins = bin_torch(splats_to_torch(splats), tiles_x=TX, tiles_y=ty,
                      tile_y0=y0)
    r = torch.tensor(np.asarray(records), requires_grad=True)
    img, dep, alp = B.blend_records(r, tbins, torch.from_numpy(BG),
                                    tile_y0=y0, **grid)
    for got, want in zip((img, dep, alp), ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=5e-5, rtol=1e-4)
    (((img - torch.from_numpy(target)) ** 2).sum() + 0.01 * dep.sum()
     + 0.02 * alp.sum()).backward()
    _rel(r.grad.numpy(), np.asarray(g_ref), 2e-4)


def test_strips_concatenate_to_the_frame():
    """Two strips of two tile rows, blended at tile_y0 = 0 and 2, are the
    whole frame's rows; their record gradients sum to the frame's."""
    t = splats_to_torch(random_scene_splats())
    from d3gs_tpu_torch.ops.rasterize import pack_records as tpack
    rec = tpack(t)
    bg = torch.from_numpy(BG)
    full = B.blend_forward_torch(rec, bin_torch(t, tiles_x=TX, tiles_y=4),
                                 bg, tiles_x=TX, tiles_y=4, width=W,
                                 height=64)
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, W, 3)).astype(np.float32))
    z = torch.zeros(64, W)
    g_full = B.blend_backward_torch(
        rec, bin_torch(t, tiles_x=TX, tiles_y=4), bg, full, g, z, z,
        tiles_x=TX, tiles_y=4, width=W, height=64, depth_grad=False)
    g_sum = torch.zeros_like(g_full)
    for y0 in (0, 2):
        bins = bin_torch(t, tiles_x=TX, tiles_y=2, tile_y0=y0)
        grid = dict(tiles_x=TX, tiles_y=2, width=W, height=32, tile_y0=y0)
        out = B.blend_forward_torch(rec, bins, bg, **grid)
        rows = slice(16 * y0, 16 * y0 + 32)
        np.testing.assert_allclose(out.image.numpy(),
                                   full.image[rows].numpy(), atol=1e-6)
        g_sum += B.blend_backward_torch(rec, bins, bg, out, g[rows],
                                        z[:32], z[:32], depth_grad=False,
                                        **grid)
    _rel(g_sum.numpy(), g_full.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# the sharded render and the baseline sharded step, on gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    gt = gt_state(n=150, cap=CAP)
    cam = make_camera(0.3, width=SIZE, height=SIZE)
    return gt, cam


def fresh_cloud(seed: int):
    """A fresh SH-1 cloud to fit, with anisotropic rotated Gaussians and
    live higher bands (as tests/test_torch_port_flagship.py's scene: with
    equal axes the rotation's gradient is rounding noise)."""
    rng = np.random.default_rng(seed)
    n = 150
    js = JG.create_from_pcd(rng.normal(0, 0.6, (n, 3)).astype(np.float32),
                            rng.uniform(0.2, 1, (n, 3)).astype(np.float32),
                            sh_degree=1, capacity=CAP, spatial_lr_scale=2.0)
    quats = rng.normal(size=(CAP, 4)).astype(np.float32)
    quats[:, 0] += 2.0
    p = js.params
    return JG.oneup_sh_degree(js.replace(params=p._replace(
        scaling=p.scaling + jnp.asarray(rng.normal(0, 0.4, (CAP, 3)),
                                        jnp.float32),
        rotation=jnp.asarray(quats),
        features_rest=jnp.asarray(rng.normal(0, 0.1, (CAP, 3, 3)),
                                  jnp.float32))))


@pytest.fixture(scope="module")
def step_inputs():
    """A fresh cloud to fit to a GT render at one time."""
    gt = gt_state(n=120, cap=CAP)
    cam = make_camera(angle=0.7, width=SIZE, height=SIZE)
    img = jax_render(gt, cam, bg=jnp.zeros(3), tile_capacity=256,
                     tile_chunk=8).image
    cam = dataclasses.replace(cam, image=img,
                              fid=jnp.asarray(0.4, jnp.float32))
    return fresh_cloud(5), cam


WARP = dict(kind="warp", is_blender=True, D=2, W=32)
OPT = dict(position_lr_max_steps=100)


@pytest.fixture(scope="module")
def ranks(scene, step_inputs, tmp_path_factory):
    """One spawn per world size: the render at D = 2 and 4, the baseline
    step and the densify pass at D = 2, the halo exchange at D = 4."""
    gt, cam = scene
    st, scam = step_inputs
    dstate, _ = create_deform_field(DeformFieldSpec(**WARP),
                                    jax.random.PRNGKey(0))
    tfield = TF.create_deform_field(TF.DeformFieldSpec(**WARP), device="cpu")
    weights = {k: v.numpy() for k, v in TF.params_from_flax(
        _flat(dstate.params), tfield.net).items()}
    render = ("render", "render", dict(
        state=state_to_numpy(to_torch(gt)),
        cam=camera_to_numpy(to_torch_camera(cam, 0.0)), colors=COLORS,
        bg=BG, size=SIZE))
    step = ("baseline_step", "baseline_step", dict(
        state=state_to_numpy(to_torch(st)),
        cam=camera_to_numpy(to_torch_camera(scam, scam.fid)),
        field=dict(spec=WARP, weights=weights, opt=OPT), opt=OPT,
        size=SIZE, iteration=5))
    stats = to_torch(st)
    rng = np.random.default_rng(7)
    stats.grad_accum = torch.from_numpy(
        rng.uniform(0, 3e-4, CAP).astype(np.float32))
    stats.denom = torch.from_numpy(
        rng.integers(0, 3, CAP).astype(np.float32))
    stats.max_radii2d = torch.from_numpy(
        rng.uniform(0, 30, CAP).astype(np.float32))
    densify = ("densify", "densify", dict(state=state_to_numpy(stats),
                                          seed=3, extent=4.0))
    x = np.random.default_rng(1).normal(size=(2, 64, 8, 3)).astype(
        np.float32)
    halo = ("halo", "halo", dict(x=x, rows=5))
    root = tmp_path_factory.mktemp("parallel_ranks")
    return {2: run_ranks(2, str(root / "d2"), [render, step, densify]),
            4: run_ranks(4, str(root / "d4"), [render, halo]),
            "stats": stats, "halo_x": x, "dstate": dstate}


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_render_matches_jax(scene, ranks, d):
    gt, cam = scene
    mesh = make_mesh(jax.devices()[:d])
    st = shard_gaussian_state(gt, mesh)
    render_fn = make_sharded_render(
        mesh, width=SIZE, height=SIZE,
        pipe_cfg=PipelineParams(tile_capacity=256, tile_chunk=8))
    img, dep, alp, radii, counts = jax.jit(render_fn)(
        st.params.xyz, st.get_scaling, st.params.rotation,
        jnp.asarray(COLORS), st.get_opacity[:, 0], st.alive, cam,
        jnp.asarray(BG), jnp.zeros((CAP, 2)))
    for r in ranks[d]:
        got = r["render"]
        np.testing.assert_allclose(got["image"], np.asarray(img), atol=1e-5)
        np.testing.assert_allclose(got["depth"], np.asarray(dep), atol=1e-4)
        np.testing.assert_allclose(got["alpha"], np.asarray(alp), atol=1e-5)
        np.testing.assert_array_equal(got["radii"], np.asarray(radii))
        np.testing.assert_array_equal(got["counts"], np.asarray(counts))


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_render_matches_single_device_port(scene, ranks, d):
    gt, cam = scene
    tcam = to_torch_camera(cam, 0.0)
    st = to_torch(gt)
    xyz = st.params.xyz.clone().requires_grad_()
    out = port_render(dataclasses.replace(
        st, params=st.params._replace(xyz=xyz)), tcam,
        override_color=torch.from_numpy(COLORS), bg=torch.from_numpy(BG))
    (g,) = torch.autograd.grad((out.image ** 2).sum(), [xyz])
    got = ranks[d][0]["render"]
    np.testing.assert_allclose(got["image"], out.image.detach().numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(got["depth"], out.depth.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(got["radii"], out.radii.numpy())
    # the all-gather's reduce-scatter brings every strip's gradient home
    _rel(got["grad_xyz"], g.numpy(), 1e-4)


def test_sharded_train_step_matches_jax(step_inputs, ranks):
    st, cam = step_inputs
    mesh = make_mesh(jax.devices()[:2])
    _, field = create_deform_field(DeformFieldSpec(**WARP),
                                   jax.random.PRNGKey(0))
    step = make_sharded_train_step(
        mesh, opt_cfg=OptimizationParams(**OPT),
        pipe_cfg=PipelineParams(tile_capacity=256, tile_chunk=8),
        width=SIZE, height=SIZE, field=field)
    js, jd, aux = step(shard_gaussian_state(st, mesh),
                       replicate(ranks["dstate"], mesh), cam,
                       jnp.asarray(5.0, jnp.float32), jnp.zeros(3))
    for r in ranks[2]:
        got = r["baseline_step"]
        assert got["loss"] == pytest.approx(float(aux.loss), rel=1e-5)
        assert got["l1"] == pytest.approx(float(aux.l1), rel=1e-5)
        s = got["state"]
        for name, m, ref in zip(JG.GaussianParams._fields, s["m"], js.opt.m):
            _rel(m, np.asarray(ref), 1e-4, name)
        np.testing.assert_array_equal(s["denom"], np.asarray(js.denom))
        np.testing.assert_array_equal(s["max_radii2d"],
                                      np.asarray(js.max_radii2d))
        _rel(s["grad_accum"], np.asarray(js.grad_accum), 1e-4)
        tnet = TF.create_deform_field(TF.DeformFieldSpec(**WARP),
                                      device="cpu").net
        ref = TF.params_from_flax(_flat(jd.m), tnet)
        for (name, _), m in zip(tnet.named_parameters(), got["deform_m"]):
            _rel(m, ref[name].numpy(), 1e-4, name)


def test_densify_on_the_sharded_state_equals_single_device(ranks):
    from d3gs_tpu_torch.train.step import densify_fns
    densify = densify_fns(TC.OptimizationParams(
        densify_grad_threshold=1e-4))[0]
    ref = densify(ranks["stats"], torch.Generator().manual_seed(3), 20.0,
                  4.0)
    for r in ranks[2]:
        got = r["densify"]["state"]
        np.testing.assert_array_equal(got["alive"], ref.alive.numpy())
        for a, b in zip(got["params"], ref.params):
            np.testing.assert_array_equal(a, b.numpy())
        for a, b in zip(got["m"], ref.opt.m):
            np.testing.assert_array_equal(a, b.numpy())
    assert ref.num_alive != int(ranks["stats"].alive.sum())


def test_halo_rows_and_their_gradient(ranks):
    """Each strip extended by 5 rows of its neighbours (zeros beyond the
    outer strips) is the zero-padded frame's rows; the backward returns
    every row's gradient to its owner, as autograd through the padded
    frame does."""
    x = ranks["halo_x"]
    k, h = x.shape[0], x.shape[1] // 4
    xt = torch.from_numpy(x).requires_grad_()
    pad = torch.cat([torch.zeros(k, 5, 8, 3), xt, torch.zeros(k, 5, 8, 3)],
                    dim=1)
    total = 0.0
    for s in range(4):
        ext = pad[:, s * h:s * h + h + 10]
        wts = torch.arange(ext.numel(), dtype=ext.dtype).reshape(ext.shape)
        total = total + (ext * wts.sin()).sum()
        np.testing.assert_array_equal(ranks[4][s]["halo"]["ext"],
                                      ext.detach().numpy())
    (g,) = torch.autograd.grad(total, [xt])
    got = np.concatenate([ranks[4][s]["halo"]["grad"] for s in range(4)],
                         axis=1)
    np.testing.assert_allclose(got, g.numpy(), rtol=1e-6, atol=1e-5)
    # the inner strips send 5 rows each way, the outer ones one way
    b = [ranks[4][s]["halo"]["bytes"]["halo"] for s in range(4)]
    row = k * 5 * 8 * 3 * 4
    assert b == [2 * row, 4 * row, 4 * row, 2 * row]


def test_padded_camera_picks_match_jax(monkeypatch):
    """The camera layout's batches: k = 3 picks padded to a multiple of
    D = 2 with cameras drawn again from the same `random.Random`, and
    1/copies weights, equal to what JAX's trainer hands its
    camera-parallel step on a mesh of 2."""
    import types

    import d3gs_tpu.parallel.sharded as JS
    import d3gs_tpu.train.flagship as JF
    from d3gs_tpu.config import ModelParams
    from d3gs_tpu_torch.train.flagship import BatchPicker
    cams = [types.SimpleNamespace(fid=np.float32(f)) for f in
            np.random.default_rng(0).permutation(np.linspace(0, 1, 10))]
    seen = []

    def recorder_factory(mesh, **kw):
        def step(state, dstate, batch, it, key, bg, wts):
            seen.append(([float(c.fid) for c in batch],
                         [float(w) for w in wts]))
            return state, dstate, 0.0, 0.0, 0
        return step

    monkeypatch.setattr(JS, "make_flagship_camera_parallel_step",
                        recorder_factory)
    monkeypatch.setattr(JF, "stack_cameras", list)
    opt = OptimizationParams(iterations=17, warm_up=5, num_cams_per_iter=3,
                             densify_until_iter=0)
    JF.train_flagship(gaussians=None, train_cams=cams, test_cams=[],
                      cameras_extent=1.0,
                      model_cfg=ModelParams(is_blender=True, D=2, W=8),
                      opt_cfg=opt, pipe_cfg=PipelineParams(), seed=3,
                      progress=False, mesh=make_mesh(jax.devices()[:2]))
    pick = BatchPicker(cams, k=3, sequence_length=0, spread_out=False,
                       seed=3, pad_to=2)
    ours = []
    for _ in range(17):
        batch = pick()
        ours.append(([float(c.fid) for c in batch],
                     BatchPicker.weights(batch)))
    assert ours == seen
    assert all(len(b) == 4 and sum(w) == pytest.approx(3) for b, w in ours)
