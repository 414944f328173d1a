"""The port's SAM-variant trainer against the JAX package on the CPU.

* `project_to_pixels`: pixel coordinates within 1e-5 relative (1e-4 px
  absolute), the in-frame masks equal, with points off the frame, behind
  the camera and on its plane (|w| < 1e-7).
* `mask_regularization`: the value within 1e-5 relative and its gradients
  with respect to d_xyz, d_rotation and d_scaling within 1e-5 of their
  largest entry, against jax.grad, on a label map with empty segments, a
  single-member segment, off-frame, behind-camera and dead Gaussians.
* `slic_label_map`, `masks_to_label_map`, the cache files of
  `load_or_generate_label_maps`: bit-equal.
* The label-map reader against PIL (paletted 1/4/8-bit, 8/16-bit gray,
  RGB, RGBA) and `load_label_maps` against JAX's: bit-equal.
* One deform step with the mask term: the loss against JAX's
  `make_train_step(extra_loss_fn=...)` within 1e-5 relative, the Gaussian
  and deform gradients against jax.value_and_grad of the same loss within
  1e-4 of their largest entry (the tolerance of
  test_torch_port_train.py's step without the term), the deform
  parameters after the step within 5 % of their motion.
* `python -m d3gs_tpu_torch.train_baseline_sam --device cpu` end to end
  with `--segmenter slic`, `--segmenter grid` and `--mask_dir`.
"""
import dataclasses
import math
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.config import OptimizationParams, PipelineParams
from d3gs_tpu.models.renderer import render as jax_render
from d3gs_tpu.ops.losses import l1_loss, ssim
from d3gs_tpu.train import sam_reg as JS
from d3gs_tpu.train import segment as JSeg
from d3gs_tpu.train.step import make_train_step as jax_make_train_step
from d3gs_tpu_torch import config as TC
from d3gs_tpu_torch.data.image_io import read_label_png
from d3gs_tpu_torch.train import sam_reg as TS
from d3gs_tpu_torch.train import segment as TSeg
from d3gs_tpu_torch.train import step as TStep
from tests.test_cli_end_to_end import write_blender_dataset
from tests.test_torch_port_gaussians import to_torch
from tests.test_torch_port_train import SPEC, _flat, to_torch_camera
from tests.test_train_static import gt_state, make_camera
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401
from d3gs_tpu_torch.models.deform import fields as TF

SIZE = 64


def _t(x):
    return torch.from_numpy(np.array(x))


def _points(rng):
    """Points in and around the view of `make_camera`: a cloud around the
    origin, some far off to the side, some behind the camera."""
    pts = [rng.normal(0, 0.8, (150, 3)), rng.normal(0, 0.5, (20, 3))
           + [9.0, 0.0, 0.0], rng.normal(0, 0.5, (20, 3)) + [0.0, 0.0, -9.0]]
    return np.concatenate(pts).astype(np.float32)


def test_project_to_pixels_matches_jax():
    cam = make_camera(0.4, width=SIZE, height=SIZE)
    xyz = _points(np.random.default_rng(0))
    jpx, jin = JS.project_to_pixels(jnp.asarray(xyz), cam.projmatrix,
                                    SIZE, SIZE)
    tpx, tin = TS.project_to_pixels(_t(xyz), _t(cam.projmatrix), SIZE, SIZE)
    jin = np.asarray(jin)
    np.testing.assert_array_equal(tin.numpy(), jin)
    assert 0 < jin.sum() < len(xyz) - 40, "in, off and behind the frame"
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), rtol=1e-5,
                               atol=1e-4)
    # on the camera plane: a projection whose w is z exactly, so w = ±1e-8,
    # 0 and ±5e-7 are what they say (a tiny negative w becomes +1e-7)
    proj = np.eye(4, dtype=np.float32)
    proj[2, 3], proj[3, 3] = 1.0, 0.0
    z = np.array([1e-8, -1e-8, 0.0, 5e-7, -5e-7], np.float32)
    pts = np.stack([np.full(5, 1e-6), np.full(5, -2e-6), z], 1).astype(
        np.float32)
    jpx, jin = JS.project_to_pixels(jnp.asarray(pts), jnp.asarray(proj),
                                    SIZE, SIZE)
    tpx, tin = TS.project_to_pixels(_t(pts), _t(proj), SIZE, SIZE)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), rtol=1e-6)
    assert tpx[1, 0] == tpx[2, 0] > 0, "w = -1e-8 and 0 both divide by 1e-7"


@pytest.fixture(scope="module")
def reg_inputs():
    """A 4x4-grid label map with 6 labels beyond it (empty), one label on
    exactly one Gaussian's pixel, a background band (0), and Gaussians in,
    off and behind the frame, the buffer's tail dead."""
    cap, num_masks = 256, 22
    cam = make_camera(0.4, width=SIZE, height=SIZE)
    rng = np.random.default_rng(1)
    xyz = np.zeros((cap, 3), np.float32)
    pts = _points(rng)
    xyz[:len(pts)] = pts
    alive = np.arange(cap) < len(pts)
    alive[5] = False
    labels = JS.grid_label_map(SIZE, SIZE, cells=4)
    labels[:, :6] = 0
    px, inf = JS.project_to_pixels(jnp.asarray(xyz), cam.projmatrix,
                                   SIZE, SIZE)
    pix = np.clip(np.asarray(px).astype(np.int32), 0, SIZE - 1)
    members = np.flatnonzero(np.asarray(inf) & alive)
    hits = {}
    for i in members:
        hits.setdefault((pix[i, 1], pix[i, 0]), []).append(i)
    lone = next(k for k, v in hits.items() if len(v) == 1 and k[1] >= 6)
    labels[lone] = num_masks
    d = [rng.normal(0, s, (cap, k)).astype(np.float32)
         for s, k in ((0.1, 3), (0.05, 4), (0.02, 3))]
    return SimpleNamespace(cam=cam, xyz=xyz, alive=alive, labels=labels,
                           num_masks=num_masks, d=d)


def _jax_reg(r, d):
    return JS.mask_regularization(
        jnp.asarray(r.labels), r.num_masks, jnp.asarray(r.xyz),
        r.cam.projmatrix, *d, jnp.asarray(r.alive), SIZE, SIZE)


def _torch_reg(r, d):
    return TS.mask_regularization(
        _t(r.labels), r.num_masks, _t(r.xyz), _t(r.cam.projmatrix), *d,
        _t(r.alive), SIZE, SIZE)


def test_mask_regularization_and_grads_match_jax(reg_inputs):
    r = reg_inputs
    ref, grads = jax.value_and_grad(
        lambda *d: _jax_reg(r, d), argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in r.d))
    td = [_t(x).requires_grad_() for x in r.d]
    got = _torch_reg(r, td)
    tg = torch.autograd.grad(got, td)
    assert float(ref) > 0
    assert float(got.detach()) == pytest.approx(float(ref), rel=1e-5)
    for name, a, b in zip(("d_xyz", "d_rotation", "d_scaling"), tg, grads):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-5,
                                   err_msg=name)
    # the scalar outputs of the warp kind count nothing, as in JAX
    warp = (r.d[0], 0.0, 0.0)
    assert float(_torch_reg(r, (_t(warp[0]), 0.0, 0.0))) == pytest.approx(
        float(_jax_reg(r, (jnp.asarray(warp[0]), 0.0, 0.0))), rel=1e-5)


def test_grid_label_map_matches_jax():
    for h, w, cells in ((64, 64, 8), (37, 53, 5)):
        np.testing.assert_array_equal(TS.grid_label_map(h, w, cells),
                                      JS.grid_label_map(h, w, cells))


def _blob_image(rng, h=40, w=48):
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(5):
        c, s, col = rng.uniform(0, 1, 2), rng.uniform(0.1, 0.3), \
            rng.uniform(0, 1, 3)
        img += np.exp(-((yy - c[0]) ** 2 + (xx - c[1]) ** 2)
                      / s ** 2)[..., None] * col
    return np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(
        np.float32)


def test_slic_and_masks_to_label_map_bit_equal():
    rng = np.random.default_rng(2)
    img = _blob_image(rng)
    for n in (9, 16, 30):
        np.testing.assert_array_equal(TSeg.slic_label_map(img, n_segments=n),
                                      JSeg.slic_label_map(img, n_segments=n))
    masks = rng.random((7, 20, 24)) < rng.uniform(0.05, 0.6, (7, 1, 1))
    for num in (3, 7, 10):
        np.testing.assert_array_equal(TSeg.masks_to_label_map(masks, num),
                                      JSeg.masks_to_label_map(masks, num))
    lab2d = rng.integers(-2, 12, (20, 24))
    np.testing.assert_array_equal(TSeg.masks_to_label_map(lab2d, 9),
                                  JSeg.masks_to_label_map(lab2d, 9))


def test_load_or_generate_label_maps_cache_files_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    images = [_blob_image(rng, 32, 36) for _ in range(3)]
    cam = make_camera(0.0, width=36, height=32)
    jcams = [dataclasses.replace(cam, image=jnp.asarray(im),
                                 image_name=f"r_{i}")
             for i, im in enumerate(images)]
    tcams = [SimpleNamespace(image=torch.from_numpy(im), image_name=f"r_{i}")
             for i, im in enumerate(images)]
    roots = {k: tmp_path / k for k in ("jax", "torch")}
    # a SAM2-style (M, H, W) bool stack already cached for r_2
    sam = rng.random((4, 32, 36)) < 0.3
    for root in roots.values():
        os.makedirs(root / "sam_masks_cache")
        np.save(root / "sam_masks_cache" / "r_2_mask.npy", sam)
    jm = JSeg.load_or_generate_label_maps(jcams, str(roots["jax"]),
                                          num_masks=16, method="slic",
                                          progress=False)
    tm = TSeg.load_or_generate_label_maps(tcams, str(roots["torch"]),
                                          num_masks=16, method="slic",
                                          progress=False)
    assert sorted(tm) == sorted(jm) == ["r_0", "r_1", "r_2"]
    for k in jm:
        assert tm[k].dtype == jm[k].dtype == np.int32
        np.testing.assert_array_equal(tm[k], jm[k])
        a, b = (np.load(roots[s] / "sam_masks_cache" / f"{k}_mask.npy")
                for s in ("torch", "jax"))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the second call reads the cache
    tm2 = TSeg.load_or_generate_label_maps(tcams, str(roots["torch"]),
                                           num_masks=16, progress=False)
    for k in tm:
        np.testing.assert_array_equal(tm2[k], tm[k])


def _label_pngs(root, rng):
    from PIL import Image
    out = {}
    h, w = 29, 43
    for bits, ncol in ((1, 2), (4, 16), (8, 200)):
        im = Image.new("P", (w, h))
        im.putpalette([int(x) for x in rng.integers(0, 256, 768)])
        im.putdata([int(x) for x in rng.integers(0, ncol, h * w)])
        out[f"p{bits}"] = (im, {"bits": bits})
    out["g8"] = (Image.fromarray(rng.integers(0, 256, (h, w)).astype(
        np.uint8)), {})
    out["g16"] = (Image.fromarray(rng.integers(0, 65536, (h, w)).astype(
        np.uint16)), {})
    for mode, ch in (("RGB", 3), ("RGBA", 4)):
        out[mode] = (Image.fromarray(rng.integers(0, 256, (h, w, ch)).astype(
            np.uint8), mode), {})
    for name, (im, kw) in out.items():
        im.save(os.path.join(root, name + ".png"), **kw)
    return sorted(out)


def test_label_reader_and_load_label_maps_match_pil(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(4)
    names = _label_pngs(str(tmp_path), rng)
    for name in names:
        path = str(tmp_path / (name + ".png"))
        ref = np.asarray(Image.open(path), dtype=np.int64)
        ref = ref[..., 0] if ref.ndim == 3 else ref
        got = read_label_png(path)
        assert got.shape == ref.shape, name
        np.testing.assert_array_equal(got.astype(np.int64), ref,
                                      err_msg=name)
    np.save(tmp_path / "n.npy", rng.integers(-3, 90, (29, 43)))
    names = names + ["n", "missing"]
    for num in (12, 64):
        tm = TS.load_label_maps(str(tmp_path), names, num)
        jm = JS.load_label_maps(str(tmp_path), names, num)
        assert sorted(tm) == sorted(jm) and "missing" not in tm
        for k in jm:
            assert tm[k].dtype == jm[k].dtype == np.int32
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    Image.fromarray(rng.integers(0, 256, (5, 5, 2)).astype(np.uint8),
                    "LA").save(tmp_path / "la.png")
    with pytest.raises(ValueError, match="color type 4"):
        read_label_png(str(tmp_path / "la.png"))


# ---- one deform step with the mask term ------------------------------

WEIGHT = 20.0     # makes the mask term a sizeable share of the loss
NUM_MASKS = 16


def _jax_extra(labels):
    def extra_loss(out, deform_out, camera, state, aux):
        dx, dr, ds = deform_out
        xyz = state.params.xyz
        deformed = xyz + dx if isinstance(dx, type(xyz)) else xyz
        return WEIGHT * JS.mask_regularization(
            aux, NUM_MASKS, deformed, camera.projmatrix, dx, dr, ds,
            state.alive, camera.width, camera.height)
    return extra_loss


def _torch_extra(out, deform_out, camera, state, labels):
    dx, dr, ds = deform_out
    xyz = state.params.xyz
    deformed = xyz + dx if torch.is_tensor(dx) else xyz
    return WEIGHT * TS.mask_regularization(
        labels, NUM_MASKS, deformed, camera.projmatrix, dx, dr, ds,
        state.alive, camera.width, camera.height)


CAP = 512


@pytest.fixture(scope="module")
def scene():
    """test_torch_port_train.py's scene (a fresh anisotropic SH-1 cloud, a
    narrow Blender deform MLP in both packages) with a ground-truth view
    rendered by the port."""
    from d3gs_tpu.models import gaussians as JG
    from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
    from d3gs_tpu_torch.models.renderer import render
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
    cam = make_camera(angle=1.5)
    with torch.no_grad():
        img = render(to_torch(gt_state(n=120, cap=CAP)),
                     to_torch_camera(cam, 0.0), bg=torch.zeros(3)).image
    cam = dataclasses.replace(cam, image=jnp.asarray(img.numpy()),
                              fid=jnp.asarray(0.7, jnp.float32))
    dstate, field = create_deform_field(DeformFieldSpec(**SPEC),
                                        jax.random.PRNGKey(3),
                                        OptimizationParams())
    tfield = TF.create_deform_field(TF.DeformFieldSpec(**SPEC), device="cpu",
                                    opt_cfg=TC.OptimizationParams())
    tfield.net.load_state_dict(TF.params_from_flax(_flat(dstate.params),
                                                   tfield.net))
    return js, cam, dstate, field, tfield


def test_deform_step_with_mask_term_matches_jax(scene):
    js, cam, dstate, field, tfield = scene
    labels = JS.grid_label_map(cam.height, cam.width, cells=4)
    jlab, tlab = jnp.asarray(labels), _t(labels)
    extra = _jax_extra(labels)

    def f(gp, dp, tap, with_term=True):
        st = js.replace(params=gp)
        dx, dr, ds = field.step(dp, jax.lax.stop_gradient(gp.xyz), cam.fid)
        out = jax_render(st, cam, d_xyz=dx, d_rotation=dr, d_scaling=ds,
                         bg=jnp.zeros(3), means2d_tap=tap, binning="packed",
                         tile_capacity=1024, depth_grad=False)
        loss = 0.8 * l1_loss(out.image, cam.image) + 0.2 * (
            1 - ssim(out.image, cam.image))
        if with_term:
            loss = loss + extra(out, (dx, dr, ds), cam, st, jlab)
        return loss

    loss, (g_params, g_deform, g_tap) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2)))(js.params, dstate.params, jnp.zeros((CAP, 2)))
    ts = to_torch(js)
    tcam = to_torch_camera(cam, cam.fid)
    loss_and_grads = TStep.make_loss_and_grads(
        opt_cfg=TC.OptimizationParams(), pipe_cfg=TC.PipelineParams(),
        deform_fn=lambda xyz, fid, it, gen: tfield.step(xyz, fid),
        deform_params=list(tfield.net.parameters()),
        extra_loss_fn=_torch_extra)
    r = loss_and_grads(ts, tcam, 4000, None, torch.zeros(3), tlab)
    assert float(r.loss) == pytest.approx(float(loss), rel=1e-5)
    # the term moves the deform kernels' gradients (it adds nothing to the
    # biases': a segment's variance does not change when all its members
    # move alike)
    photo = TStep.make_loss_and_grads(
        opt_cfg=TC.OptimizationParams(), pipe_cfg=TC.PipelineParams(),
        deform_fn=lambda xyz, fid, it, gen: tfield.step(xyz, fid),
        deform_params=list(tfield.net.parameters()))(
            ts, tcam, 4000, None, torch.zeros(3))
    first = r.deform[0]
    assert float(r.loss - photo.loss) > 0.05 * float(r.loss)
    assert float((first - photo.deform[0]).abs().max()) > \
        0.5 * float(first.abs().max())

    def close(got, ref, msg):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0 and np.isfinite(got).all(), msg
        np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4,
                                   err_msg=msg)

    for name, a, b in zip(type(ts.params)._fields, r.params, g_params):
        close(a.numpy(), b, name)
    close(r.tap.numpy(), g_tap, "tap")
    ref = TF.params_from_flax(_flat(g_deform), tfield.net)
    for (name, _), g in zip(tfield.net.named_parameters(), r.deform):
        close(g.numpy(), ref[name].numpy(), name)

    # one step of each package's make_train_step with the term
    opt = OptimizationParams(position_lr_max_steps=100, warm_up=0)
    jstep = jax_make_train_step(
        opt_cfg=opt, pipe_cfg=PipelineParams(tile_capacity=1024,
                                             tile_chunk=16),
        donate=False,
        deform_fn=lambda dp, xyz, fid, it, key: field.step(dp, xyz, fid),
        deform_update_fn=field.update, extra_loss_fn=extra)
    _, jd, jaux = jstep(js, dstate, cam, 1.0, jax.random.PRNGKey(0),
                        jnp.zeros(3), jlab)
    topt = TC.OptimizationParams(position_lr_max_steps=100, warm_up=0)
    tf = TF.create_deform_field(TF.DeformFieldSpec(**SPEC), device="cpu",
                                opt_cfg=topt)
    tf.net.load_state_dict(tfield.net.state_dict())
    tstep = TStep.make_train_step(
        opt_cfg=topt, pipe_cfg=TC.PipelineParams(),
        deform_fn=lambda xyz, fid, it, gen: tf.step(xyz, fid),
        deform_params=list(tf.net.parameters()), deform_update_fn=tf.update,
        extra_loss_fn=_torch_extra)
    _, td, taux = tstep(to_torch(js), tf.init_state(), tcam, 1, None,
                        torch.zeros(3), tlab)
    assert float(taux.loss) == pytest.approx(float(jaux.loss), rel=1e-5)
    ref1 = TF.params_from_flax(_flat(jd.params), tf.net)
    ref0 = TF.params_from_flax(_flat(dstate.params), tf.net)
    for name, p in tf.net.named_parameters():
        moved = np.abs(ref1[name].numpy() - ref0[name].numpy()).max()
        np.testing.assert_allclose(p.detach().numpy(), ref1[name].numpy(),
                                   atol=max(0.05 * moved, 1e-7),
                                   err_msg=name)


# ---- the CLI ---------------------------------------------------------

@pytest.fixture(scope="module")
def sam_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_sam")
    return write_blender_dataset(str(root / "data"), n_train=4, n_test=2,
                                 size=32)


def _run_cli(data, mp, *extra):
    from d3gs_tpu_torch.train_baseline_sam import main
    return main(["-s", data, "-m", mp, "--eval", "--is_blender", "--device",
                 "cpu", "--iterations", "14", "--warm_up", "6",
                 "--sh_degree", "1", "--max_gaussians", "600", "--D", "2",
                 "--W", "32", "--test_iterations", "14",
                 "--position_lr_max_steps", "14", "--num_masks", "16",
                 "--quiet", *extra])


@pytest.mark.parametrize("route", ["slic", "grid", "mask_dir"])
def test_cli_trains_with_each_mask_source(sam_data, tmp_path, route,
                                          monkeypatch):
    import d3gs_tpu_torch.train.sam_reg as sam_mod
    calls = []
    real = sam_mod.mask_regularization

    def watch(labels, *a, **kw):
        calls.append(labels.clone())
        return real(labels, *a, **kw)

    monkeypatch.setattr(sam_mod, "mask_regularization", watch)
    data = os.path.join(str(tmp_path), "data")
    import shutil
    shutil.copytree(sam_data, data)
    mp = str(tmp_path / "model")
    if route == "mask_dir":
        from PIL import Image
        mask_dir = tmp_path / "masks"
        os.makedirs(mask_dir)
        # r_000 as a paletted PNG, r_001 as npy; the rest get the grid
        im = Image.new("P", (32, 32))
        im.putpalette([0] * 768)
        im.putdata([(i // 32) // 4 + 1 for i in range(32 * 32)])
        im.save(mask_dir / "r_000.png")
        np.save(mask_dir / "r_001.npy", np.full((32, 32), 99, np.int64))
        result = _run_cli(data, mp, "--mask_dir", str(mask_dir))
    else:
        result = _run_cli(data, mp, "--segmenter", route)
    assert all(math.isfinite(v) for _, v in result.losses)
    assert math.isfinite(result.best_psnr) and result.best_iteration == 14
    for f in ("cfg_args", "point_cloud/iteration_14/point_cloud.ply",
              "deform/iteration_14/deform.npz"):
        assert os.path.exists(os.path.join(mp, f)), f
    cache = os.path.join(data, "sam_masks_cache")
    assert len(calls) == 14 - 6 + 1          # every deform-phase step
    seen = {tuple(np.unique(c.numpy())) for c in calls}
    grid = tuple(range(1, 17))
    if route == "slic":
        assert sorted(os.listdir(cache)) == [f"r_00{i}_mask.npy"
                                             for i in range(4)]
        assert all(max(s) <= 16 and len(s) > 4 for s in seen)
    elif route == "grid":
        assert not os.path.exists(cache) and seen == {grid}
    else:
        assert seen <= {grid, tuple(range(1, 9)), (16,)}
        assert {tuple(range(1, 9)), (16,)} <= seen
