"""The whole render slice: a model directory written by the JAX package
(PLY, deform.npz, cfg_args) rendered by the JAX render path — with the
Pallas blend kernel in interpret mode — and by the port's CLI and render
path on the CPU.

Tolerance: atol 2e-4 / rtol 1e-3. The deform MLPs differ by ~1e-6 (summation
order), which moves the means and so every pixel a little; the blends alone
agree to 5e-5 (test_torch_port_blend.py)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu import config as JC
from d3gs_tpu.data.scene import Scene as JScene
from d3gs_tpu.data.scene import save_gaussians_ply
from d3gs_tpu.models import gaussians as G
from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
from d3gs_tpu.models.deform.fields import (load_deform_weights,
                                           save_deform_weights)
from d3gs_tpu.render_eval import render_modes as JRM
from d3gs_tpu.train.flagship import pick_field_spec
from d3gs_tpu_torch import config as TC
from d3gs_tpu_torch import render as trender
from d3gs_tpu_torch.data.image_io import read_png
from tests.test_cli_end_to_end import write_blender_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_render")
    data = write_blender_dataset(str(root / "data"), n_train=2, n_test=2,
                                 size=64)
    mp = str(root / "model")
    rng = np.random.default_rng(7)
    n = 400
    st = G.create_from_pcd(rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                           rng.random((n, 3)).astype(np.float32),
                           sh_degree=3, capacity=1024)
    p = st.params
    st = st.replace(params=p._replace(
        features_rest=jnp.asarray(rng.normal(0, 0.05, p.features_rest.shape),
                                  jnp.float32),
        opacity=jnp.asarray(rng.uniform(-2, 3, p.opacity.shape),
                            jnp.float32)))
    os.makedirs(os.path.join(mp, "point_cloud", "iteration_1"))
    save_gaussians_ply(os.path.join(mp, "point_cloud", "iteration_1",
                                    "point_cloud.ply"), st)
    dstate, _ = create_deform_field(
        DeformFieldSpec(kind="baseline", is_blender=True, D=4, W=64),
        jax.random.PRNGKey(3))
    save_deform_weights(mp, 1, dstate)
    JC.save_cfg_args(mp, JC.ModelParams(source_path=data, model_path=mp,
                                        eval=True, is_blender=True,
                                        sh_degree=3, D=4, W=64))
    return mp


@pytest.fixture(scope="module")
def jax_renders(model_dir):
    """Test views rendered by the JAX package, Pallas kernel interpreted."""
    cfg = JC.ModelParams(**JC.load_cfg_args(model_dir))
    scene = JScene(cfg, load_iteration=-1, shuffle=False)
    opt = JC.OptimizationParams()
    spec = pick_field_spec(cfg, opt)
    dstate, field = create_deform_field(spec, jax.random.PRNGKey(0), opt)
    dstate = load_deform_weights(model_dir, dstate)
    render_at = JRM.make_render_fn(scene.gaussians, field,
                                   JC.PipelineParams(binning="pallas"))
    outs = [render_at(scene.gaussians, dstate.params, v, jnp.zeros(3))
            for v in scene.get_test_cameras()]
    return [tuple(np.asarray(x) for x in (o.image, o.depth, o.alpha, o.radii))
            for o in outs]


def test_render_path_matches_jax(model_dir, jax_renders):
    from d3gs_tpu_torch.data.scene import Scene
    from d3gs_tpu_torch.models.deform.fields import (create_deform_field as
                                                     tcreate,
                                                     load_deform_weights as
                                                     tload)
    from d3gs_tpu_torch.render_eval import render_modes as RM
    cfg = TC.ModelParams(**TC.load_cfg_args(model_dir))
    scene = Scene(cfg, load_iteration=-1, shuffle=False, device="cpu")
    from d3gs_tpu_torch.train.flagship import pick_field_spec as tpick
    field = tload(model_dir, tcreate(tpick(cfg, TC.OptimizationParams()),
                                     device="cpu"))
    render_at = RM.make_render_fn(scene.gaussians, field, TC.PipelineParams())
    views = scene.get_test_cameras()
    assert len(views) == len(jax_renders) == 2
    for view, ref in zip(views, jax_renders):
        out = render_at(scene.gaussians, field, view, torch.zeros(3))
        for name, a, b in zip(("image", "depth", "alpha"), out[:3], ref[:3]):
            assert np.isfinite(a.numpy()).all()
            np.testing.assert_allclose(a.numpy(), b, atol=2e-4, rtol=1e-3,
                                       err_msg=name)
        np.testing.assert_array_equal(out.radii.numpy(), ref[3])
        assert out.alpha.numpy().max() > 0.5     # the scene is in view


def test_cli_renders_on_cpu(model_dir, jax_renders):
    result = trender.main(["-m", model_dir, "--mode", "render",
                           "--device", "cpu"])
    assert result == {"iteration": 1, "views": 4}
    base = os.path.join(model_dir, "test", "ours_1")
    for i, ref in enumerate(jax_renders):
        img = read_png(os.path.join(base, "renders", f"{i:05d}.png"))
        want = (255 * np.clip(ref[0], 0, 1)).astype(np.uint8)
        assert np.abs(img.astype(int) - want).max() <= 1
        assert read_png(os.path.join(base, "depth", f"{i:05d}.png")).shape \
            == (64, 64)
        assert read_png(os.path.join(base, "gt", f"{i:05d}.png")).shape \
            == (64, 64, 3)
    assert len(os.listdir(os.path.join(model_dir, "train", "ours_1",
                                       "renders"))) == 2


def test_cli_device_policy(model_dir):
    """The card by default, the CPU only on request, never a silent drop;
    unported modes and blend paths raise."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trender.main(["-m", model_dir])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trender.main(["-m", model_dir, "--mode", "time", "--device", "cpu"])
    with pytest.raises(ValueError, match="binning"):
        trender.main(["-m", model_dir, "--device", "cpu", "--binning",
                      "pallas"])
    with pytest.raises(ValueError, match="--device cpu"):
        trender.main(["-m", model_dir, "--device", "cpu", "--skip_train",
                      "--skip_test", "--benchmark"])


def test_port_imports_no_jax():
    """Importing every d3gs_tpu_torch module loads no jax, flax or
    d3gs_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import d3gs_tpu_torch\n"
        "for m in pkgutil.walk_packages(d3gs_tpu_torch.__path__,\n"
        "                               'd3gs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'd3gs_tpu')]\n"
        "print(len([k for k in sys.modules if k.startswith('d3gs_tpu_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
