"""The port's evaluation against the JAX package on the CPU: LPIPS
(`render_eval/lpips.py` against `lpips_jax.lpips`, rtol 1e-4, on random
weights written to one npz), its weight loading, the metric harness
(results.json / per_view.json on the same PNG dumps: PSNR within 1e-4 dB,
SSIM 1e-5, LPIPS 1e-4 relative), trajectory sampling (a baseline field at
the network tolerance of test_torch_port_deform*.py, rtol 1e-5 with atol
1e-5 of the largest; an RK4 ODE field at the integrated-step tolerance,
atol 1e-4 of the largest), and the metrics, sample_trajectories and
full_eval CLIs on the CPU.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
from d3gs_tpu.render_eval import lpips_jax
from d3gs_tpu.render_eval import metrics as JM
from d3gs_tpu.render_eval import trajectories as JT
from d3gs_tpu_torch import full_eval, sample_trajectories
from d3gs_tpu_torch import metrics as metrics_cli
from d3gs_tpu_torch.data.image_io import write_png
from d3gs_tpu_torch.models.deform import fields as F
from d3gs_tpu_torch.models.gaussians import gaussians_from_numpy
from d3gs_tpu_torch.render_eval import lpips as TL
from d3gs_tpu_torch.render_eval import trajectories as TT
from tests.test_train_static import gt_state
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return TL.write_random_weights(
        str(tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz"), seed=0)


@pytest.mark.parametrize("size", [(64, 64), (50, 38)])
def test_lpips_matches_jax(weights, size):
    rng = np.random.default_rng(1)
    a = rng.random(size + (3,)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    ref = float(lpips_jax.lpips(lpips_jax.load_params(weights),
                                jnp.asarray(a), jnp.asarray(b)))
    params = TL.load_params(weights, device="cpu")
    got = float(TL.lpips(params, torch.from_numpy(a), torch.from_numpy(b)))
    assert ref > 0
    assert got == pytest.approx(ref, rel=1e-4)
    same = TL.lpips(params, torch.from_numpy(a), torch.from_numpy(a))
    assert abs(float(same)) < 1e-6


def test_load_params_fails_loudly_or_returns_none(tmp_path, monkeypatch,
                                                  weights):
    """As tests/test_lpips.py holds lpips_jax.load_params: explicit weights
    that are missing or incomplete raise; the implicit default gives
    None."""
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "nope.npz"))
    with pytest.raises(FileNotFoundError):
        TL.load_params(device="cpu")
    bad = tmp_path / "bad.npz"
    np.savez(bad, conv0_w=np.zeros((3, 3, 3, 64), np.float32))
    monkeypatch.setenv("LPIPS_WEIGHTS", str(bad))
    with pytest.raises(ValueError):
        TL.load_params(device="cpu")
    with pytest.raises(FileNotFoundError):
        TL.load_params(str(tmp_path / "nope.npz"), device="cpu")
    monkeypatch.delenv("LPIPS_WEIGHTS")
    monkeypatch.chdir(tmp_path)        # no ./lpips_vgg.npz here
    assert TL.load_params(device="cpu") is None
    shutil.copy(weights, tmp_path / "lpips_vgg.npz")
    p = TL.load_params(device="cpu")
    assert p["conv0_w"].shape == (64, 3, 3, 3)     # OIHW
    assert p["conv12_w"].shape == (512, 512, 3, 3)


def _write_dumps(mp, n=3, h=40, w=48, seed=2):
    """test/ours_1/{renders,gt}: PNG pairs, renders = gt + noise."""
    rng = np.random.default_rng(seed)
    base = os.path.join(mp, "test", "ours_1")
    for d in ("renders", "gt"):
        os.makedirs(os.path.join(base, d))
    for i in range(n):
        gt = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        noise = rng.integers(-20, 21, gt.shape)
        render = np.clip(gt.astype(int) + noise, 0, 255).astype(np.uint8)
        write_png(os.path.join(base, "gt", f"{i:05d}.png"), gt)
        write_png(os.path.join(base, "renders", f"{i:05d}.png"), render)
    return mp


@pytest.mark.parametrize("with_weights", [True, False])
def test_metrics_match_jax(tmp_path, monkeypatch, weights, with_weights):
    jmp = _write_dumps(str(tmp_path / "jax"))
    tmp = str(tmp_path / "port")
    shutil.copytree(jmp, tmp)
    monkeypatch.chdir(tmp_path)        # no ./lpips_vgg.npz here
    if with_weights:
        monkeypatch.setenv("LPIPS_WEIGHTS", weights)
    else:
        monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    JM.evaluate_model_paths([jmp])
    # the CLI, after an interpolation mode's frames (no gt/) landed
    os.makedirs(os.path.join(tmp, "test", "interpolate_1", "renders"))
    out = metrics_cli.main(["-m", tmp, "--device", "cpu"])
    assert list(out[tmp]) == ["ours_1"]
    for name in ("results.json", "per_view.json"):
        with open(os.path.join(jmp, name)) as f:
            ref = json.load(f)
        with open(os.path.join(tmp, name)) as f:
            got = json.load(f)
        assert list(got) == list(ref) == ["ours_1"]
        ref, got = ref["ours_1"], got["ours_1"]
        assert list(got) == list(ref) == ["PSNR", "SSIM", "LPIPS"]
        if name == "results.json":
            ref = {k: {"mean": v} for k, v in ref.items()}
            got = {k: {"mean": v} for k, v in got.items()}
        for key, tol in (("PSNR", dict(abs=1e-4)), ("SSIM", dict(abs=1e-5)),
                         ("LPIPS", dict(rel=1e-4))):
            if key == "LPIPS" and not with_weights:
                assert got[key] in ({}, {"mean": None})
                assert got[key] == ref[key]
                continue
            assert list(got[key]) == list(ref[key])
            for view in ref[key]:
                assert got[key][view] == pytest.approx(ref[key][view], **tol)


@pytest.fixture(scope="module")
def gaussians():
    st = gt_state(n=60, cap=128)
    params = {k: np.array(v) for k, v in st.params._asdict().items()}
    return st, gaussians_from_numpy(params, np.array(st.alive), 0, 1, "cpu")


def _flat(params) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.mark.parametrize("kind", ["baseline", "ode"])
def test_sample_trajectories_matches_jax(gaussians, kind, tmp_path):
    spec = (dict(kind="baseline", is_blender=True, D=2, W=16)
            if kind == "baseline" else
            dict(kind="ode", is_blender=True, D=3, W=32, n_substeps=3))
    dstate, jfield = create_deform_field(DeformFieldSpec(**spec),
                                         jax.random.PRNGKey(3))
    tfield = F.create_deform_field(F.DeformFieldSpec(**spec), device="cpu")
    tfield.net.load_state_dict(F.params_from_flax(_flat(dstate.params),
                                                  tfield.net))
    jst, tst = gaussians
    ref, ref_ts = JT.sample_trajectories(jst, jfield, dstate.params,
                                         num_timesteps=12)
    got, ts = TT.export_trajectories(str(tmp_path), tst, tfield,
                                     num_timesteps=12)
    assert got.shape == ref.shape == (12, 60, 3)
    np.testing.assert_allclose(ts, ref_ts, rtol=0, atol=1e-7)
    rtol, rel_atol = (1e-5, 1e-5) if kind == "baseline" else (0, 1e-4)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rel_atol * np.abs(ref).max())
    assert np.array_equal(np.load(tmp_path / "trajectories.npy"), got)
    assert np.array_equal(np.load(tmp_path / "timestamps.npy"), ts)
    if kind == "ode":        # an integral from the canonical positions
        np.testing.assert_allclose(got[0], np.asarray(jst.params.xyz)[:60],
                                   atol=1e-6)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A 2+2-view 32x32 D-NeRF set (as lego/) and a model trained on it for
    3 iterations by full_eval, on the CPU."""
    from tests.test_torch_port_render_modes import write_views
    from d3gs_tpu_torch.data.ply import write_pointcloud_ply
    root = tmp_path_factory.mktemp("full_eval")
    data = write_views(str(root / "dnerf" / "lego"))
    rng = np.random.default_rng(0)
    write_pointcloud_ply(os.path.join(data, "points3d.ply"),
                         rng.uniform(-1, 1, (64, 3)),
                         rng.integers(0, 256, (64, 3)))
    paths = full_eval.main([
        "--dnerf_path", str(root / "dnerf"), "--scenes", "lego",
        "--iterations", "3", "--output_path", str(root / "eval"),
        "--device", "cpu"])
    assert paths == [str(root / "eval" / "lego")]
    return paths[0]


def test_full_eval_chains_train_render_metrics(model_dir):
    assert os.path.exists(os.path.join(model_dir, "point_cloud",
                                       "iteration_3", "point_cloud.ply"))
    assert sorted(os.listdir(os.path.join(model_dir, "test", "ours_3",
                                          "renders"))) == ["00000.png",
                                                           "00001.png"]
    with open(os.path.join(model_dir, "results.json")) as f:
        res = json.load(f)["ours_3"]
    assert np.isfinite(res["PSNR"]) and np.isfinite(res["SSIM"])


def test_sample_trajectories_cli(model_dir, tmp_path):
    traj, ts = sample_trajectories.main(
        ["-m", model_dir, "--num_timesteps", "7", "--output_dir",
         str(tmp_path), "--device", "cpu"])
    assert traj.shape == (7, 64, 3) and np.isfinite(traj).all()
    assert np.array_equal(np.load(tmp_path / "trajectories.npy"), traj)
    assert len(ts) == 7 and ts[-1] == pytest.approx(1.0)
