"""The port's render modes (`time`, `view`, `pose`, `all`, `original`)
against the JAX package on the CPU.

Cameras: every camera of a mode (viewmatrix, projmatrix, campos, fid) at
frames=4 (the wander path's 60 for `view`), read from the JAX mode function
through a recording render function, equals the port's within 1e-6; the
pose paths are equal outright. Frames: two frames per mode of the scene of
tests/test_render_modes.py (60 Gaussians, 32x32, a D=2, W=16 Blender
field), rendered by JAX's render function (its own CPU binning) and by the
port's mode function, agree at atol 2e-4 / rtol 1e-3 (as
test_torch_port_render.py), and the port's PNGs within 1 of 255 of JAX's
image.
"""
import json
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu import config as JC
from d3gs_tpu.data.scene import save_gaussians_ply
from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
from d3gs_tpu.models.deform.fields import save_deform_weights
from d3gs_tpu.render_eval import pose_paths as JPP
from d3gs_tpu.render_eval import render_modes as JRM
from d3gs_tpu_torch import config as TC
from d3gs_tpu_torch import render as trender
from d3gs_tpu_torch.data.cameras import camera_from_matrices
from d3gs_tpu_torch.data.image_io import read_png, write_png
from d3gs_tpu_torch.data.ply import write_pointcloud_ply
from d3gs_tpu_torch.models.deform import fields as F
from d3gs_tpu_torch.models.gaussians import gaussians_from_numpy
from d3gs_tpu_torch.render_eval import pose_paths as TPP
from d3gs_tpu_torch.render_eval import render_modes as TRM
from tests.test_train_static import gt_state, make_camera
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

MODES = ["time", "view", "pose", "all", "original"]
FRAMES = 4
SIZE = 32
# the mode function of each package, its output directory, and the two
# frames compared by rendering
MODE_FN = {"time": ("interpolate_time", "interpolate_1"),
           "view": ("interpolate_view", "interpolate_view_1"),
           "pose": ("interpolate_poses", "interpolate_pose_1"),
           "all": ("interpolate_all", "interpolate_all_1"),
           "original": ("interpolate_view_original",
                        "interpolate_hyper_view_1")}
PICKS = {"time": (1, 3), "view": (7, 45), "pose": (1, 2), "all": (0, 2),
         "original": (1, 3)}


def _flat(params) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _state_arrays(st):
    return ({k: np.array(v) for k, v in st.params._asdict().items()},
            np.array(st.alive))


@pytest.fixture(scope="module")
def scene():
    st = gt_state(n=60, cap=128)
    jcams = [make_camera(a, width=SIZE, height=SIZE) for a in (0.0, 1.0, 2.0)]
    spec = dict(kind="baseline", is_blender=True, D=2, W=16)
    dstate, jfield = create_deform_field(DeformFieldSpec(**spec),
                                         jax.random.PRNGKey(0))
    jrender = JRM.make_render_fn(st, jfield, JC.PipelineParams(
        tile_capacity=128, tile_chunk=4))

    params, alive = _state_arrays(st)
    tstate = gaussians_from_numpy(params, alive, int(st.active_sh_degree),
                                  st.max_sh_degree, "cpu")
    tfield = F.create_deform_field(F.DeformFieldSpec(**spec), device="cpu")
    tfield.net.load_state_dict(F.params_from_flax(_flat(dstate.params),
                                                  tfield.net))
    tcams = [camera_from_matrices(np.asarray(c.viewmatrix), c.fovx, c.fovy,
                                  fid=0.0, image=np.zeros((SIZE, SIZE, 3),
                                                          np.float32),
                                  device="cpu") for c in jcams]
    trender_at = TRM.make_render_fn(tstate, tfield, TC.PipelineParams())
    return types.SimpleNamespace(
        st=st, jcams=jcams, d_params=dstate.params, jrender=jrender,
        tstate=tstate, tcams=tcams, tfield=tfield, trender=trender_at)


def _jax_rt(view):
    """JAX render.py:72-79: the view mode's reference pose."""
    Vt = np.asarray(view.viewmatrix).T
    return Vt[:3, :3].T, Vt[:3, 3]


def _mode_args(mode, views, rt):
    if mode == "view":
        return dict(R=rt[0], T=rt[1])
    return dict(frames=FRAMES)


@pytest.fixture(scope="module")
def jax_cameras(scene, tmp_path_factory):
    """Every camera each JAX mode function renders, recorded."""
    out = {}
    for mode in MODES:
        cams = []

        def record(state, d_params, cam, bg):
            cams.append(cam)
            return types.SimpleNamespace(image=np.zeros((SIZE, SIZE, 3)),
                                         depth=np.zeros((SIZE, SIZE)))
        fn = getattr(JRM, MODE_FN[mode][0])
        fn(str(tmp_path_factory.mktemp(f"jax_{mode}")), "test", 1,
           scene.jcams, scene.st, scene.d_params, record, jnp.zeros(3),
           **_mode_args(mode, scene.jcams, _jax_rt(scene.jcams[0])))
        out[mode] = cams
    return out


def _port_cameras(mode, views):
    if mode == "time":
        return TRM.time_cameras(views[0], FRAMES)
    if mode == "view":
        return TRM.view_cameras(views[0], *TRM.reference_rt(views[0]))
    if mode == "pose":
        return TRM.pose_cameras(views[0], views[-1], FRAMES)
    if mode == "all":
        return TRM.all_cameras(views[0], FRAMES)
    return TRM.original_cameras(views, FRAMES)


@pytest.mark.parametrize("mode", MODES)
def test_mode_cameras_match_jax(scene, jax_cameras, mode):
    jcams = jax_cameras[mode]
    tcams = _port_cameras(mode, scene.tcams)
    assert len(tcams) == len(jcams) == (60 if mode == "view" else FRAMES)
    for i, (t, j) in enumerate(zip(tcams, jcams)):
        for name in ("viewmatrix", "projmatrix", "campos"):
            np.testing.assert_allclose(getattr(t, name).numpy(),
                                       np.asarray(getattr(j, name)),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{mode} {i} {name}")
        assert abs(t.fid - float(j.fid)) <= 1e-6, (mode, i)
        assert (t.width, t.height, t.fovx, t.fovy) == (
            j.width, j.height, j.fovx, j.fovy)


def test_pose_paths_equal_jax(scene):
    R, T = TRM.reference_rt(scene.tcams[1])
    v = scene.tcams[1]
    for a, b in zip(TPP.wander_path(R, T, v.fovy, v.height),
                    JPP.wander_path(R, T, v.fovy, v.height)):
        assert np.array_equal(a, b)
    for i in range(150):
        theta = -180 + 360 * i / 150
        a = TPP.pose_spherical(theta, -30.0, 4.0)
        assert np.array_equal(a, JPP.pose_spherical(theta, -30.0, 4.0))
        for x, y in zip(TPP.pose_to_blender_rt(a), JPP.pose_to_blender_rt(a)):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("mode", MODES)
def test_mode_frames_match_jax(scene, jax_cameras, mode, tmp_path):
    fn = getattr(TRM, MODE_FN[mode][0])
    n = fn(str(tmp_path), "test", 1, scene.tcams, scene.tstate, scene.tfield,
           scene.trender, torch.zeros(3),
           **_mode_args(mode, scene.tcams, TRM.reference_rt(scene.tcams[0])))
    assert n == len(jax_cameras[mode])
    base = os.path.join(str(tmp_path), "test", MODE_FN[mode][1])
    for sub in ("renders", "depth"):
        assert len([f for f in os.listdir(os.path.join(base, sub))
                    if f.endswith(".png")]) == n
    tcams = _port_cameras(mode, scene.tcams)
    for i in PICKS[mode]:
        ref = scene.jrender(scene.st, scene.d_params, jax_cameras[mode][i],
                            jnp.zeros(3))
        out = scene.trender(scene.tstate, scene.tfield, tcams[i],
                            torch.zeros(3))
        for name in ("image", "depth"):
            np.testing.assert_allclose(
                getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                atol=2e-4, rtol=1e-3, err_msg=f"{mode} frame {i} {name}")
        png = read_png(os.path.join(base, "renders", f"{i:05d}.png"))
        want = JRM.to8b(ref.image)
        assert np.abs(png.astype(int) - want.astype(int)).max() <= 1
        assert read_png(os.path.join(base, "depth", f"{i:05d}.png")).shape \
            == (SIZE, SIZE)


def write_views(root, n_train=2, n_test=2):
    """A D-NeRF-format set of grey 32x32 views on a radius-4 orbit."""
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split))
        frames = []
        for k in range(n):
            write_png(os.path.join(root, split, f"r_{k}.png"),
                      np.full((SIZE, SIZE, 3), 100, np.uint8))
            a = k * 2 * math.pi / n
            c2w = np.eye(4)
            c2w[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                           [-math.sin(a), 0, math.cos(a)]]
            c2w[:3, 3] = c2w[:3, 2] * 4.0
            frames.append({"file_path": f"./{split}/r_{k}",
                           "time": k / max(n - 1, 1),
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": math.radians(60), "frames": frames},
                      f)
    write_pointcloud_ply(os.path.join(root, "points3d.ply"),
                         np.zeros((4, 3)), np.zeros((4, 3)))
    return root


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model directory written by the JAX package: the 60-Gaussian scene,
    the D=2, W=16 field, over a 2+2-view 32x32 Blender set."""
    root = tmp_path_factory.mktemp("modes_cli")
    data = write_views(str(root / "data"))
    mp = str(root / "model")
    os.makedirs(os.path.join(mp, "point_cloud", "iteration_1"))
    save_gaussians_ply(os.path.join(mp, "point_cloud", "iteration_1",
                                    "point_cloud.ply"), gt_state(n=60, cap=128))
    dstate, _ = create_deform_field(
        DeformFieldSpec(kind="baseline", is_blender=True, D=2, W=16),
        jax.random.PRNGKey(0))
    save_deform_weights(mp, 1, dstate)
    JC.save_cfg_args(mp, JC.ModelParams(source_path=data, model_path=mp,
                                        eval=True, is_blender=True,
                                        sh_degree=1, D=2, W=16))
    return mp


def test_cli_mode_time_writes_frames(model_dir):
    result = trender.main(["-m", model_dir, "--mode", "time", "--device",
                           "cpu"])
    assert result["frames"] == 150 and result["iteration"] == 1
    base = os.path.join(model_dir, "test", "interpolate_1")
    names = sorted(f for f in os.listdir(os.path.join(base, "renders"))
                   if f.endswith(".png"))
    assert names == [f"{i:05d}.png" for i in range(150)]
    assert len(os.listdir(os.path.join(base, "depth"))) == 150
    first, last = (read_png(os.path.join(base, "renders", n))
                   for n in (names[0], names[-1]))
    assert first.shape == (SIZE, SIZE, 3) and first.max() > 0
    assert not np.array_equal(first, last)      # time moved the scene


def test_cli_trajectories(model_dir):
    result = trender.main(["-m", model_dir, "--mode", "render",
                           "--skip_train", "--trajectories", "--device",
                           "cpu"])
    assert result["trajectories"]["shape"] == [150, 60, 3]
    traj = np.load(os.path.join(model_dir, "trajectories.npy"))
    ts = np.load(os.path.join(model_dir, "timestamps.npy"))
    assert traj.shape == (150, 60, 3) and np.isfinite(traj).all()
    assert ts[0] == 0.0 and ts[-1] == pytest.approx(1.0) and len(ts) == 150
    assert math.isfinite(result["trajectories"]["seconds"])
