"""The port's viewer, the trainers' hooks and the side CLIs against the JAX
package on the CPU.

* `OrbitCamera` after the same orbit / scale / pan moves: bit-equal poses,
  views and MVPs.
* The network viewer's round trip through the port's loopback client
  (`d3gs_tpu_torch/viewer/client.py`).
* `GUI.test_step` at a fixed fid against JAX's, rgb and depth modes, with
  an additive and a direct (ODE-style) deformation: atol 5e-5 / rtol 1e-4
  (the blend tolerance of test_torch_port_blend.py).
* `tb_writer` / `live_hook` of both trainers against JAX's on one tiny
  scene: the same tags at the same steps with the same shapes, and the
  hook at the same iterations (values differ with the random streams).
* `true_spiral` against JAX's within 1e-5 of the trajectory's largest
  coordinate.
* `ode_demo`, `train_loops` and `train_gui` (`--view_only` and the training
  route, `--no_gui`, served to a loopback client and stopped by SIGINT
  with exit code 0) on the CPU at tiny sizes; each new CLI raises
  without a card unless given `--device cpu`.
"""
import dataclasses
import json
import math
import os
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ode_demo as jax_ode_demo
from d3gs_tpu import config as JC
from d3gs_tpu.models import gaussians as JG
from d3gs_tpu.train.baseline import train_baseline as jax_train_baseline
from d3gs_tpu.train.flagship import train_flagship as jax_train_flagship
from d3gs_tpu.viewer import OrbitCamera as JOrbitCamera
from d3gs_tpu.viewer.gui import GUI as JGUI
from d3gs_tpu_torch import config as TC
from d3gs_tpu_torch.train.recording_writer import RecordingWriter
from d3gs_tpu_torch.viewer import NetworkViewer, OrbitCamera
from d3gs_tpu_torch.viewer.client import (client_message, look_from_z,
                                          request_frame, serve_train_gui)
from d3gs_tpu_torch.viewer.gui import GUI
from tests.test_cli_end_to_end import write_blender_dataset
from tests.test_torch_port_gaussians import to_torch
from tests.test_torch_port_train import to_torch_camera
from tests.test_train_static import gt_state, make_camera
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


def _moves(cam):
    cam.orbit(100, -30)
    cam.scale(1.5)
    cam.pan(40.0, -25.0, 3.0)
    cam.orbit(-12.5, 60)
    return cam


def test_orbit_camera_matches_jax():
    a, b = _moves(OrbitCamera(64, 48, r=3.0)), _moves(JOrbitCamera(64, 48,
                                                                   r=3.0))
    for attr in ("pose", "view", "perspective", "mvp", "campos", "fovx"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr),
                                      err_msg=attr)
    np.testing.assert_allclose(a.view @ a.pose, np.eye(4), atol=1e-5)


def test_network_viewer_roundtrip():
    viewer = NetworkViewer(port=0)
    got = {}

    def render_fn(cam, scale_mod):
        got["cam"], got["scale"] = cam, scale_mod
        return np.full((cam.height, cam.width, 3), 0.5, np.float32)

    def client():
        with socket.create_connection(("127.0.0.1", viewer.port),
                                      timeout=10) as s:
            V, full = look_from_z(4.0)
            got["frame"] = request_frame(s, client_message(8, 4, V, full, 1.5))

    t = threading.Thread(target=client)
    t.start()
    handled = False
    for _ in range(500):
        if viewer.serve_once(render_fn, verify="ok"):
            handled = True
            break
        time.sleep(0.01)
    t.join(timeout=10)
    viewer.close()
    assert handled and not t.is_alive()
    assert got["cam"].width == 8 and got["cam"].height == 4
    assert got["scale"] == 1.5
    img, verify = got["frame"]
    assert verify == "ok" and (img == 127).all()
    # the sign flips undo the client's: the camera is the one sent
    np.testing.assert_allclose(got["cam"].world_view_transform,
                               look_from_z(4.0)[0], atol=1e-6)


@pytest.mark.parametrize("mode,direct", [("rgb", False), ("depth", False),
                                         ("rgb", True)])
def test_gui_test_step_matches_jax(mode, direct):
    js = gt_state(n=80, cap=256)
    shift = np.array([0.15, -0.05, 0.1], np.float32)

    def jdef(xyz, fid):
        d = jnp.asarray(shift) * (1.0 + fid)
        return (xyz + d if direct else jnp.ones_like(xyz) * d), 0.0, 0.0

    def tdef(xyz, fid):
        d = torch.from_numpy(shift) * (1.0 + fid)
        return (xyz + d if direct else torch.ones_like(xyz) * d), 0.0, 0.0

    frames = []
    for cls, state, deform in ((JGUI, js, jdef), (GUI, to_torch(js), tdef)):
        gui = cls(state, width=64, height=48, radius=3.0, deform_fn=deform,
                  direct_compute=direct)
        _moves(gui.cam)
        gui.playing, gui.fid, gui.mode = False, 0.3, mode
        frames.append(gui.test_step())
        assert gui.infer_ms > 0 and gui.fps > 0
    got, ref = frames[1], frames[0]
    assert got.shape == ref.shape == (48, 64, 3) and got.dtype == np.float32
    assert ref.max() > 0.1
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)


# ---- the trainers' tensorboard writer and live hook -------------------

@pytest.fixture(scope="module")
def tiny_scene():
    """Four 32x32 views of a ground-truth cloud (rendered by the port) and
    a fresh cloud to fit."""
    from d3gs_tpu_torch.models.renderer import render
    gt = to_torch(gt_state(n=60, cap=256))
    rng = np.random.default_rng(2)
    js = JG.create_from_pcd(rng.normal(0, 0.6, (80, 3)).astype(np.float32),
                            rng.uniform(0.2, 1, (80, 3)).astype(np.float32),
                            sh_degree=1, capacity=256)
    cams = []
    for k in range(4):
        cam = make_camera(angle=0.5 * k, width=32, height=32)
        with torch.no_grad():
            img = render(gt, to_torch_camera(cam, 0.0),
                         bg=torch.zeros(3)).image.numpy()
        cams.append(dataclasses.replace(cam, image=jnp.asarray(img),
                                        fid=jnp.asarray(k / 3, jnp.float32),
                                        image_name=f"v{k}"))
    return js, cams


def _run_trainer(package, trainer, js, cams):
    C = JC if package == "jax" else TC
    model = C.ModelParams(is_blender=True, D=2, W=16, sh_degree=1)
    opt = C.OptimizationParams(iterations=8, warm_up=3,
                               position_lr_max_steps=8, num_cams_per_iter=2)
    writer, hooks = RecordingWriter(), []
    kw = dict(train_cams=cams[:3], test_cams=cams[3:], cameras_extent=2.0,
              model_cfg=model, opt_cfg=opt, test_iterations={4, 8},
              seed=0, log_every=3, tb_writer=writer, progress=False)
    if package == "jax":
        kw["pipe_cfg"] = JC.PipelineParams(tile_capacity=256, tile_chunk=16)
        fn = jax_train_baseline if trainer == "baseline" \
            else jax_train_flagship
        state = jax.tree.map(jnp.copy, js)     # the trainer donates it
    else:
        kw["pipe_cfg"] = TC.PipelineParams()
        kw["train_cams"] = [to_torch_camera(c, c.fid) for c in cams[:3]]
        kw["test_cams"] = [to_torch_camera(c, c.fid) for c in cams[3:]]
        from d3gs_tpu_torch.train.baseline import train_baseline
        from d3gs_tpu_torch.train.flagship import train_flagship
        fn = train_baseline if trainer == "baseline" else train_flagship
        state = to_torch(js)
    if trainer == "baseline":
        kw["live_hook"] = lambda st, ds, field, it: hooks.append(
            (it, int(st.num_alive), ds is not None, field.spec.kind))
    result = fn(gaussians=state, **kw)
    assert set(result.test_psnrs) == {4, 8}
    assert all(math.isfinite(v) for vs in writer.scalars.values()
               for v in vs), writer.scalars
    return writer.events, hooks


@pytest.mark.parametrize("trainer", ["baseline", "flagship"])
def test_trainer_hooks_match_jax(tiny_scene, trainer):
    js, cams = tiny_scene
    ref, ref_hooks = _run_trainer("jax", trainer, js, cams)
    got, hooks = _run_trainer("torch", trainer, js, cams)
    assert got == ref
    assert hooks == ref_hooks
    tags = {e[1] for e in got}
    assert {"test/psnr", "scene/opacity_histogram", "iter_time",
            "test_view_0/render", "test_view_0/ground_truth"} <= tags
    if trainer == "baseline":
        assert [h[0] for h in hooks] == [1, 3, 6]


def test_true_spiral_matches_jax():
    ref = np.asarray(jax_ode_demo.true_spiral(100))
    from d3gs_tpu_torch.ode_demo import true_spiral
    got = true_spiral(100).numpy()
    assert got.shape == ref.shape == (100, 2)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_ode_demo_cli_on_cpu(tmp_path):
    from d3gs_tpu_torch.ode_demo import main
    for demo in ("spiral", "sine3d"):
        mse = main(["--demo", demo, "--iterations", "3", "--num_points",
                    "20", "--out", str(tmp_path), "--device", "cpu"])
        with open(tmp_path / f"{demo}_result.json") as f:
            res = json.load(f)
        assert res["rollout_mse"] == mse and math.isfinite(mse)
        assert len(res["losses"]) == 2          # iterations 0 and 2


def test_train_loops_cli_on_cpu(tmp_path):
    from d3gs_tpu_torch.train_loops import main
    data = write_blender_dataset(str(tmp_path / "data"), n_train=4,
                                 n_test=1, size=32)
    out = str(tmp_path / "sweep")
    res = main(["-s", data, "-m", out, "--eval", "--is_blender", "--quiet",
                "--iterations", "6", "--warm_up", "3", "--num_cams_per_iter",
                "2", "--position_lr_max_steps", "6", "--sh_degree", "1",
                "--max_gaussians", "400", "--D", "2", "--W", "16",
                "--sequence_lengths", "2", "4", "--device", "cpu"])
    assert sorted(res) == [2, 4] and all(math.isfinite(v)
                                         for v in res.values())
    for seq in (2, 4):
        d = os.path.join(out, f"seq_{seq}")
        assert os.path.exists(os.path.join(d, "cfg_args"))
        assert os.path.exists(os.path.join(
            d, "point_cloud", "iteration_6", "point_cloud.ply"))


# ---- train_gui in a subprocess ---------------------------------------

def _checkpoint(root):
    """A blender dataset and a model directory holding an SH-1 checkpoint
    of the dataset's scene with a narrow deform MLP."""
    from d3gs_tpu_torch.data.scene import save_gaussians_ply
    from d3gs_tpu_torch.models.deform.fields import (DeformFieldSpec,
                                                     create_deform_field,
                                                     save_deform_weights)
    data = write_blender_dataset(str(root / "data"), n_train=3, n_test=1,
                                 size=32)
    mp = str(root / "model")
    st = to_torch(gt_state(n=60, cap=256))
    os.makedirs(os.path.join(mp, "point_cloud", "iteration_3"))
    save_gaussians_ply(os.path.join(mp, "point_cloud", "iteration_3",
                                    "point_cloud.ply"), st)
    save_deform_weights(mp, 3, create_deform_field(
        DeformFieldSpec(kind="baseline", is_blender=True, D=2, W=16),
        device="cpu"))
    return data, mp


def _serve(args, frames=3, size=(24, 16), wait_done=False):
    """Run train_gui on the CPU in a subprocess, take `frames` frames
    through a loopback client, stop it with SIGINT; -> (frames as (image,
    verify), stdout, exit code)."""
    r = serve_train_gui([*args, "--device", "cpu"], frames,
                        client_message(*size, *look_from_z(4.0)),
                        wait_done=wait_done, timeout=120)
    return [f[:2] for f in r["frames"]], r["output"], r["rc"]


def test_train_gui_serves_and_stops_on_sigint(tmp_path):
    data, mp = _checkpoint(tmp_path)
    common = ["-s", data, "--is_blender", "--sh_degree", "1", "--D", "2",
              "--W", "16"]
    frames, out, rc = _serve(["-m", mp, "--view_only", *common])
    assert rc == 0, out
    for img, verify in frames:
        assert img.shape == (16, 24, 3) and img.max() > 0
        assert verify == data
    frames, out, rc = _serve(["-m", str(tmp_path / "gui"), *common,
                              "--iterations", "30", "--warm_up", "10",
                              "--max_gaussians", "300"], frames=4,
                             wait_done=True)
    assert rc == 0 and "training done" in out, out
    assert all(img.shape == (16, 24, 3) for img, _ in frames)


@pytest.mark.parametrize("module,argv", [
    ("train_baseline_sam", []), ("forecast.__main__", ["--trajectories",
                                                       "t.npy"]),
    ("ode_demo", []), ("train_gui", []), ("train_loops", [])])
def test_new_clis_default_to_the_card(module, argv):
    """Each new entry point runs on `cuda` unless `--device cpu` is given,
    and raises where there is no card rather than dropping to the CPU."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    main = importlib.import_module(f"d3gs_tpu_torch.{module}").main
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(argv)
