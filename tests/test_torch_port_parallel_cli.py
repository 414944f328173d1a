"""The port's train CLI on two gloo ranks on the CPU, launched as a user
launches it on cards:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m d3gs_tpu_torch.train --device cpu --trainer flagship \
        --mesh_shape 2 [--mesh_mode gauss_tile] ...

on a small Blender set (32x32, 600 Gaussians, k = 3, six iterations
through the warm-up, one densify pass, an evaluation and a checkpoint),
in both layouts. The checkpoint loads in the JAX package; in the
gauss_tile layout (no padding, so the same picks) the first step's loss
equals the single-device CLI's within 1e-5 relative. A --mesh_shape
without a matching WORLD_SIZE raises, and so does the baseline trainer at
a world size above 1.
"""
import os
import re
import subprocess
import sys

import jax
import pytest

import d3gs_tpu.train.flagship as JF
from d3gs_tpu.config import ModelParams, OptimizationParams
from d3gs_tpu.data.scene import load_gaussians_ply as jax_load_ply
from d3gs_tpu.models.deform import create_deform_field
from d3gs_tpu.models.deform.fields import load_deform_weights as jax_load_npz
from tests.test_cli_end_to_end import write_blender_dataset
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--eval", "--is_blender", "--device", "cpu", "--trainer",
        "flagship", "--D", "2", "--W", "32", "--sh_degree", "1",
        "--max_gaussians", "600", "--num_cams_per_iter", "3",
        "--iterations", "6", "--warm_up", "3", "--densify_from_iter", "3",
        "--densify_until_iter", "6", "--densification_interval", "4",
        "--densify_grad_threshold", "1e-9", "--test_iterations", "6",
        "--position_lr_max_steps", "10", "--deform_lr_max_steps", "10"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_cli")
    return root, write_blender_dataset(str(root / "data"), n_train=6,
                                       n_test=2, size=32)


def _launch(mp, data_dir, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "d3gs_tpu_torch.train",
           "-s", data_dir, "-m", mp, *ARGS, *extra]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _first_loss(stdout):
    return float(re.search(r"\[flagship 1/6\] loss \S+ \(step (\S+)\)",
                           stdout).group(1))


@pytest.mark.parametrize("mode", ["camera", "gauss_tile"])
def test_cli_on_two_ranks(data, mode):
    root, data_dir = data
    mp = str(root / f"model_{mode}")
    stdout = _launch(mp, data_dir, "--mesh_shape", "2", "--mesh_mode", mode)
    assert "backend gloo, world size 2" in stdout
    assert stdout.count("[flagship 1/6]") == 1      # rank 0 logs alone
    assert "Best PSNR" in stdout
    for f in ("cfg_args", "point_cloud/iteration_6/point_cloud.ply",
              "deform/iteration_6/deform.npz"):
        assert os.path.exists(os.path.join(mp, f)), f
    js = jax_load_ply(os.path.join(mp, "point_cloud", "iteration_6",
                                   "point_cloud.ply"), sh_degree=1)
    assert int(js.num_alive) > 0
    spec = JF.pick_field_spec(ModelParams(is_blender=True, D=2, W=32),
                              OptimizationParams())
    dstate, _ = create_deform_field(spec, jax.random.PRNGKey(0))
    jax_load_npz(mp, dstate)
    if mode == "gauss_tile":
        from d3gs_tpu_torch.train.__main__ import main
        single = main(["-s", data_dir, "-m", str(root / "single"), *ARGS,
                       "--quiet"])
        assert _first_loss(stdout) == pytest.approx(single.losses[0][1],
                                                    rel=1e-5)


def test_mesh_shape_needs_a_matching_world_size(data, monkeypatch):
    from d3gs_tpu_torch.train.__main__ import main
    root, data_dir = data
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="needs 2 ranks, but WORLD_SIZE is 3"):
        main(["-s", data_dir, "-m", str(root / "m"), *ARGS,
              "--mesh_shape", "2"])
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="baseline trainer runs on one"):
        main(["-s", data_dir, "-m", str(root / "m"), "--device", "cpu",
              "--mesh_shape", "2x2"])
