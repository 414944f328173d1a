"""The port's trajectory distillation (`d3gs_tpu_torch/train/distill.py`,
CLI `python -m d3gs_tpu_torch.train_synth_gau`) against the JAX package's
`make_distill_step` on the CPU, and a CPU run of the CLI on a baseline
run's checkpoint.

One step on the same window (the JAX step's start index, drawn from its
key): the loss against the JAX step's own loss, and the student's
gradients against jax.grad of the same loss (the JAX step keeps its
gradients to itself). Tolerances: with the RK4 student, loss rtol 1e-5 and
gradients 3e-4 of the largest entry (summation order only, through 16 RK4
evaluations; the Blender timenet's first layer reads 1.2e-4); with the
adaptive `simple_start` student at rtol 1e-5 / atol 1e-7, 2e-3 (the two
solves take slightly different steps; the small `ode` net's adjoint is too
loose at these tolerances to compare, tests/test_torch_port_ode_adaptive.py).
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.config import OptimizationParams
from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
from d3gs_tpu.train.distill import make_distill_step as jax_make_step
from d3gs_tpu_torch.models.deform import fields as F
from d3gs_tpu_torch.train import distill as TD
from tests.test_cli_end_to_end import write_blender_dataset
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

DATA_SIZE, BATCH_TIME = 30, 5


def _flat(params) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _pair(seed, **kw):
    dstate, field = create_deform_field(DeformFieldSpec(**kw),
                                        jax.random.PRNGKey(seed),
                                        OptimizationParams())
    tfield = F.create_deform_field(F.DeformFieldSpec(**kw), device="cpu")
    tfield.net.load_state_dict(F.params_from_flax(_flat(dstate.params),
                                                  tfield.net))
    return dstate, field, tfield


def _rel(got, ref, tol, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), msg
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, f"{msg}: {err:.3e} of the largest > {tol}"


@pytest.mark.parametrize("kind,solver,tol", [
    ("ode", "rk4", 3e-4), ("simple_start", "rk4", 3e-4),
    ("simple_start", "adaptive", 2e-3)])
def test_distill_step_matches_jax(kind, solver, tol):
    tstate, tfield_j, tfield = _pair(1, kind="baseline", is_blender=True,
                                     D=2, W=32)
    kw = dict(kind=kind, solver=solver, rtol=1e-5, atol=1e-7)
    if kind == "ode":
        kw.update(is_blender=True, D=2, W=16)
    sstate, sfield_j, sfield = _pair(2, **kw)
    xyz = np.random.default_rng(0).uniform(-1, 1, (24, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    # the JAX step's window: s from the first half of its key
    s = int(jax.random.randint(jax.random.split(key)[0], (), 0,
                               DATA_SIZE - BATCH_TIME))
    step = jax_make_step(teacher_field=tfield_j, student_field=sfield_j,
                         data_size=DATA_SIZE, batch_time=BATCH_TIME)
    _, jloss = step(sstate, tstate.params, jnp.asarray(xyz), key,
                    jnp.asarray(1.0))

    batch_t = (s + jnp.arange(BATCH_TIME)).astype(jnp.float32) \
        * (1.0 / DATA_SIZE)
    np.testing.assert_array_equal(
        np.asarray(batch_t, np.float32),
        np.asarray(TD.window_times(s, BATCH_TIME, DATA_SIZE), np.float32))
    true_y = jax.vmap(lambda t: jnp.asarray(xyz) + tfield_j.step(
        tstate.params, jnp.asarray(xyz), t)[0])(batch_t)

    def loss_fn(params):
        pred = sfield_j.step_multi(params, true_y[0], batch_t, y0=true_y[0])[0]
        return jnp.mean(jnp.abs(pred - true_y))
    jgrads = F.params_from_flax(_flat(jax.grad(loss_fn)(sstate.params)),
                                sfield.net)

    loss_and_grads, _ = TD.make_distill_step(
        teacher_field=tfield, student_field=sfield, data_size=DATA_SIZE,
        batch_time=BATCH_TIME)
    loss, grads = loss_and_grads(torch.from_numpy(xyz), s)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=max(tol, 1e-5))
    for (name, _), g in zip(sfield.net.named_parameters(), grads):
        _rel(g.numpy(), jgrads[name].numpy(), tol, name)


@pytest.fixture(scope="module")
def teacher_run(tmp_path_factory):
    """A baseline run of the port's train CLI: the teacher's checkpoint."""
    from d3gs_tpu_torch.train.__main__ import main as train_main
    root = tmp_path_factory.mktemp("port_distill")
    data = write_blender_dataset(str(root / "data"), n_train=4, n_test=2,
                                 size=32)
    base = str(root / "base")
    train_main(["-s", data, "-m", base, "--eval", "--is_blender",
                "--device", "cpu", "--quiet", "--D", "2", "--W", "32",
                "--sh_degree", "1", "--max_gaussians", "300",
                "--iterations", "4", "--warm_up", "2",
                "--test_iterations", "4", "--save_iterations", "4"])
    return data, base, root


@pytest.mark.parametrize("solver", ["rk4", "adaptive"])
def test_train_synth_gau_cli_on_cpu(teacher_run, solver):
    from d3gs_tpu_torch.train_synth_gau import main
    data, base, root = teacher_run
    mp = str(root / f"distill_{solver}")
    result = main(["-s", data, "-m", mp, "--base_model_path", base,
                   "--is_blender", "--eval", "--is_ode", "--D", "2",
                   "--W", "32", "--sh_degree", "1", "--ode_solver", solver,
                   "--max_gaussians", "300",
                   "--distill_iterations", "3", "--data_size", "20",
                   "--batch_time", "4", "--test_iterations", "3",
                   "--device", "cpu", "--quiet"])
    assert result.field.spec.kind == "ode"
    assert result.field.spec.solver == solver
    assert result.deform_state.count == 3
    assert all(math.isfinite(v) for _, v in result.losses)
    assert 3 in result.test_psnrs and math.isfinite(result.test_psnrs[3])
    assert os.path.exists(os.path.join(mp, "deform", "iteration_3",
                                       "deform.npz"))
    with open(os.path.join(mp, "distill_result.json")) as f:
        assert json.load(f)["best_psnr"] == result.best_psnr
