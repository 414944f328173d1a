"""The port's synthetic-trajectory harness (`d3gs_tpu_torch/train/
synth_ode.py`, CLIs `python -m d3gs_tpu_torch.train_synth_ode` and
`render_synth_ode`) against the JAX package's `train/synth_ode.py` on the
CPU.

The analytic curves within 1e-6 (linspace rounds differently); one step's
L1 loss and gradients on the same per-sample windows (the JAX
`sample_windows` of one key) within rtol 1e-5 and 1e-4 of the largest
gradient (summation order only; the RK4 path on (N, T) grids); the
windows' layout; and a CPU run of both CLIs, whose npz the JAX package's
`render_synth_ode.py` reads back to the same rollout within 1e-5.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
from d3gs_tpu.train import synth_ode as JS
from d3gs_tpu_torch.models.deform import fields as F
from d3gs_tpu_torch.train import synth_ode as TS
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


def _flat(params) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.mark.parametrize("name", ["linear", "sine", "quadratic"])
def test_trajectories_match_jax(name):
    gen_j = {"linear": JS.linear_trajectory, "sine": JS.sine_wave_trajectory,
             "quadratic": JS.quadratic_trajectory}[name]
    s, e = [0.0, 0.0, 0.0], [1.0, 0.5, -0.5]
    ref = gen_j(jnp.asarray(s), jnp.asarray(e), 37)
    got = TS.GENERATORS[name](torch.tensor(s), torch.tensor(e), 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_sample_windows_layout():
    traj = TS.sine_wave_trajectory(torch.zeros(3), torch.ones(3), 50)
    gen = torch.Generator().manual_seed(3)
    y0, ts, y = TS.sample_windows(gen, traj, 6, 8)
    assert y0.shape == (6, 3) and ts.shape == (6, 8) and y.shape == (8, 6, 3)
    starts = torch.round(ts[:, 0] * 50).long()
    assert torch.equal(y0, traj[starts])
    assert torch.equal(y[:, 2], traj[starts[2]:starts[2] + 8])
    assert torch.equal(ts[1], (starts[1] + torch.arange(8)).float() / 50)


@pytest.mark.parametrize("kind", ["simple", "ode"])
def test_synth_step_matches_jax(kind):
    kw = dict(kind=kind, n_substeps=2)
    if kind == "ode":
        kw.update(D=2, W=16)
    dstate, field = create_deform_field(DeformFieldSpec(**kw),
                                        jax.random.PRNGKey(4))
    tfield = F.create_deform_field(F.DeformFieldSpec(**kw), device="cpu")
    tfield.net.load_state_dict(F.params_from_flax(_flat(dstate.params),
                                                  tfield.net))
    traj = JS.sine_wave_trajectory(jnp.zeros(3), jnp.asarray([1.0, 0.5, -0.5]),
                                   40)
    y0, ts, y = JS.sample_windows(jax.random.PRNGKey(7), traj, 6, 5)

    def loss_fn(params):
        ys = field.step_multi(params, y0, ts, y0=y0)[0]
        return jnp.mean(jnp.abs(ys - y))
    jloss, jgrads = jax.value_and_grad(loss_fn)(dstate.params)
    ref = F.params_from_flax(_flat(jgrads), tfield.net)

    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    loss = TS.window_loss(tfield, t(y0), t(ts), t(y))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    grads = torch.autograd.grad(loss, list(tfield.net.parameters()))
    for (name, _), g in zip(tfield.net.named_parameters(), grads):
        scale = np.abs(ref[name].numpy()).max()
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_synth_clis_on_cpu_and_jax_reads_the_npz(tmp_path):
    from d3gs_tpu_torch import render_synth_ode as R
    from d3gs_tpu_torch import train_synth_ode as T
    out = str(tmp_path / "synth")
    mse = T.main(["--device", "cpu", "--iterations", "3", "--num_points",
                  "30", "--batch_size", "4", "--window", "4", "--out", out,
                  "--trajectory", "quadratic", "--no_plot"])
    with open(os.path.join(out, "losses.json")) as f:
        rec = json.load(f)
    assert rec["rollout_mse"] == pytest.approx(mse)
    assert [it for it, _ in rec["losses"]] == [0, 2]
    npz = os.path.join(out, "deform_params.npz")
    again = R.main(["--device", "cpu", "--params", npz, "--num_points", "30",
                    "--trajectory", "quadratic", "--out", out])
    assert again == pytest.approx(mse, rel=1e-6)
    import render_synth_ode as jax_cli
    ref = jax_cli.main(["--params", npz, "--num_points", "30",
                        "--trajectory", "quadratic", "--out", out])
    assert ref == pytest.approx(mse, rel=1e-5, abs=1e-7)
