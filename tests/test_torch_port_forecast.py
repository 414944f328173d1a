"""The port's trajectory forecaster against the JAX package on the CPU.

* The forward of flax weights carried across by `forecaster_from_flax`
  against flax's apply: atol 1e-5 (two encoder and two decoder blocks,
  d_model 16, 4 heads), and on a model with one of each.
* `normalize_window`: mean and deviation within 1e-6 relative, the
  normalized window within 1e-5; `make_windows` bit-equal.
* One training step from the same weights: the loss within 1e-5 relative
  of jax.value_and_grad's, the parameters after the written-out Adam
  within 1e-3·lr of JAX's update wherever JAX's gradient is at least 1e-4
  of the largest (over 90 % of the entries), and moved at most lr
  elsewhere (the key projection's bias has a zero gradient up to
  rounding: the softmax does not see a shift shared by every key).
* `forecast` (the autoregressive rollout) against JAX's: atol 1e-5.
* `python -m d3gs_tpu_torch.forecast --device cpu` on a tiny set: its
  windows, split and naive_mse are JAX's.
"""
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.forecast import model as JM
from d3gs_tpu.forecast import train as JT
from d3gs_tpu_torch.forecast import model as TM
from d3gs_tpu_torch.forecast import train as TT
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

LP, LF = 12, 6


def _trajectories(rng, t=LP + LF, n=24):
    """(t, n, 3) smooth random curves of magnitude ~1."""
    ts = np.linspace(0, 1, t)[:, None, None]
    a, b, c = (rng.normal(0, s, (1, n, 3)) for s in (1.0, 0.5, 0.3))
    w = rng.uniform(2, 6, (1, n, 3))
    return (a + b * ts + c * np.sin(w * ts)).astype(np.float32)


def _flax(rng, enc, dec, seed=0):
    model = JM.TrajectoryForecaster(d_model=16, n_heads=4, enc_layers=enc,
                                    dec_layers=dec)
    past = jnp.asarray(rng.normal(size=(2, LP, 3)), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), past,
                                 past[:, :LF])
    return model, params


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def windows():
    traj = _trajectories(np.random.default_rng(0))
    past, future = JT.make_windows(traj, LP, LF, stride=1)
    return past[:20], future[:20]


@pytest.mark.parametrize("enc,dec", [(2, 2), (1, 1)])
def test_forward_with_flax_weights(windows, enc, dec):
    past, future = windows
    model, params = _flax(np.random.default_rng(1), enc, dec)
    pn, _, _ = JM.normalize_window(jnp.asarray(past))
    fut_in = jnp.concatenate([pn[:, -1:], jnp.asarray(future)[:, :-1]], 1)
    ref = np.asarray(jax.jit(model.apply)(params, pn, fut_in))
    tmodel = TM.forecaster_from_flax(_np(params))
    assert len(tmodel.enc_blocks) == enc and len(tmodel.dec_blocks) == dec
    with torch.no_grad():
        got = tmodel(torch.from_numpy(np.array(pn)),
                     torch.from_numpy(np.array(fut_in))).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_normalize_window_and_make_windows(windows):
    past, _ = windows
    got = TM.normalize_window(torch.from_numpy(past))
    ref = JM.normalize_window(jnp.asarray(past))
    # the normalized window carries the mean's rounding over sd
    for a, b, tol in zip(got, ref, ({"atol": 1e-5}, {"rtol": 1e-6},
                                    {"rtol": 1e-6})):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    traj = _trajectories(np.random.default_rng(2), t=47, n=5)
    for args in ((12, 6, 1), (20, 10, 7), (30, 17, 5)):
        for a, b in zip(TT.make_windows(traj, *args),
                        JT.make_windows(traj, *args)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def _jax_step(model, params, pb, fb, lr):
    """d3gs_tpu/forecast/train.py's step on a fresh Adam state."""
    pn, mu, sd = JM.normalize_window(pb)
    fn = (fb - mu) / sd
    fut_in = jnp.concatenate([pn[:, -1:], fn[:, :-1]], axis=1)

    def loss_fn(p):
        return jnp.mean((model.apply(p, pn, fut_in) - fn) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    t = jnp.float32(1)
    c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t

    def upd(p, g):
        m, v = 0.1 * g, 0.001 * g * g
        return p - lr * (m / c1) / (jnp.sqrt(v / c2) + 1e-8)

    return loss, grads, jax.tree.map(upd, params, grads)


def test_one_training_step_matches_jax(windows):
    past, future = windows
    lr = 1e-3
    model, params = _flax(np.random.default_rng(3), 1, 1, seed=4)
    loss, grads, new = jax.jit(
        lambda p, a, b: _jax_step(model, p, a, b, lr))(
            params, jnp.asarray(past), jnp.asarray(future))
    tmodel = TM.forecaster_from_flax(_np(params))
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    step = TT.make_train_step(tmodel, lr)
    state, tloss = step(TT.init_state(tmodel), torch.from_numpy(past),
                        torch.from_numpy(future))
    assert state.count == 1
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    after = TM.forecaster_from_flax(_np(new)).state_dict()
    gmap = {k: np.abs(v.numpy()) for k, v in TM.forecaster_from_flax(
        _np(grads)).state_dict().items()}
    floor = 1e-4 * max(g.max() for g in gmap.values())
    compared = 0
    for name, p in tmodel.state_dict().items():
        dt = (p - before[name]).numpy()
        dj = (after[name] - before[name]).numpy()
        big = gmap[name] >= floor
        compared += big.sum()
        np.testing.assert_allclose(dt[big], dj[big], atol=1e-3 * lr,
                                   err_msg=name)
        assert np.abs(dt).max() <= lr * 1.001, name   # p − lr, rounded
    assert compared > 0.9 * sum(g.size for g in gmap.values())


def test_forecast_rollout_matches_jax(windows):
    past, future = windows
    model, params = _flax(np.random.default_rng(5), 2, 2, seed=6)
    ref = np.asarray(JT.forecast(model, SimpleNamespace(params=params),
                                 jnp.asarray(past), LF))
    tmodel = TM.forecaster_from_flax(_np(params))
    got = TT.forecast(tmodel, torch.from_numpy(past), LF).numpy()
    assert got.shape == ref.shape == (len(past), LF, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # the rollout feeds its predictions back in: not the teacher-forced pass
    ev = TT.evaluate_forecaster(tmodel, past, future, batch=7)
    assert np.isfinite(ev["mse"]) and np.isfinite(ev["mae"])


def test_cli_on_a_tiny_set(tmp_path):
    from d3gs_tpu_torch.forecast.__main__ import main
    traj = _trajectories(np.random.default_rng(7), t=30, n=40)
    path = str(tmp_path / "trajectories.npy")
    np.save(path, traj)
    out = str(tmp_path / "out")
    metrics = main(["--trajectories", path, "--output_dir", out,
                    "--past_len", "10", "--future_len", "5", "--stride",
                    "5", "--d_model", "16", "--epochs", "2", "--batch_size",
                    "32", "--max_gaussians", "30", "--device", "cpu"])
    with open(os.path.join(out, "metrics.json")) as f:
        assert json.load(f) == metrics
    assert set(metrics) == {"mse", "mae", "naive_mse"}
    assert all(np.isfinite(v) for v in metrics.values())
    # JAX's subsample and split (forecast.py)
    sel = np.random.default_rng(0).choice(40, 30, replace=False)
    past, future = JT.make_windows(traj[:, sel], 10, 5, 5)
    va = np.random.default_rng(0).permutation(len(past))[:max(
        int(len(past) * 0.1), 1)]
    assert metrics["naive_mse"] == pytest.approx(float(np.mean(
        (past[va][:, -1:, :] - future[va]) ** 2)), rel=1e-6)
