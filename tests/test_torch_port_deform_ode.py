"""The port's slice-3 deformation pieces against the JAX package on the CPU:
the SE(3) exponential, the 6DoF head, `DeformNetworkODE` (use_linear 0-4,
with and without the Blender timenet), `DeformNetworkSimple` /
`...SimpleStart`, the RK4 integrator on shared (T,) and per-sample (N, T)
grids (values and gradients), the fields' `step` / `step_multi`, the
deform Adam with `scale_lr` and weight decay, and the npz checkpoints.

Weights are carried across by `params_from_flax`. Tolerances: network
outputs and the integral of the small ODE net rtol 1e-5 with atol 1e-5 of
the largest |output| (the two frameworks sum the dot products in different
orders); the fields' integrated steps atol 1e-4 of the largest (16
evaluations of the 512-wide tanh nets, whose N(0, 0.2) weights saturate
tanh, compound those differences: 1.7e-5 of the largest was seen);
gradients 1e-4 of their largest entry; the analytic oracles of
tests/test_deform.py at their own atol 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.config import OptimizationParams
from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
from d3gs_tpu.models.deform.fields import load_deform_weights as jax_load
from d3gs_tpu.models.deform.fields import save_deform_weights as jax_save
from d3gs_tpu.models.deform.ode import odeint_grid as jax_odeint_grid
from d3gs_tpu.ops import transforms as JT
from d3gs_tpu_torch import config as TC
from d3gs_tpu_torch.models.deform import fields as F
from d3gs_tpu_torch.models.deform import ode as O
from d3gs_tpu_torch.ops import transforms as TT
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


def _flat(params) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _close(got, ref, rtol=1e-5, rel_atol=1e-5, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape, msg)
    assert np.isfinite(got).all(), msg
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rel_atol * max(np.abs(ref).max(), 1e-30),
                               err_msg=msg)


def _pair(seed=0, **spec_kw):
    """The same field in both packages: JAX weights from PRNGKey(seed),
    carried into the port."""
    dstate, field = create_deform_field(DeformFieldSpec(**spec_kw),
                                        jax.random.PRNGKey(seed))
    tfield = F.create_deform_field(F.DeformFieldSpec(**spec_kw), seed=7,
                                   device="cpu")
    tfield.net.load_state_dict(F.params_from_flax(_flat(dstate.params),
                                                  tfield.net))
    return dstate, field, tfield


def _inputs(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, 1)).astype(np.float32))


def test_se3_matches_jax():
    rng = np.random.default_rng(1)
    S = rng.normal(size=(16, 6)).astype(np.float32)
    th = rng.uniform(-2, 2, 16).astype(np.float32)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    T = TT.exp_se3(torch.from_numpy(S), torch.from_numpy(th))
    _close(T, JT.exp_se3(jnp.asarray(S), jnp.asarray(th)))
    _close(TT.exp_so3(torch.from_numpy(S[:, :3]), torch.from_numpy(th)),
           JT.exp_so3(jnp.asarray(S[:, :3]), jnp.asarray(th)))
    _close(TT.apply_se3(T, torch.from_numpy(x)),
           JT.apply_se3(JT.exp_se3(jnp.asarray(S), jnp.asarray(th)),
                        jnp.asarray(x)))


ODE_NETS = [dict(use_linear=u, is_blender=b) for u in range(5)
            for b in (False, True)] + [dict(use_linear=2, use_emb=False),
                                       dict(use_linear=0, use_emb=False)]


@pytest.mark.parametrize("kw", ODE_NETS,
                         ids=lambda kw: "-".join(f"{k}{v}"
                                                 for k, v in kw.items()))
def test_ode_network_matches_flax(kw):
    """D = 8 so the skip at layer 4 is exercised."""
    dstate, field, tfield = _pair(kind="ode", D=8, W=64, **kw)
    x, t = _inputs()
    ref = field.apply(dstate.params, jnp.asarray(t), jnp.asarray(x))
    _close(tfield.net(torch.from_numpy(t), torch.from_numpy(x)), ref)
    # a scalar time broadcasts as in JAX
    _close(tfield.net(0.3, torch.from_numpy(x)),
           field.apply(dstate.params, jnp.asarray(0.3), jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["simple", "simple_start"])
def test_tanh_networks_match_flax(kind):
    dstate, field, tfield = _pair(kind=kind)
    x, t = _inputs()
    y0 = (x * 0.5 + 0.1).astype(np.float32)
    args = (jnp.asarray(t), jnp.asarray(x)) + (
        (jnp.asarray(y0),) if kind == "simple_start" else ())
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    _close(tfield.net(*targs), field.apply(dstate.params, *args))
    # N(0, 0.2) weights and zero biases from the generator
    w = torch.cat([lin.weight.detach().reshape(-1) for lin in
                   F.create_deform_field(F.DeformFieldSpec(kind=kind),
                                         device="cpu").net.flax_layers()
                   .values()])
    assert abs(float(w.std()) - 0.2) < 0.01


@pytest.mark.parametrize("kind", ["baseline", "warp"])
def test_6dof_head_matches_flax(kind):
    dstate, field, tfield = _pair(kind=kind, is_6dof=True, is_blender=True,
                                  D=8, W=64)
    x, _ = _inputs()
    ref = field.step(dstate.params, jnp.asarray(x), jnp.asarray(0.45))
    got = tfield.step(torch.from_numpy(x), 0.45)
    assert got[0].shape == (x.shape[0], 4, 4)
    for a, b in zip(got, ref):
        if isinstance(b, float):
            assert a == b == 0.0
        else:
            _close(a, b)
    # the renderer applies the SE(3) to the canonical means
    _close(TT.apply_se3(got[0], torch.from_numpy(x)),
           JT.apply_se3(ref[0], jnp.asarray(x)))


def _ode_pair(seed=3):
    return _pair(seed=seed, kind="ode", is_blender=True, D=3, W=32,
                 n_substeps=3)


def _jax_f(field, params):
    return lambda t, y: field.apply(params, t, y)


@pytest.mark.parametrize("grid", ["shared", "per_sample"])
def test_odeint_grid_matches_jax(grid):
    """Values and gradients (w.r.t. the net's parameters and y0) of the RK4
    integral through the grid; the shared grid repeats a time, so one
    segment has zero length."""
    dstate, field, tfield = _ode_pair()
    rng = np.random.default_rng(4)
    n = 24
    y0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    if grid == "shared":
        ts = np.array([0.1, 0.35, 0.35, 0.8], np.float32)
        t_ts = ts.tolist()
    else:
        ts = np.sort(rng.uniform(0, 1, (n, 4)), axis=1).astype(np.float32)
        t_ts = torch.from_numpy(ts)
    cot = rng.normal(size=(4, n, 3)).astype(np.float32)

    def jloss(params, y):
        ys = jax_odeint_grid(_jax_f(field, params), y, jnp.asarray(ts),
                             n_substeps=3)
        return jnp.sum(ys * cot), ys
    (_, ys_ref), (g_p, g_y) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(dstate.params, jnp.asarray(y0))

    ty0 = torch.from_numpy(y0).requires_grad_()
    ys = O.odeint_grid(tfield.net, ty0, t_ts, n_substeps=3)
    _close(ys, ys_ref)
    if grid == "shared":
        assert torch.equal(ys[2], ys[1])      # the zero-length segment
    params = list(tfield.net.parameters())
    grads = torch.autograd.grad((ys * torch.from_numpy(cot)).sum(),
                                [ty0, *params])
    _close(grads[0], g_y, rtol=0, rel_atol=1e-4, msg="y0")
    ref = F.params_from_flax(_flat(g_p), tfield.net)
    for (name, _), g in zip(tfield.net.named_parameters(), grads[1:]):
        _close(g, ref[name], rtol=0, rel_atol=1e-4, msg=name)


def test_rk4_substeps_are_checkpointed():
    """The backward re-runs each substep's four evaluations once: the
    autograd graph keeps the states between substeps, not the dynamics
    net's activations."""
    _, _, tfield = _ode_pair()
    calls = []

    def f(t, y):
        calls.append(torch.is_grad_enabled())
        return tfield.net(t, y)

    y0 = torch.rand((8, 3))
    ys = O.odeint_grid(f, y0, [0.0, 0.25, 0.5], n_substeps=3)
    n_fwd = len(calls)
    assert n_fwd == 2 * 3 * 4
    ys.sum().backward()
    assert len(calls) == 2 * n_fwd
    assert all(p.grad is not None for p in tfield.net.parameters())


def test_linear_system_analytic():
    """tests/test_deform.py:60 — dy/dt = A y with A = [[0, -w], [w, 0]]
    rotates by w·t."""
    w = 1.3
    A = torch.tensor([[0.0, -w], [w, 0.0]])
    y0 = torch.tensor([[1.0, 0.0], [0.0, 2.0]])
    ys = O.odeint_grid(lambda t, y: y @ A.T, y0,
                       torch.linspace(0.0, 1.0, 11), n_substeps=8)
    R = np.array([[math.cos(w), -math.sin(w)], [math.sin(w), math.cos(w)]])
    np.testing.assert_allclose(ys[-1].numpy(), y0.numpy() @ R.T, atol=1e-5)


def test_per_sample_grids_analytic():
    """tests/test_deform.py:81 — dy/dt = t through each sample's own grid:
    y(T) - y(0) = (t1² - t0²) / 2."""
    ts = torch.stack([torch.linspace(0.0, 1.0, 5),
                      torch.linspace(0.5, 1.5, 5),
                      torch.linspace(2.0, 4.0, 5)])
    ys = O.odeint_grid(lambda t, y: t.reshape(-1, 1).expand_as(y),
                       torch.zeros((3, 1)), ts, n_substeps=4)
    want = (ts[:, -1] ** 2 - ts[:, 0] ** 2) / 2
    np.testing.assert_allclose(ys[-1][:, 0].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["ode", "simple", "simple_start"])
def test_field_steps_match_jax(kind):
    """`step` integrates from 0 with 2·n_substeps (t = 0 returns the input
    bit for bit); `step_multi` anchors the trajectory at ts[0]."""
    kw = dict(kind=kind, n_substeps=2)
    if kind == "ode":
        kw.update(is_blender=True, D=3, W=32)
    dstate, field, tfield = _pair(seed=5, **kw)
    x, _ = _inputs(n=16, seed=2)
    tx = torch.from_numpy(x)
    y0 = x * 0.8
    with torch.no_grad():
        for t in (0.0, 0.47):
            ref = field.step(dstate.params, jnp.asarray(x), jnp.asarray(t),
                             y0=jnp.asarray(y0))
            got = tfield.step(tx, t, y0=torch.from_numpy(y0))
            for a, b in zip(got, ref):
                _close(a, b, rel_atol=1e-4)
        assert torch.equal(tfield.step(tx, 0.0)[0], tx)
        ts = [0.2, 0.45, 0.6]
        ref = field.step_multi(dstate.params, jnp.asarray(x),
                               jnp.asarray(ts, jnp.float32),
                               y0=jnp.asarray(y0))
        got = tfield.step_multi(tx, ts, y0=torch.from_numpy(y0))
        for a, b in zip(got, ref):
            _close(a, b, rel_atol=1e-4)
        assert torch.equal(got[0][0], tx)


def test_mlp_step_multi_matches_jax():
    dstate, field, tfield = _pair(kind="baseline", is_blender=True, D=4,
                                  W=32)
    x, _ = _inputs(n=16, seed=3)
    ts = [0.1, 0.5, 0.9]
    ref = field.step_multi(dstate.params, jnp.asarray(x),
                           jnp.asarray(ts, jnp.float32))
    with torch.no_grad():
        got = tfield.step_multi(torch.from_numpy(x), ts)
    for a, b in zip(got, ref):
        _close(a, b)


def test_adam_scale_lr_and_weight_decay_match_jax():
    """The deform Adam of an ODE field with scale_lr (lr × k) and weight
    decay: one update from the same gradients."""
    kw = dict(kind="ode", is_blender=True, D=2, W=16)
    jopt = OptimizationParams(scale_lr=True, num_cams_per_iter=3,
                              weight_decay=0.01, deform_lr_max_steps=500)
    topt = TC.OptimizationParams(scale_lr=True, num_cams_per_iter=3,
                                 weight_decay=0.01, deform_lr_max_steps=500)
    dstate, field = create_deform_field(DeformFieldSpec(**kw),
                                        jax.random.PRNGKey(6), jopt)
    tfield = F.create_deform_field(F.DeformFieldSpec(**kw), device="cpu",
                                   opt_cfg=topt)
    tfield.net.load_state_dict(F.params_from_flax(_flat(dstate.params),
                                                  tfield.net))
    for it in (1, 120, 499):
        assert tfield.lr_at(it) == pytest.approx(float(field.lr_at(it)),
                                                 rel=1e-6)
    grads = jax.tree.map(lambda p: jnp.cos(3.0 * p), dstate.params)
    new = field.update(dstate, grads, jnp.asarray(120.0))
    tgrads = F.params_from_flax(_flat(grads), tfield.net)
    tstate = tfield.update(tfield.init_state(),
                           [tgrads[n] for n, _ in
                            tfield.net.named_parameters()], 120)
    ref = F.params_from_flax(_flat(new.params), tfield.net)
    for name, p in tfield.net.named_parameters():
        _close(p, ref[name], rtol=1e-6, rel_atol=1e-6, msg=name)
    assert tstate.count == int(new.count) == 1


@pytest.mark.parametrize("kind", ["ode", "simple_start"])
def test_ode_npz_carries_across(kind, tmp_path):
    kw = dict(kind=kind, is_blender=True, D=3, W=32)
    dstate, field, _ = _pair(seed=8, **kw)
    jax_save(str(tmp_path / "a"), 5, dstate)
    tfield = F.create_deform_field(F.DeformFieldSpec(**kw), seed=1,
                                   device="cpu")
    F.load_deform_weights(str(tmp_path / "a"), tfield)
    x, t = _inputs(n=12, seed=4)
    args = (jnp.asarray(t), jnp.asarray(x)) + (
        (jnp.asarray(x),) if kind == "simple_start" else ())
    with torch.no_grad():
        _close(tfield.net(*(torch.from_numpy(np.asarray(a)) for a in args)),
               field.apply(dstate.params, *args))
    F.save_deform_weights(str(tmp_path / "b"), 2, tfield)
    other, _ = create_deform_field(DeformFieldSpec(**kw),
                                   jax.random.PRNGKey(9))
    back = jax_load(str(tmp_path / "b"), other)
    for k, v in _flat(back.params).items():
        np.testing.assert_array_equal(v, _flat(dstate.params)[k])
    with pytest.raises(KeyError, match="do not match"):
        F.params_from_flax(_flat(other.params), F.create_deform_field(
            F.DeformFieldSpec(kind="warp"), device="cpu").net)
