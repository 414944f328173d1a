"""The port's adaptive Dopri5 (`d3gs_tpu_torch/models/deform/ode.py`)
against the JAX package's `odeint_adaptive`, which wraps
`jax.experimental.ode.odeint`, on the CPU.

* The solver's pieces against jax.experimental.ode's own functions, on the
  same inputs: first step, Dopri5 step, error ratio, step controller, dense
  output. Tolerance rtol 1e-6 (the stage sums are the same sequence of
  fused multiply-adds; the dynamics and norms round differently).
* Values on shared (T,) and per-sample (N, T) grids with a duplicate time,
  through the fields' `step_multi` / `step` with `solver="adaptive"`,
  against the JAX fields, at rtol 1e-7 / atol 1e-9 and at the defaults
  1e-3 / 1e-4. The two frameworks' nets differ in the last bits of their
  dot products; the error estimate cancels to a few ulp of the stages, so
  those bits move the step sizes and the two solves agree to about the
  solver's own error: within 2e-4 of the largest |y| at 1e-7 / 1e-9
  (float32 rounding over hundreds of steps), 2e-2 at the defaults; and on
  the displacement ys - y0, within 5e-4 of its largest entry at 1e-7
  (measured 1.1e-4) and 5e-2 at the defaults (measured 2.5e-2), where
  each is ~5e-2 from the 1e-7 solve and the port's error may be at most
  1.5 times JAX's (measured 1.2). From zero: t <= 0 returns y0 itself,
  t > 0 as above, the displacement within 5e-4 and 1e-2.
* Gradients by the adjoint against `jax.grad` through the JAX adjoint
  (under `jit`, where the JAX package's trainers call it: every parameter
  and the `simple_start` anchor are in the backward's error norm). With
  dynamics whose evaluation rounds alike in both (elementwise polynomials)
  the step sequences coincide at the defaults: 1e-4 of the largest entry.
  With the tanh nets (`simple`, `simple_start`) at rtol 1e-5 / atol 1e-7,
  where both adjoints are close to the exact gradient: 2e-3 of the
  largest entry. The ReLU `ode` net at rtol 1e-7 / atol 1e-9, where both
  adjoints are closest to the exact gradient, on one sample over
  t in [0.1, 0.5]: 1e-2 of the largest entry (measured 3e-3; its kinks
  make both controllers reject about 2 of 3 steps, so the longer grids
  take minutes).
* Duplicate times are bit-equal to their first occurrence, and the solve
  counts add up.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import ode as JO

from d3gs_tpu.models.deform import DeformFieldSpec, create_deform_field
from d3gs_tpu.models.deform.ode import odeint_adaptive as jax_adaptive
from d3gs_tpu_torch import tracing
from d3gs_tpu_torch.models.deform import fields as F
from d3gs_tpu_torch.models.deform import ode as O
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

TIGHT, DEFAULT, MID = (1e-7, 1e-9), (1e-3, 1e-4), (1e-5, 1e-7)


def _flat(params) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _rel(got, ref, tol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape, msg)
    assert np.isfinite(got).all(), msg
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, f"{msg}: {err:.3e} of the largest > {tol}"


def _pair(kind, solver, tol, seed=3):
    kw = dict(kind=kind, solver=solver, rtol=tol[0], atol=tol[1])
    if kind == "ode":
        kw.update(is_blender=True, D=2, W=16)
    dstate, field = create_deform_field(DeformFieldSpec(**kw),
                                        jax.random.PRNGKey(seed))
    tfield = F.create_deform_field(F.DeformFieldSpec(**kw), device="cpu")
    tfield.net.load_state_dict(F.params_from_flax(_flat(dstate.params),
                                                  tfield.net))
    return dstate, field, tfield


def _grid(kind, n, seed=0):
    """(y0, anchor, ts) with a duplicate at index 2: a shared (5,) grid or
    (n, 5) per-sample grids."""
    rng = np.random.default_rng(seed)
    y0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    if kind == "shared":
        ts = np.array([0.1, 0.3, 0.3, 0.75, 0.9], np.float32)
    else:
        ts = np.sort(rng.uniform(0, 1, (n, 5)), axis=1).astype(np.float32)
        ts[:, 2] = ts[:, 1]
    return y0, (0.7 * y0).astype(np.float32), ts


def _torch_ts(ts):
    return ts.tolist() if ts.ndim == 1 else torch.from_numpy(ts)


# -- the pieces --------------------------------------------------------------

W3 = np.array([0.8, -0.4, 1.1], np.float32)


def _poly(y, t):
    return y * (W3 - y * y) * (1.0 + t)


def test_solver_pieces_match_jax():
    rng = np.random.default_rng(1)
    y0 = rng.normal(size=(4, 3)).astype(np.float32)
    rtol, atol = DEFAULT
    jf = lambda y, t: _poly(y.reshape(4, 3), t).ravel()  # noqa: E731
    tw = torch.from_numpy(W3)
    tf = lambda s, t: [s[0] * (tw - s[0] * s[0])  # noqa: E731
                       * (1.0 + t.reshape(()))]
    lanes, tab = O._Lanes(None), O._Tableau("cpu")
    t0 = np.float32(0.2)
    yj, yt = jnp.asarray(y0).ravel(), [torch.from_numpy(y0)]
    tt = torch.full((1,), t0)
    f0j, f0t = jf(yj, t0), tf(yt, tt)
    dtj = JO.initial_step_size(jf, t0, yj, 4, rtol, atol, f0j)
    dtt = O._initial_step_size(tf, tt, yt, f0t, rtol, atol, lanes)
    _rel(dtt, np.asarray(dtj).reshape(1), 1e-6, "initial step")
    y1j, f1j, ej, kj = JO.runge_kutta_step(jf, yj, f0j, t0, dtj)
    y1t, f1t, et, kt = O._rk_step(tf, tab, yt, f0t, tt, dtt, lanes)
    for got, ref, name in ((y1t[0], y1j, "y1"), (f1t[0], f1j, "f1"),
                           (kt[0], kj, "stages")):
        _rel(got.reshape(np.shape(ref)), ref, 1e-6, name)
    # the error estimate cancels to a few ulp of the stages: held to 1e-6
    # of dt·max|k| (the stages' own rounding), and the ratio on JAX's
    # estimate
    scale = float(dtt) * float(kt[0].abs().max())
    assert np.abs(et[0].numpy().ravel() - np.asarray(ej)).max() \
        <= 1e-6 * scale
    rj = JO.mean_error_ratio(ej, rtol, atol, yj, y1j)
    rt = O._mean_error_ratio([torch.from_numpy(np.array(ej)).reshape(4, 3)],
                             yt, y1t, rtol, atol, lanes)
    _rel(rt, np.asarray(rj).reshape(1), 1e-6, "error ratio")
    for ratio in (0.0, 0.03, 0.9, 1.0, 1.7, 40.0):
        _rel(O._optimal_step_size(dtt, torch.full((1,), ratio)),
             np.asarray(JO.optimal_step_size(dtj, jnp.float32(ratio))
                        ).reshape(1), 1e-6, f"step size at {ratio}")
    # on JAX's stages, the stage sums and the quartic round as XLA rounds
    kj_t = torch.from_numpy(np.array(kj)).reshape(7, 4, 3)
    _rel(lanes.bc(dtt, yt[0]) * O._comb(tab.c_error, kj_t), ej.reshape(4, 3),
         1e-6, "error estimate on JAX's stages")
    cj = JO.interp_fit_dopri(yj, y1j, kj, dtj)
    ct = O._interp_fit(tab, yt, [torch.from_numpy(np.array(y1j)).reshape(
        4, 3)], [kj_t], torch.from_numpy(np.array(dtj)).reshape(1),
        lanes)[0]
    for i in range(5):
        _rel(ct[i].reshape(-1), cj[i], 1e-6, f"coefficient {i}")
    for r in (0.0, 0.37, 1.0):
        _rel(O._polyval(ct, torch.tensor(r)).reshape(-1),
             jnp.polyval(cj, jnp.float32(r)), 1e-6, f"dense output at {r}")


def test_strict_increase_and_first_occurrence():
    from d3gs_tpu.models.deform.ode import _strict_increase
    ts = np.array([0.1, 0.3, 0.3, 0.3, 0.75, 0.75, 0.9], np.float32)
    np.testing.assert_array_equal(O._strict_increase(ts),
                                  np.asarray(_strict_increase(
                                      jnp.asarray(ts), 1e-6)))
    np.testing.assert_array_equal(O._first_occurrence(ts),
                                  [0, 1, 1, 1, 4, 4, 6])


# -- values ------------------------------------------------------------------

@pytest.mark.parametrize("tol", [TIGHT, DEFAULT], ids=["tight", "default"])
@pytest.mark.parametrize("grid", ["shared", "per_sample"])
def test_step_multi_values_match_jax(grid, tol):
    """The `ode` field through a grid with a duplicate time, held on the
    displacement; at the defaults also as accurate as JAX's solve against
    the 1e-7 one. The duplicate is bit-equal to its first occurrence."""
    dstate, field, tfield = _pair("ode", "adaptive", tol)
    y0, _, ts = _grid(grid, 6)
    ref = field.step_multi(dstate.params, jnp.asarray(y0), jnp.asarray(ts))[0]
    with torch.no_grad():
        got = tfield.step_multi(torch.from_numpy(y0), _torch_ts(ts))[0]
    _rel(got, ref, 2e-4 if tol == TIGHT else 2e-2, "ys")
    _rel(got - torch.from_numpy(y0), np.asarray(ref) - y0,
         5e-4 if tol == TIGHT else 5e-2, "ys - y0")
    if tol == DEFAULT:
        tstate, tight, _ = _pair("ode", "adaptive", TIGHT)
        exact = np.asarray(tight.step_multi(tstate.params, jnp.asarray(y0),
                                            jnp.asarray(ts))[0])
        err_port = np.abs(got.numpy() - exact).max()
        err_jax = np.abs(np.asarray(ref) - exact).max()
        assert err_port <= 1.5 * err_jax, (err_port, err_jax)
    assert torch.equal(got[2], got[1])
    assert torch.equal(got[0], torch.from_numpy(y0))


@pytest.mark.parametrize("kind", ["ode", "simple", "simple_start"])
def test_step_from_zero_matches_jax(kind):
    """t < 0 and t = 0 return y0 itself; t > 0 integrates from 0."""
    y0, anchor, _ = _grid("shared", 6, seed=2)
    ty0, tanc = torch.from_numpy(y0), torch.from_numpy(anchor)
    for tol in (TIGHT, DEFAULT):
        dstate, field, tfield = _pair(kind, "adaptive", tol, seed=5)
        for t in (-0.2, 0.0, 0.6):
            ref = field.step(dstate.params, jnp.asarray(y0), jnp.float32(t),
                             y0=jnp.asarray(anchor))[0]
            with torch.no_grad():
                got = tfield.step(ty0, t, y0=tanc)[0]
            if t <= 0:
                assert got is ty0
                np.testing.assert_array_equal(np.asarray(ref), y0)
            else:
                _rel(got, ref, 2e-4 if tol == TIGHT else 2e-2, f"t={t}")
                _rel(got - ty0, np.asarray(ref) - y0,
                     5e-4 if tol == TIGHT else 1e-2, f"t={t}, y - y0")


# -- gradients ---------------------------------------------------------------

class _Poly(torch.nn.Module):
    """dy/dt = y (w - y²)(1 + t) + 0.3 w·anchor: elementwise, so both
    frameworks round its evaluation alike."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(W3.copy()))

    def forward(self, t, y, anchor):
        return y * (self.w - y * y) * (1.0 + t) + anchor * self.w * 0.3


def _jax_poly(w, a):
    return lambda t, y, aa=None: (y * (w - y * y) * (1.0 + t)
                                  + (a if aa is None else aa) * w * 0.3)


def _jax_grads(f_of, params, y0, anchor, ts, cot, tol, per_sample):
    @jax.jit
    def loss(p, y, a):
        ys = jax_adaptive(f_of(p, a), y, jnp.asarray(ts), rtol=tol[0],
                          atol=tol[1], args=(a,) if per_sample else None)
        return jnp.sum(ys * cot)
    return jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(y0),
                                             jnp.asarray(anchor))


def _torch_grads(net, y0, anchor, ts, cot, tol):
    """-> (d/dy0, d/danchor or None, d/dparams...) of sum(ys · cot)."""
    ty0 = torch.from_numpy(y0).requires_grad_()
    tanc = None if anchor is None else torch.from_numpy(
        anchor).requires_grad_()
    ys = O.odeint_adaptive(net, ty0, _torch_ts(ts), rtol=tol[0],
                           atol=tol[1], anchor=tanc)
    assert torch.equal(ys[2], ys[1])
    grads = torch.autograd.grad((ys * torch.from_numpy(cot)).sum(),
                                [ty0, *([tanc] if anchor is not None
                                        else []), *net.parameters()])
    return (grads if anchor is not None
            else (grads[0], None, *grads[1:]))


@pytest.mark.parametrize("grid", ["shared", "per_sample"])
def test_adjoint_matches_jax_at_the_defaults(grid):
    """Same step sequences: the adjoint's composition (the augmented
    state, its error norm over every parameter and the anchor, the t_bar
    terms) matches JAX's to 1e-4."""
    y0, anchor, ts = _grid(grid, 5, seed=4)
    cot = np.random.default_rng(5).normal(size=(5, 5, 3)).astype(np.float32)
    g_w, g_y, g_a = _jax_grads(_jax_poly, jnp.asarray(W3), y0, anchor, ts,
                               cot, DEFAULT, grid == "per_sample")
    got = _torch_grads(_Poly(), y0, anchor, ts, cot, DEFAULT)
    for g, ref, name in zip(got, (g_y, g_a, g_w), ("y0", "anchor", "w")):
        _rel(g, ref, 1e-4, name)


@pytest.mark.parametrize("kind,grid,n", [("simple_start", "shared", 6),
                                         ("simple_start", "per_sample", 3),
                                         ("simple", "shared", 6)])
def test_adjoint_of_the_nets_matches_jax(kind, grid, n):
    """Gradients of the tanh nets' parameters, y0 and (simple_start) the
    anchor against jax.grad through the JAX adjoint, at rtol 1e-5 / atol
    1e-7.
    (The small `ode` net has a test of its own at 1e-7 / 1e-9: at these
    tolerances its kinks leave both gradients too far from converged to
    compare two solves.)"""
    dstate, field, tfield = _pair(kind, "adaptive", MID, seed=6)
    y0, anchor, ts = _grid(grid, n, seed=7)
    cot = np.random.default_rng(8).normal(size=(5, n, 3)).astype(np.float32)
    sa = kind == "simple_start"

    def f_of(p, a):
        if sa:
            return lambda t, y, aa=None: field.apply(
                p, t, y, a if aa is None else aa)
        return lambda t, y: field.apply(p, t, y)
    g_p, g_y, g_a = _jax_grads(f_of, dstate.params, y0, anchor, ts, cot, MID,
                               grid == "per_sample")
    got = _torch_grads(tfield.net, y0, anchor if sa else None, ts, cot, MID)
    _rel(got[0], g_y, 2e-3, "y0")
    if sa:
        _rel(got[1], g_a, 2e-3, "anchor")
    ref = F.params_from_flax(_flat(g_p), tfield.net)
    for (name, _), g in zip(tfield.net.named_parameters(), got[2:]):
        _rel(g, ref[name], 2e-3, name)


def test_adjoint_of_the_ode_net_matches_jax():
    """Gradients of the ReLU `ode` net's parameters and y0 against
    jax.grad through the JAX adjoint at rtol 1e-7 / atol 1e-9, one sample
    on a shared grid with a duplicate: within 1e-2 of the largest entry."""
    dstate, field, tfield = _pair("ode", "adaptive", TIGHT, seed=6)
    y0 = _grid("shared", 1, seed=7)[0]
    ts = np.array([0.1, 0.25, 0.25, 0.4, 0.5], np.float32)
    cot = np.random.default_rng(8).normal(size=(5, 1, 3)).astype(np.float32)
    g_p, g_y, _ = _jax_grads(
        lambda p, a: (lambda t, y: field.apply(p, t, y)), dstate.params, y0,
        y0, ts, cot, TIGHT, False)
    got = _torch_grads(tfield.net, y0, None, ts, cot, TIGHT)
    _rel(got[0], g_y, 1e-2, "y0")
    ref = F.params_from_flax(_flat(g_p), tfield.net)
    for (name, _), g in zip(tfield.net.named_parameters(), got[2:]):
        _rel(g, ref[name], 1e-2, name)


def test_solve_counts_add_up():
    """Each solve: 2 evaluations to start, 6 per iteration; one read to
    start and one per iteration (a (N, T) tensor adds its own read)."""
    net = _Poly()
    y0, anchor, ts = _grid("per_sample", 4, seed=9)
    tracing.drain()
    ys = O.odeint_adaptive(net, torch.from_numpy(y0), torch.from_numpy(ts),
                           anchor=torch.from_numpy(anchor))
    c = O.solve_counts("forward")
    assert c.solves == 1 and c.evals == 2 + 6 * c.iterations
    assert c.reads == 1 + c.iterations
    assert c.accepted + c.rejected >= c.iterations > 0
    ys.sum().backward()
    b = O.solve_counts("backward")
    assert b.solves == 4 and b.reads == b.solves + b.iterations
    assert b.evals == 4 + 2 * b.solves + 6 * b.iterations
