"""The port's Gaussian state functions against `d3gs_tpu/models/gaussians.py`
slot by slot: kNN scale init, create_from_pcd, learning rates, the masked
Adam, densification statistics, densify_and_prune (fed JAX's own split
noise), opacity reset, capacity growth and the SH ramp.

Tolerances: parameters and moments atol 1e-6 (elementwise f32 in both);
alive sets and slot assignments exactly; kNN distances rtol 1e-4 (the JAX
kNN expands |a-b|² = |a|² + |b|² - 2ab, which cancels; the port's cdist
does not)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.config import OptimizationParams
from d3gs_tpu.models import gaussians as JG
from d3gs_tpu.ops.knn import knn_mean_sq_dist as jax_knn
from d3gs_tpu_torch.models import gaussians as TG
from d3gs_tpu_torch.ops.knn import knn_mean_sq_dist

NAMES = TG.PARAM_NAMES


def to_torch(js: JG.GaussianState) -> TG.GaussianState:
    """The whole JAX state (params, statistics, moments) in the port."""
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    tp = lambda p: TG.GaussianParams(*(t(x) for x in p))  # noqa: E731
    return TG.GaussianState(
        params=tp(js.params), alive=t(js.alive),
        active_sh_degree=int(js.active_sh_degree),
        max_sh_degree=js.max_sh_degree, grad_accum=t(js.grad_accum),
        denom=t(js.denom), max_radii2d=t(js.max_radii2d),
        opt=TG.AdamState(tp(js.opt.m), tp(js.opt.v), int(js.opt.count)),
        spatial_lr_scale=js.spatial_lr_scale)


def assert_states_close(ts: TG.GaussianState, js: JG.GaussianState,
                        atol=1e-6):
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    assert ts.capacity == js.capacity
    assert ts.active_sh_degree == int(js.active_sh_degree)
    assert ts.opt.count == int(js.opt.count)
    for group, tg, jg in (("params", ts.params, js.params),
                          ("m", ts.opt.m, js.opt.m), ("v", ts.opt.v, js.opt.v)):
        for name, a, b in zip(NAMES, tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                       rtol=1e-6, err_msg=f"{group}.{name}")
    for name in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=atol,
                                   rtol=1e-6, err_msg=name)


def make_state(n=300, cap=512, seed=0, sh_degree=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    js = JG.create_from_pcd(pts, cols, sh_degree=sh_degree, capacity=cap,
                            spatial_lr_scale=2.5)
    p = js.params
    # a third of the rows small enough to clone instead of split
    small = (np.arange(cap) % 3 == 0)[:, None] * np.float32(-3.0)
    js = js.replace(params=p._replace(
        scaling=p.scaling + small + jnp.asarray(
            rng.normal(0, 0.5, p.scaling.shape), jnp.float32),
        rotation=jnp.asarray(rng.normal(size=p.rotation.shape) + [2, 0, 0, 0],
                             jnp.float32),
        opacity=jnp.asarray(rng.uniform(-6, 3, p.opacity.shape), jnp.float32),
        features_rest=jnp.asarray(rng.normal(0, 0.1, p.features_rest.shape),
                                  jnp.float32)))
    return js, rng


def random_grads(js, rng, scale=1e-3):
    return JG.GaussianParams(*(jnp.asarray(rng.normal(0, scale, x.shape),
                                           jnp.float32) for x in js.params))


def test_knn_mean_sq_dist():
    pts = np.random.default_rng(1).uniform(-1.3, 1.3, (700, 3)).astype(
        np.float32)
    ref = np.asarray(jax_knn(jnp.asarray(pts)))
    for chunk in (0, 256):
        got = knn_mean_sq_dist(torch.from_numpy(pts), chunk=chunk).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_create_from_pcd():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    cols = rng.random((1500, 3)).astype(np.float32)
    kw = dict(sh_degree=2, spatial_lr_scale=3.0, max_gaussians=1200, seed=4)
    js = JG.create_from_pcd(pts, cols, **kw)
    ts = TG.create_from_pcd(pts, cols, device="cpu", **kw)
    assert ts.capacity == js.capacity == 2048
    assert ts.spatial_lr_scale == 3.0 and ts.max_sh_degree == 2
    assert ts.active_sh_degree == 0
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    for name, a, b in zip(NAMES, ts.params, js.params):
        # log sqrt of the kNN distance: rtol 1e-4 on d² is 5e-5 on log d
        atol = 1e-4 if name == "scaling" else 0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("step", [0, 1, 500, 30_000])
def test_group_learning_rates(step):
    cfg = OptimizationParams()
    ref = JG.group_learning_rates(cfg, step, 2.5)
    got = TG.group_learning_rates(cfg, step, 2.5)
    for name, a, b in zip(NAMES, got, ref):
        assert isinstance(a, float)
        assert a == pytest.approx(float(b), rel=1e-6), name


def test_adam_steps_masked():
    js, rng = make_state()
    ts = to_torch(js)
    cfg = OptimizationParams()
    for it in range(1, 4):
        g = random_grads(js, rng)
        lrs = JG.group_learning_rates(cfg, it, js.spatial_lr_scale)
        p, opt = JG.adam_step(js.params, g, js.opt, lrs, mask=js.alive)
        js = js.replace(params=p, opt=opt)
        tp, topt = TG.adam_step(
            ts.params, TG.GaussianParams(*(torch.from_numpy(np.array(x))
                                           for x in g)),
            ts.opt, TG.group_learning_rates(cfg, it, ts.spatial_lr_scale),
            mask=ts.alive)
        ts = dataclasses.replace(ts, params=tp, opt=topt)
    assert_states_close(ts, js)
    # dead rows never moved
    dead = ~ts.alive.numpy()
    assert (ts.opt.m.xyz.numpy()[dead] == 0).all()


def test_add_densification_stats():
    js, rng = make_state()
    ts = to_torch(js)
    for _ in range(2):
        tap = rng.normal(0, 1e-3, (js.capacity, 2)).astype(np.float32)
        radii = rng.integers(-2, 9, js.capacity).astype(np.int32)
        js = JG.add_densification_stats(js, jnp.asarray(tap),
                                        jnp.asarray(radii))
        ts = TG.add_densification_stats(ts, torch.from_numpy(tap),
                                        torch.from_numpy(radii))
    assert_states_close(ts, js)


@pytest.mark.parametrize("max_screen_size,n,cap", [
    (0.0, 300, 512),      # room for every child
    (20.0, 300, 512),     # screen-size and world-size pruning on
    (0.0, 450, 512),      # free slots run out: children are dropped
])
def test_densify_and_prune(max_screen_size, n, cap):
    js, rng = make_state(n=n, cap=cap, seed=n)
    # statistics and moments so that the surgery has rows to move and zero
    g = random_grads(js, rng)
    p, opt = JG.adam_step(js.params, g, js.opt,
                          JG.group_learning_rates(OptimizationParams(), 1,
                                                  1.0), mask=js.alive)
    js = js.replace(params=p, opt=opt,
                    grad_accum=jnp.asarray(rng.uniform(0, 2e-3, cap),
                                           jnp.float32),
                    denom=jnp.asarray(rng.integers(0, 3, cap), jnp.float32),
                    max_radii2d=jnp.asarray(rng.uniform(0, 40, cap),
                                            jnp.float32))
    ts = to_torch(js)
    key = jax.random.PRNGKey(7)
    # the noise JAX draws inside densify_and_prune (gaussians.py:354-355)
    noise = np.asarray(jax.random.normal(jax.random.split(key)[1],
                                         (2, cap, 3)))
    kw = dict(max_grad=0.0007, min_opacity=0.005, extent=2.0,
              max_screen_size=max_screen_size, percent_dense=0.01)
    js2 = JG.densify_and_prune(js, key, **kw)
    ts2 = TG.densify_and_prune(ts, noise=torch.from_numpy(noise), **kw)
    assert_states_close(ts2, js2)
    grown = int(js2.alive.sum()) - int(js.alive.sum())
    assert grown != 0


def test_reset_opacity_grow_capacity_oneup():
    js, rng = make_state()
    js = js.replace(opt=js.opt._replace(m=random_grads(js, rng),
                                        v=random_grads(js, rng)))
    ts = to_torch(js)
    assert_states_close(TG.reset_opacity(ts), JG.reset_opacity(js))
    assert_states_close(TG.grow_capacity(ts, 1024),
                        JG.grow_capacity(js, 1024))
    assert TG.grow_capacity(ts, ts.capacity) is ts
    up = TG.oneup_sh_degree(TG.oneup_sh_degree(ts))
    assert up.active_sh_degree == int(JG.oneup_sh_degree(
        JG.oneup_sh_degree(js)).active_sh_degree) == 1
