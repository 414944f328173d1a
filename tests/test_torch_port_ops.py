"""The port's math ops against the JAX package on the same numpy inputs:
SH evaluation, quaternion → rotation, EWA projection and record packing,
their gradients against jax.vjp, and the `--configs` overlay.

Tolerances: f32 elementwise chains at rtol 1e-5 / atol 1e-5 (the two
frameworks round transcendental and fused operations differently by an ulp
or two); gradients within 1e-5 of their largest entry. Integer tile bounds
come from ceil/floor of those floats, so a row may land one tile over where
a value sits on a boundary: equal in ≥ 99.9% of rows and off by at most 1
elsewhere."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.ops import projection as PJ
from d3gs_tpu.ops import sh as SH
from d3gs_tpu.ops import transforms as TR
from d3gs_tpu.ops.rasterize import pack_records
from d3gs_tpu_torch.ops import projection as tPJ
from d3gs_tpu_torch.ops import sh as tSH
from d3gs_tpu_torch.ops import transforms as tTR
from d3gs_tpu_torch.ops.rasterize import pack_records as tpack
from tests.torch_port_fixtures import camera_mats, splats_to_torch

T = torch.from_numpy


def _dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("active", [0, 1, 2, 3])
def test_eval_sh_upto(active):
    rng = np.random.default_rng(active)
    dirs = _dirs(rng, 257)
    sh = rng.normal(size=(257, 16, 3)).astype(np.float32)
    ref = SH.eval_sh_upto(3, jnp.asarray(active), jnp.asarray(sh),
                          jnp.asarray(dirs))
    got = tSH.eval_sh_upto(3, active, T(sh), T(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_quat_to_rotmat_cols():
    """Entries are differences of O(1) products: atol 2 ulp of 1.0."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1000, 4)).astype(np.float32)
    for a, b in zip(tTR.quat_to_rotmat_cols(T(q)),
                    TR.quat_to_rotmat_cols(jnp.asarray(q))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2.4e-7)


def _scene(seed, n=4000):
    rng = np.random.default_rng(seed)
    means = (rng.random((n, 3)) * 2.6 - 1.3).astype(np.float32)
    scales = np.exp(rng.uniform(-5, -1.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.001, 0.999, n).astype(np.float32)
    colors = rng.random((n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.95
    return means, scales, quats, opac, colors, alive


@pytest.mark.parametrize("seed,size", [(0, 64), (1, 400), (2, 120)])
def test_project_gaussians(seed, size):
    means, scales, quats, opac, colors, alive = _scene(seed)
    V, VP = camera_mats(4.0)
    tan = math.tan(math.radians(60) / 2)
    ref = PJ.project_gaussians(
        jnp.asarray(means), None, jnp.asarray(opac), jnp.asarray(colors),
        jnp.asarray(V), jnp.asarray(VP), tan, tan, size, size,
        alive=jnp.asarray(alive), scales=jnp.asarray(scales),
        rotations=jnp.asarray(quats))
    got = tPJ.project_gaussians(
        T(means), T(scales), T(quats), T(opac), T(colors), T(V), T(VP),
        tan, tan, size, size, alive=T(alive))
    for name in ("means2d", "depths", "conics", "colors", "opacities",
                 "cull_radius"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("tile_min", "tile_max", "radii", "visible"):
        a = getattr(got, name).numpy().astype(np.int64)
        b = np.asarray(getattr(ref, name)).astype(np.int64)
        assert a.dtype == b.dtype and a.shape == b.shape
        rows_equal = (a == b).reshape(len(a), -1).all(axis=1)
        assert rows_equal.mean() >= 0.999, name
        assert np.abs(a - b).max() <= 1, name
    assert got.radii.dtype == torch.int32
    assert got.tile_min.dtype == torch.int32


def test_pack_records():
    means, scales, quats, opac, colors, alive = _scene(3, n=300)
    V, VP = camera_mats(4.0)
    tan = math.tan(math.radians(60) / 2)
    ref = PJ.project_gaussians(
        jnp.asarray(means), None, jnp.asarray(opac), jnp.asarray(colors),
        jnp.asarray(V), jnp.asarray(VP), tan, tan, 64, 64,
        alive=jnp.asarray(alive), scales=jnp.asarray(scales),
        rotations=jnp.asarray(quats))
    got = tpack(splats_to_torch(ref))
    assert got.shape == (300, 16) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(pack_records(ref)))


def test_inverse_sigmoid_and_sh_dc():
    x = np.linspace(0.01, 0.99, 50, dtype=np.float32)
    np.testing.assert_allclose(tTR.inverse_sigmoid(T(x)).numpy(),
                               np.asarray(TR.inverse_sigmoid(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tSH.sh2rgb(tSH.rgb2sh(x)), x, atol=1e-6)
    assert tSH.rgb2sh(0.75) == pytest.approx(float(SH.rgb2sh(0.75)))


def _vjp_compare(jax_fn, torch_fn, inputs, cot, tol=1e-5):
    """Gradients of <fn(inputs), cot> in both packages, each input's within
    `tol` of its largest entry."""
    import jax
    out, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in inputs))
    ref = vjp(jnp.asarray(cot))
    ts = [T(x).requires_grad_() for x in inputs]
    got = torch.autograd.grad(torch_fn(*ts), ts, T(cot))
    for i, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0 and np.isfinite(a.numpy()).all(), i
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=tol,
                                   err_msg=f"input {i}")


@pytest.mark.parametrize("seed,size", [(4, 64), (5, 120)])
def test_project_gaussians_gradients(seed, size):
    """d(packed records) / d(means, scales, quats, opacity, colors), the
    projection's part of the train step's backward, against jax.vjp."""
    means, scales, quats, opac, colors, alive = _scene(seed, n=1500)
    V, VP = camera_mats(4.0)
    tan = math.tan(math.radians(60) / 2)

    def jax_fn(m, s, q, o, c):
        return pack_records(PJ.project_gaussians(
            m, None, o, c, jnp.asarray(V), jnp.asarray(VP), tan, tan, size,
            size, alive=jnp.asarray(alive), scales=s, rotations=q))

    def torch_fn(m, s, q, o, c):
        return tpack(tPJ.project_gaussians(m, s, q, o, c, T(V), T(VP), tan,
                                           tan, size, size, alive=T(alive)))
    cot = np.random.default_rng(seed).normal(size=(1500, 16)).astype(
        np.float32)
    cot[:, 10:] = 0
    _vjp_compare(jax_fn, torch_fn, (means, scales, quats, opac, colors), cot)


def test_eval_sh_gradients():
    rng = np.random.default_rng(9)
    dirs = _dirs(rng, 300)
    sh = rng.normal(size=(300, 16, 3)).astype(np.float32)
    cot = rng.normal(size=(300, 3)).astype(np.float32)
    _vjp_compare(lambda s, d: SH.eval_sh_upto(3, jnp.asarray(2), s, d),
                 lambda s, d: tSH.eval_sh_upto(3, 2, s, d), (sh, dirs), cot)


def test_config_overlay_matches_jax():
    """`--configs` presets land on the same fields in both packages."""
    import dataclasses
    import os
    from d3gs_tpu import config as JC
    from d3gs_tpu_torch import config as TC
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs")
    for preset in ("baseline.py", "ode_batch10.py"):
        j = {"model": JC.ModelParams(), "optimization":
             JC.OptimizationParams()}
        t = {"model": TC.ModelParams(), "optimization":
             TC.OptimizationParams()}
        JC.apply_config_file(os.path.join(root, preset), j)
        TC.apply_config_file(os.path.join(root, preset), t)
        for k in j:
            assert dataclasses.asdict(t[k]) == dataclasses.asdict(j[k])
    assert t["model"].is_ode and t["optimization"].num_cams_per_iter == 60
