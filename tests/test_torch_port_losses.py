"""The port's losses against `d3gs_tpu/ops/losses.py` on two image pairs
(one square, one not). Tolerances: values atol 1e-6; input gradients 1e-5
of their largest entry (f32 matmul blur in both, summed in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.ops import losses as JL
from d3gs_tpu_torch.ops import losses as TL


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


PAIRS = [(32, 32, 0), (24, 40, 1)]


@pytest.mark.parametrize("h,w,seed", PAIRS)
@pytest.mark.parametrize("name", ["l1_loss", "mse", "psnr", "ssim"])
def test_scalar_loss_value_and_grad(name, h, w, seed):
    a, b = _pair(h, w, seed)
    jv, jg = jax.value_and_grad(getattr(JL, name))(jnp.asarray(a),
                                                    jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tv = getattr(TL, name)(ta, torch.from_numpy(b))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), atol=1e-6,
                               rtol=1e-6 if name == "psnr" else 0)
    jg = np.asarray(jg)
    scale = np.abs(jg).max()
    assert scale > 0
    np.testing.assert_allclose(ta.grad.numpy() / scale, jg / scale,
                               atol=1e-5)


@pytest.mark.parametrize("h,w,seed", PAIRS)
def test_ssim_map(h, w, seed):
    a, b = _pair(h, w, seed)
    ref = np.asarray(JL.ssim_map(jnp.asarray(a), jnp.asarray(b)))
    got = TL.ssim_map(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_psnr_floor_and_identical_images():
    a, _ = _pair(16, 16, 2)
    t = torch.from_numpy(a)
    assert float(TL.psnr(t, t)) == pytest.approx(
        float(JL.psnr(jnp.asarray(a), jnp.asarray(a))))
    assert float(TL.ssim(t, t)) == pytest.approx(1.0, abs=1e-6)
