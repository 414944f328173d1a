"""The port's blend backward (BlendFunction on the CPU, which runs the plain
`blend_backward_torch`) against jax.grad through the Pallas blend in
interpret mode, on the scenes of tests/test_pallas_blend.py. Both consume
the same JAX records and bins.

The loss is test_pallas_blend.py:81-86's: sum (image - 0.5)² + 0.01 sum
depth + 0.02 sum alpha, with the bg gradient. Tolerances, relative to the
largest record gradient, are that file's own: 2e-4 on the random scene,
5e-4 on the saturated and budget scenes (test_pallas_blend.py:90-92,
138-140). The plain backward must also equal autograd through the plain
forward within 1e-5 of the largest gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.ops.binning import bin_splats_records
from d3gs_tpu.ops.pallas_blend import blend_records_pallas
from d3gs_tpu.ops.rasterize import pack_records
from d3gs_tpu_torch.ops import blend as B
from tests.torch_port_fixtures import BLEND_CASES, H, TX, TY, W, bins_to_torch

GRID = dict(tiles_x=TX, tiles_y=TY, width=W, height=H)
TOL = {"random": 2e-4, "saturated": 5e-4, "overflow48": 5e-4,
       "random_budget512": 5e-4}
TARGET = np.full((H, W, 3), 0.5, np.float32)


def _loss(img, dep, alp, depth=True):
    tgt = torch.from_numpy(TARGET) if isinstance(img, torch.Tensor) \
        else TARGET
    loss = ((img - tgt) ** 2).sum() + 0.02 * alp.sum()
    return loss + 0.01 * dep.sum() if depth else loss


def _jax_grads(records, bins, bg, depth_grad):
    def f(r, b):
        img, dep, alp = blend_records_pallas(r, bins, b, interpret=True,
                                             depth_grad=depth_grad, **GRID)
        return _loss(img, dep, alp, depth_grad)
    g, gb = jax.grad(f, argnums=(0, 1))(records, jnp.asarray(bg))
    return np.asarray(g), np.asarray(gb)


def _torch_grads(records, tbins, bg, depth_grad):
    r = torch.tensor(np.asarray(records), requires_grad=True)
    b = torch.tensor(bg, requires_grad=True)
    img, dep, alp = B.blend_records(r, tbins, b, depth_grad=depth_grad,
                                    **GRID)
    _loss(img, dep, alp, depth_grad).backward()
    return r.grad.numpy(), b.grad.numpy()


def _compare(got, ref, tol):
    assert np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol)


@pytest.mark.parametrize("case", BLEND_CASES, ids=lambda c: c[0])
def test_blend_backward_matches_pallas(case):
    name, make, dup, bg = case
    splats = make()
    bins = bin_splats_records(splats, tiles_x=TX, tiles_y=TY,
                              dup_capacity=dup)
    records = pack_records(splats)
    bg = np.asarray(bg, np.float32)
    g_ref, gb_ref = _jax_grads(records, bins, bg, True)
    tbins = bins_to_torch(bins)
    g, gb = _torch_grads(records, tbins, bg, True)
    _compare(g, g_ref, TOL[name])
    np.testing.assert_allclose(gb, gb_ref, atol=1e-3)
    assert (g[:, 10:] == 0).all()

    # the plain backward is the derivative of the plain forward
    r = torch.tensor(np.asarray(records), requires_grad=True)
    b = torch.tensor(bg, requires_grad=True)
    out = B.blend_forward_torch(r, tbins, b, **GRID)
    _loss(out.image, out.depth, out.alpha).backward()
    _compare(g, r.grad.numpy(), 1e-5)
    np.testing.assert_allclose(gb, b.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_blend_backward_without_depth_matches_pallas():
    """depth_grad=False: the depth channel gets no gradient and the loss
    uses no depth, in both packages."""
    _, make, dup, bg = BLEND_CASES[0]
    splats = make()
    bins = bin_splats_records(splats, tiles_x=TX, tiles_y=TY)
    records = pack_records(splats)
    bg = np.asarray(bg, np.float32)
    g_ref, _ = _jax_grads(records, bins, bg, False)
    g, _ = _torch_grads(records, bins_to_torch(bins), bg, False)
    _compare(g, g_ref, TOL["random"])
    assert (g[:, 9] == 0).all() and (g_ref[:, 9] == 0).all()


def test_last_contrib_marks_the_last_included_record():
    """On the saturated tile the pixels under the stack stop early, and the
    last included record is the one before the failing one."""
    _, make, _, _ = BLEND_CASES[1]
    splats = make()
    bins = bins_to_torch(bin_splats_records(splats, tiles_x=TX, tiles_y=TY))
    out = B.blend_forward(torch.from_numpy(np.asarray(pack_records(splats))),
                          bins, torch.zeros(3), **GRID)
    last, walked = out.last_contrib.numpy(), out.n_walked.numpy()
    assert (last <= walked).all()
    t = int(bins.counts.argmax())
    ys = slice(16 * (t // TX), 16 * (t // TX) + 16)
    xs = slice(16 * (t % TX), 16 * (t % TX) + 16)
    stopped = walked[ys, xs] < int(bins.counts[t])
    assert stopped.any()
    # every pixel of the stack's tile that stopped early included the
    # record just before the one that failed it
    assert (last[ys, xs][stopped] == walked[ys, xs][stopped] - 1).all()


def test_blend_backward_rejects_other_devices():
    rec = torch.zeros((4, 16), device="meta")
    bins = B.RecordBins(*(torch.zeros(k, dtype=torch.int32)
                          for k in (0, 17, 16, 4, 5)))
    z = torch.zeros((H, W))
    fwd = B.BlendOutput(None, None, None, z, z, None, z.int())
    with pytest.raises(ValueError, match="unsupported device"):
        B.blend_backward(rec, bins, torch.zeros(3), fwd,
                         torch.zeros((H, W, 3)), z, z, **GRID)
