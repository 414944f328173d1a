"""The port's plain tile blend against the JAX Pallas blend (interpret mode)
on the three tests/test_pallas_blend.py scenes. Both consume the same JAX
records and bins, so this isolates the blend. Tolerance: atol 5e-5 /
rtol 1e-4, the Pallas test's own (test_pallas_blend.py:72-73): the two
accumulate the depth recurrence in different orders (MXU prefix scan vs a
sequential cumsum)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3gs_tpu.ops.binning import bin_splats_records
from d3gs_tpu.ops.pallas_blend import blend_records_pallas
from d3gs_tpu.ops.rasterize import pack_records
from d3gs_tpu_torch.ops import blend as B
from d3gs_tpu_torch.ops.binning import bin_splats_records as bin_torch
from d3gs_tpu_torch.ops.rasterize import pack_records as pack_torch
from tests.torch_port_fixtures import (BLEND_CASES, H, TX, TY, W,
                                       bins_to_torch, splats_to_torch)

GRID = dict(tiles_x=TX, tiles_y=TY, width=W, height=H)


@pytest.fixture(scope="module", params=BLEND_CASES, ids=lambda c: c[0])
def case(request):
    _, make, dup, bg = request.param
    splats = make()
    bins = bin_splats_records(splats, tiles_x=TX, tiles_y=TY,
                              dup_capacity=dup)
    records = pack_records(splats)
    bg = np.asarray(bg, np.float32)
    ref = blend_records_pallas(records, bins, jnp.asarray(bg),
                               interpret=True, **GRID)
    return splats, bins, records, bg, [np.asarray(x) for x in ref]


def test_blend_torch_matches_pallas(case):
    _, bins, records, bg, ref = case
    out = B.blend_records(torch.from_numpy(np.array(records)),
                          bins_to_torch(bins), torch.from_numpy(bg), **GRID)
    for name, a, b in zip(("image", "depth", "alpha"), out, ref):
        np.testing.assert_allclose(a.numpy(), b, atol=5e-5, rtol=1e-4,
                                   err_msg=name)


def test_binned_and_packed_in_port_matches_pallas(case):
    """The port's binning + packing + blend, fed the same splats."""
    splats, bins, _, bg, ref = case
    ts = splats_to_torch(splats)
    tb = bin_torch(ts, tiles_x=TX, tiles_y=TY,
                   dup_capacity=int(bins.rank_sorted.shape[0]))
    out = B.blend_forward(pack_torch(ts), tb, torch.from_numpy(bg), **GRID)
    for a, b in zip(out[:3], ref):
        np.testing.assert_allclose(a.numpy(), b, atol=5e-5, rtol=1e-4)
    # backward anchors: T_final = exp(log T), alpha = 1 - T_final, and no
    # pixel walks more records than its tile holds
    np.testing.assert_allclose(out.t_final.numpy(),
                               np.exp(out.log_t.numpy()), rtol=1e-6)
    np.testing.assert_allclose(out.alpha.numpy(), 1 - out.t_final.numpy(),
                               atol=1e-7)
    per_tile = tb.counts.numpy().reshape(TY, TX).repeat(16, 0).repeat(16, 1)
    walked = out.n_walked.numpy()
    assert ((walked >= 0) & (walked <= per_tile[:H, :W])).all()


def test_saturated_tile_stops_early():
    """On the fullest saturated tile the pixels under the stack stop before
    the end of the list, at the first record that would drop T below 1e-4,
    and T_final never falls below it."""
    _, make, _, _ = BLEND_CASES[1]
    ts = splats_to_torch(make())
    tb = bin_torch(ts, tiles_x=TX, tiles_y=TY)
    out = B.blend_forward(pack_torch(ts), tb, torch.zeros(3), **GRID)
    t = int(tb.counts.argmax())
    ys, xs = slice(16 * (t // TX), 16 * (t // TX) + 16), \
        slice(16 * (t % TX), 16 * (t % TX) + 16)
    walked = out.n_walked.numpy()[ys, xs]
    assert int(tb.counts[t]) >= 40
    assert 0 < walked.min() < int(tb.counts[t])
    assert (out.t_final.numpy()[ys, xs] >= 1e-4).all()


def test_blend_rejects_other_devices():
    """The wrapper picks the plain version only for CPU tensors."""
    rec = torch.zeros((4, 16), device="meta")
    bins = B.RecordBins(*(torch.zeros(k, dtype=torch.int32)
                          for k in (0, 17, 16, 4, 5)))
    with pytest.raises(ValueError, match="unsupported device"):
        B.blend_forward(rec, bins, torch.zeros(3), **GRID)
