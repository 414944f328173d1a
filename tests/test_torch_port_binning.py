"""The port's record binning against `d3gs_tpu.ops.binning.bin_splats_records`,
both fed the same JAX ProjectedSplats. Integer outputs must be equal:
`starts`, `counts`, `rank_bounds`, and each tile's Gaussian-id sequence
order[rank_sorted] (the depth ranks themselves may differ only where depths
tie, and the scenes have distinct depths: JAX's sort is not stable)."""
import numpy as np
import pytest

from d3gs_tpu.ops.binning import bin_splats_records
from d3gs_tpu_torch.ops.binning import bin_splats_records as bin_torch
from tests.torch_port_fixtures import (BLEND_CASES, TX, TY, splats_to_torch,
                                       to_numpy)


@pytest.mark.parametrize("case", BLEND_CASES, ids=lambda c: c[0])
def test_bins_match_jax(case):
    name, make, dup, _ = case
    splats = make()
    ref = to_numpy(bin_splats_records(splats, tiles_x=TX, tiles_y=TY,
                                      dup_capacity=dup))
    got = {k: v.numpy() for k, v in bin_torch(
        splats_to_torch(splats), tiles_x=TX, tiles_y=TY,
        dup_capacity=dup)._asdict().items()}
    for k in ("starts", "counts", "rank_bounds"):
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    total = int(ref["starts"][-1])
    assert got["rank_sorted"].shape == (total,)
    np.testing.assert_array_equal(got["order"][got["rank_sorted"]],
                                  ref["order"][ref["rank_sorted"][:total]])
    full = bin_torch(splats_to_torch(splats), tiles_x=TX, tiles_y=TY)
    if name == "random_budget512":
        # the budget dropped duplicates, the deepest Gaussians' first
        assert int(full.starts[-1]) > total == 512
        kept = np.unique(got["order"][got["rank_sorted"]])
        n_kept = len(kept)
        assert set(kept) >= set(full.order.numpy()[:n_kept - 1])
        assert not set(kept) & set(full.order.numpy()[n_kept:])
    else:
        assert int(full.starts[-1]) == total
