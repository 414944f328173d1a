"""The pieces the blend kernels' per-warp design adds in Python:
`sorted_gids` (the duplicates' Gaussian ids both kernels read) and
`warp_rows_hit`, the plain version of the per-warp cull of
`csrc/blend_common.cuh::rows_hit`.

The cull must be conservative: a record it rules out for a 16x2 pixel strip
has alpha < 1/255 at every pixel of the strip, evaluated as the kernels and
the Pallas kernel evaluate it in f32 (power = -0.5(a dx² + c dy²) - b dx dy,
alpha = opa·e^power). That is checked exactly, pixel by pixel, on seeded
numpy records with anisotropic conics (condition numbers up to ~1e4),
opacities within 1e-6..2 % above 1/255, and extreme points placed on strip
edges (`chip_smoke.cull_edge_records`, which chip_smoke.py also runs through
the CUDA cull on the card), and on the JAX-projected records of the blend
test scenes. It must also cull: most records of a random scene miss most
strips. Also: the kernels' input check refuses records that are not
16-byte aligned."""
import numpy as np
import pytest
import torch

from chip_smoke import cull_edge_records
from d3gs_tpu.ops.binning import bin_splats_records
from d3gs_tpu.ops.rasterize import pack_records
from d3gs_tpu_torch.ops import blend as B
from tests.torch_port_fixtures import (BLEND_CASES, TX, TY,  # noqa: F401
                                       bins_to_torch, one_torch_thread)

ALPHA_MIN = np.float32(1.0 / 255.0)
PX = np.arange(16, dtype=np.float32)


def _strip_alpha_max(rec, x0, y0):
    """Largest alpha >= 1/255 test value over the strip: (K, S) array of
    max over its 32 pixels of raw where power <= 0, in f32 as the kernels
    compute it (rec (K, >= 10), x0/y0 (S,))."""
    px = (x0[:, None] + PX[None, :]).astype(np.float32)          # (S, 16)
    out = np.zeros((rec.shape[0], x0.shape[0]), np.float32)
    for row in (0, 1):
        py = (y0 + np.float32(row)).astype(np.float32)[:, None]   # (S, 1)
        dx = rec[:, 0, None, None] - px[None]                     # (K, S, 16)
        dy = rec[:, 1, None, None] - py[None]
        a, b, c = (rec[:, i, None, None] for i in (2, 3, 4))
        power = (np.float32(-0.5) * (a * dx * dx + c * dy * dy)
                 - b * dx * dy)
        raw = rec[:, 8, None, None] * np.exp(power)
        raw = np.where(power > 0, np.float32(0), raw)
        out = np.maximum(out, raw.max(-1))
    return out


def _strips(size=64):
    ys, xs = np.meshgrid(np.arange(0, size, 2), np.arange(0, size, 16),
                         indexing="ij")
    return (xs.ravel().astype(np.float32), ys.ravel().astype(np.float32))


def _cull(rec, x0, y0):
    r = torch.from_numpy(rec)[:, None, :]
    return B.warp_rows_hit(r, torch.from_numpy(x0)[None],
                           torch.from_numpy(y0)[None]).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_rows_hit_never_drops_a_visible_strip(seed):
    rec = cull_edge_records(seed)
    x0, y0 = _strips()
    hit = _cull(rec, x0, y0)
    peak = _strip_alpha_max(rec, x0, y0)
    visible = peak >= ALPHA_MIN
    assert not (visible & ~hit).any(), (
        f"{int((visible & ~hit).sum())} (record, strip) pairs culled with "
        f"alpha up to {peak[visible & ~hit].max()} >= 1/255")
    # the edge placement makes some culled strips graze the threshold
    assert (peak[~hit] > 0.9 * ALPHA_MIN).any()
    # and the cull is tight: few kept pairs have no visible pixel
    assert (visible.sum() / hit.sum()) > 0.7
    assert hit.mean() < 0.5


@pytest.mark.parametrize("case", BLEND_CASES[:2], ids=lambda c: c[0])
def test_warp_rows_hit_on_projected_scene(case):
    """On the JAX-projected records of the blend test scenes, every record
    of a tile's list that the cull rules out for one of the tile's strips
    is below 1/255 at all 32 of its pixels, and a share of the list is
    ruled out."""
    _, make, dup, _ = case
    splats = make()
    bins = bins_to_torch(bin_splats_records(splats, tiles_x=TX, tiles_y=TY,
                                            dup_capacity=dup))
    rec = np.asarray(pack_records(splats))[:, :10]
    gid = B.sorted_gids(bins).numpy()
    starts = bins.starts.numpy()
    culled = kept = 0
    for t in range(TX * TY):
        r = rec[gid[starts[t]:starts[t + 1]]]
        if r.shape[0] == 0:
            continue
        x0 = np.full(8, 16 * (t % TX), np.float32)
        y0 = (16 * (t // TX) + 2 * np.arange(8)).astype(np.float32)
        hit = _cull(r, x0, y0)
        peak = _strip_alpha_max(r, x0, y0)
        assert not ((peak >= ALPHA_MIN) & ~hit).any()
        culled += int((~hit).sum())
        kept += int(hit.sum())
    assert culled > 0 and kept > 0


def test_warp_rows_hit_edge_cases():
    """Below 1/255 opacity: ruled out everywhere; not an ellipse (a <= 0 or
    det <= 0) or NaN: kept."""
    rec = np.zeros((5, 10), np.float32)
    rec[:, 0:2] = 8.0
    rec[:, 2:5] = [1.0, 0.0, 1.0]
    rec[:, 8] = 0.5
    rec[0, 8] = np.nextafter(ALPHA_MIN, np.float32(0))   # opacity < 1/255
    rec[1, 2] = -1.0                                     # a < 0
    rec[2, 3] = 2.0                                      # det < 0
    rec[3, 8] = np.nan
    rec[4, 0:2] = 500.0                                  # far away
    hit = _cull(rec, np.float32([0.0]), np.float32([0.0]))[:, 0]
    assert hit.tolist() == [False, True, True, True, False]


def test_sorted_gids_is_order_of_rank_sorted():
    rng = np.random.default_rng(4)
    n, m = 300, 1000
    order = torch.from_numpy(rng.permutation(n).astype(np.int32))
    rank = torch.from_numpy(rng.integers(0, n, m).astype(np.int32))
    i32 = torch.int32
    bins = B.RecordBins(rank_sorted=rank, starts=torch.zeros(2, dtype=i32),
                        counts=torch.zeros(1, dtype=i32), order=order,
                        rank_bounds=torch.zeros(n + 1, dtype=i32))
    gid = B.sorted_gids(bins)
    assert gid.dtype == torch.int32 and gid.shape == (m,)
    assert torch.equal(gid, order[rank.long()])


def _bins(n, m, seed=4):
    rng = np.random.default_rng(seed)
    i32 = torch.int32
    return B.RecordBins(
        rank_sorted=torch.from_numpy(rng.integers(0, n, m).astype(np.int32)),
        starts=torch.tensor([0, m], dtype=i32),
        counts=torch.tensor([m], dtype=i32),
        order=torch.from_numpy(rng.permutation(n).astype(np.int32)),
        rank_bounds=torch.zeros(n + 1, dtype=i32))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_blend_inputs_need_16_byte_aligned_records(offset):
    """The kernels read each record row as three 16-byte loads, so a
    contiguous view that starts off a 16-byte boundary is refused before
    any launch (on the card it would fault the context)."""
    n = 8
    base = torch.zeros(n * B.RECORD_WIDTH + 4, dtype=torch.float32)
    records = base[offset:offset + n * B.RECORD_WIDTH].view(n,
                                                            B.RECORD_WIDTH)
    assert records.is_contiguous()
    args = (records, _bins(n, 20), torch.zeros(3), 1, 1, 16, 16, None)
    if (records.data_ptr() % 16) == 0:
        gid = B._check_inputs(*args)
        assert gid.shape == (20,)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            B._check_inputs(*args)
