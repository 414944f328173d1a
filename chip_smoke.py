"""On-card smoke test of the PyTorch/CUDA port (`d3gs_tpu_torch`).

    python3 chip_smoke.py          # one CUDA card; builds into build/

Phases (any failure exits non-zero):
  1. device: card name and power limit, the TF32 flags (both must be off);
  2. build: every CUDA kernel of the port and the blend checks, compiled
     from csrc/ with nvcc (its release printed), one process per source,
     all started together, with ptxas's report
     (registers, shared memory, spills); the loops of both blend kernels
     read from `cuobjdump -sass` (instructions, SFU, shuffles, atomics);
  3. each kernel against its plain PyTorch version on the card: first two
     checks of csrc/blend_checks.cu, the blend kernels' per-warp cull
     against their own alpha on 12,000 records whose ellipses end within
     1e-3 px of strip and tile edges, and the forward's log1p against the
     library's log1pf on every f32 alpha in (0, 0.99]; then the blend
     kernels on the bench scene
     (bench.py's recipe: 43,132 Gaussians, 400x400, SH degree 3, the 8x256 Blender deform MLP
     at t=0.5), the small blend scenes of tests/test_pallas_blend.py and
     two scenes at the per-warp design's edges (`deep`: 3,000 stacked
     Gaussians of opacity 0.01, pixels that include ~900 records;
     `warp_edge`: ellipses that end just inside or outside a 16x2 strip or
     a tile column), the forward at atol 5e-5 / rtol 1e-4, the backward
     (with and without the depth term) relative to its largest gradient at
     that file's tolerances; (3c) the row kernels at the shapes of the
     tools that run them, the copy and the gather bit-equal, the
     scatter-add within 1e-5 of the largest |sum|;
  4. the main paths, each with the kernels' counts set to 0 just before it
     and read just after:
     4.  render: a D-NeRF-format dataset and a model directory at the bench
         scale, rendered through `d3gs_tpu_torch.render.main([... "--mode",
         "render", "--benchmark"])`;
     4b. train: `d3gs_tpu_torch.train.__main__.main` on that dataset with
         bench.py's point cloud, 20 iterations through warm-up, deform
         steps, densification, a PSNR evaluation and a checkpoint, which
         `render.main` then renders;
     4c. the three tools (`d3gs_tpu_torch.tools.exp_r5_reduce`,
         `exp_vmem_gather`, `exp_vmem_scatter`) through their main();
     4d. flagship: the train CLI with `--trainer flagship --is_ode` (the
         8x256 ODE field, k = 10 cameras) on a 12-view set with bench.py's
         point cloud, 10 iterations through warm-up, the alternating
         switch, a densify pass, an evaluation and a checkpoint, rendered
         through `render.main` and held against the plain blend;
  5. timings at the bench shape (CUDA events, torch.profiler): the render
     stages and the frame, the train step and its layers, both blend
     kernels alone (CUDA events and profiler device time) on the bench
     scene and on the train step's own scene, through their wrappers and
     in their plain versions; the row kernels alone beside their library
     calls and plain versions; one ODE flagship step at k = 10 and its
     layers, one MLP-kind flagship step;
  6. the card, the blend bounds (from the pixel-record pairs each kernel
     evaluates on the bench scene, counted by `blend_work`, under this
     source's count and without the cull) and the issue-rate model (SASS
     instructions per visit times visits over 4 per clock on 132 SMs), one
     JSON line of the kernels (the blend kernels' launches from the
     flagship path, the row kernels' from their tools' paths; the row
     bounds from the bytes each must move), and the final status line.
It imports nothing of JAX or of the JAX package `d3gs_tpu`.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

WIDTH = HEIGHT = 400
N_BENCH = 43_132                 # bench.py: the reference's average count
ATOL, RTOL = 5e-5, 1e-4          # tests/test_pallas_blend.py:72-73
LAST_MISMATCH_SHARE = 1e-4       # pixels whose last included record may differ
ROW_SCATTER_TOL = 1e-5           # scatter-add vs plain, of the largest |sum|
# backward tolerance relative to the largest gradient
# (tests/test_pallas_blend.py:90-92, 138-140)
BWD_TOL = {"random": 2e-4, "random_budget512": 5e-4, "saturated": 5e-4,
           "overflow48": 5e-4, "bench": 2e-4,
           # the two scenes at the per-warp design's edges take the family
           # of their kind: a long saturating stack, a random scene
           "deep": 5e-4, "warp_edge": 2e-4}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores
# transcendentals (exp, log): 16 SFU results / clock / SM (CUDA C programming
# guide, arithmetic instruction throughput, compute capability 9.0), 132 SMs
# at the 1.98 GHz boost clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# Work per pixel-record pair, counted from the kernels' source. Every pair a
# kernel evaluates (a record its strip's cull keeps, before the pixel's
# n_walked or last_contrib) costs the Gaussian (dx, dy, the conic's
# quadratic, the opacity product: 12 f32 operations) and one exp. Only a
# pair whose alpha reaches 1/255 (an included one) goes on:
#   csrc/blend_fwd.cu: clamp, log T update, include test, w, 4
#     accumulations (11 ops), log1p (`log1p_neg`, the library log1pf's
#     normal path: an argument reduction and a polynomial, 15 f32
#     operations and no SFU instruction; its 5 integer and conversion
#     operations are not counted) and the exp of log T: 26 ops and one exp;
#   csrc/blend_bwd.cu (depth_grad=False): clamp, 1 - alpha, T_before, w,
#     g·rgb (5), g_alpha (4), the suffix (2), g_power, the 9 partials (17)
#     and their 9-way sum over pixels: 42 ops and one reciprocal.
# A backward in log space (T_before = exp(L - log1p(-alpha))) spends 46 ops,
# log1p and exp per included pair; the bound under that count, with every
# pair before n_walked / last_contrib (no cull), is printed beside the new
# one.
PAIR_FLOPS, PAIR_SFU = 12, 1
FWD_INC_FLOPS, FWD_INC_SFU = 26, 1
BWD_INC_FLOPS, BWD_INC_SFU = 42, 1
BWD_INC_LOG_T = (46, 2)
# the issue-rate model: 4 warp schedulers per SM, one instruction each per
# clock, at the 1.98 GHz boost clock
ISSUE_PER_S = 132 * 4 * 1.98e9
TRAIN_ITERATIONS = 20            # the training main path's steps
FLAGSHIP_ITERATIONS = 10         # the flagship main path's steps
FLAGSHIP_K = 10                  # cameras per flagship step
FLAGSHIP_VIEWS = (12, 2)         # train / test views of its dataset


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# scenes
# --------------------------------------------------------------------------

def bench_points():
    """bench.py:45-48: 43,132 points uniform in [-1.3, 1.3]^3 and uniform
    RGB colours, numpy seed 0."""
    rng = np.random.default_rng(0)
    pts = (rng.random((N_BENCH, 3)) * 2.6 - 1.3).astype(np.float32)
    cols = rng.uniform(0, 1, (N_BENCH, 3)).astype(np.float32)
    return pts, cols


def bench_params(dev, *, f_rest_std: float = 0.0, seed: int = 0) -> dict:
    """bench.py:45-54 as numpy arrays of the padded state: 43,132 points
    uniform in [-1.3, 1.3]^3 (numpy seed 0), DC colour from uniform RGB,
    kNN log-scales, identity rotations, opacity logit 0.5 (bench.py:54),
    SH degree 3; f_rest ~ N(0, f_rest_std) from torch.Generator(seed)."""
    from d3gs_tpu_torch.models.gaussians import round_capacity
    from d3gs_tpu_torch.ops.knn import knn_log_scales
    from d3gs_tpu_torch.ops.sh import rgb2sh
    pts, cols = bench_points()
    cap = round_capacity(N_BENCH)
    n = N_BENCH
    scales = knn_log_scales(torch.from_numpy(pts).to(dev)).cpu().numpy()
    gen = torch.Generator().manual_seed(seed)
    rest = (torch.randn((n, 15, 3), generator=gen) * f_rest_std).numpy()

    def padded(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, np.float32)
        out[:n] = a
        return out
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    params = {"xyz": padded(pts), "features_dc": padded(rgb2sh(cols)[:, None]),
              "features_rest": padded(rest), "scaling": padded(scales),
              "rotation": padded(rot, 0.0),
              "opacity": padded(np.full((n, 1), 0.5, np.float32))}
    params["rotation"][n:, 0] = 1.0
    return params, np.arange(cap) < n


def look_from_z(z: float, size: int, dev, fid: float = 0.5):
    from d3gs_tpu_torch.data.cameras import camera_from_matrices
    from d3gs_tpu_torch.ops.camera_math import world_to_view
    fov = math.radians(60)
    V = world_to_view(np.eye(3), np.array([0.0, 0.0, z])).T
    return camera_from_matrices(V, fov, fov, fid=fid,
                                image=np.zeros((size, size, 3), np.float32),
                                device=dev)


@torch.no_grad()
def stages(state, cam, field, bg, dup=0):
    """The render path of models/renderer.py, stage by stage:
    -> (records, bins, grid kwargs)."""
    from d3gs_tpu_torch.ops.binning import bin_splats_records
    from d3gs_tpu_torch.ops.projection import project_gaussians
    from d3gs_tpu_torch.ops.rasterize import pack_records
    from d3gs_tpu_torch.ops.sh import eval_sh_upto
    from d3gs_tpu_torch.models.deform.fields import ODE_KINDS
    xyz, d_rot, d_sc = state.params.xyz, 0.0, 0.0
    if field is not None:
        dx, d_rot, d_sc = field.step(state.params.xyz, cam.fid)
        # the ODE kinds integrate to absolute positions (direct_compute)
        xyz = dx if field.spec.kind in ODE_KINDS else xyz + dx
    dirs = xyz - cam.campos
    dirs = dirs / dirs.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    colors = (eval_sh_upto(state.max_sh_degree, state.active_sh_degree,
                           state.get_features, dirs) + 0.5).clamp_min(0.0)
    splats = project_gaussians(
        xyz, state.get_scaling + d_sc, state.get_rotation + d_rot,
        state.get_opacity[:, 0], colors, cam.viewmatrix, cam.projmatrix,
        cam.tanfovx, cam.tanfovy, cam.width, cam.height, alive=state.alive)
    tiles_x, tiles_y = (cam.width + 15) // 16, (cam.height + 15) // 16
    bins = bin_splats_records(splats, tiles_x=tiles_x, tiles_y=tiles_y,
                              dup_capacity=dup)
    grid = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=cam.width,
                height=cam.height)
    return pack_records(splats), bins, grid


def small_scenes(dev):
    """tests/test_pallas_blend.py's scenes, 64x64: a 300-Gaussian random
    scene (also under a 512-duplicate budget, which drops its deepest
    duplicates) and 64 near-opaque Gaussians stacked in depth (also under
    the 48-duplicate budget of its overflow test)."""
    from d3gs_tpu_torch.models.gaussians import gaussians_from_numpy
    from d3gs_tpu_torch.ops.knn import knn_log_scales
    from d3gs_tpu_torch.ops.sh import rgb2sh
    rng = np.random.default_rng(3)
    n, cap = 300, 512
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = rng.random((n, 3)) * 2.0 - 1.0
    cols = rng.uniform(0, 1, (n, 3))
    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1
    sc = np.zeros((cap, 3), np.float32)
    sc[:n] = knn_log_scales(torch.from_numpy(pts[:n]).to(dev)).cpu().numpy()
    rand = {"xyz": pts, "features_dc": np.zeros((cap, 1, 3), np.float32),
            "features_rest": np.zeros((cap, 0, 3), np.float32),
            "scaling": sc, "rotation": rot,
            "opacity": rng.uniform(-1, 3, (cap, 1)).astype(np.float32)}
    rand["features_dc"][:n, 0] = rgb2sh(cols)
    n2, cap2 = 64, 128
    xyz = np.zeros((cap2, 3), np.float32)
    xyz[:n2, 2] = np.linspace(2.0, 3.0, n2)
    stack = {"xyz": xyz,
             "features_dc": np.full((cap2, 1, 3), rgb2sh(0.7), np.float32),
             "features_rest": np.zeros((cap2, 0, 3), np.float32),
             "scaling": np.full((cap2, 3), -3.0, np.float32),
             "rotation": rot[:cap2], "opacity": np.full((cap2, 1), 8.0,
                                                        np.float32)}
    rs = gaussians_from_numpy(rand, np.arange(cap) < n, 0, 0, dev)
    ss = gaussians_from_numpy(stack, np.arange(cap2) < n2, 0, 0, dev)
    bg1 = torch.tensor([0.1, 0.2, 0.3], device=dev)
    bg0 = torch.zeros(3, device=dev)
    return [("random", rs, 3.0, 0, bg1), ("random_budget512", rs, 3.0, 512, bg1),
            ("saturated", ss, 4.0, 0, bg0), ("overflow48", ss, 4.0, 48, bg0)]


def deep_scene(dev):
    """`deep`, 64x64: 3,000 Gaussians of opacity 0.01 (σ 0.9) stacked in
    depth over the four central tiles, so that a pixel includes up to ~900
    records (0.99^900 ≈ 1e-4) and the kernels walk ~30 chunks of 32 and
    their prefetches; pixels off the stack's centre walk the whole list."""
    from d3gs_tpu_torch.models.gaussians import gaussians_from_numpy
    from d3gs_tpu_torch.ops.sh import rgb2sh
    rng = np.random.default_rng(7)
    n, cap = 3000, 3072
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n, :2] = rng.uniform(-0.3, 0.3, (n, 2))
    xyz[:n, 2] = np.linspace(2.0, 3.0, n)
    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1
    params = {"xyz": xyz, "features_dc": np.zeros((cap, 1, 3), np.float32),
              "features_rest": np.zeros((cap, 0, 3), np.float32),
              "scaling": np.full((cap, 3), math.log(0.9), np.float32),
              "rotation": rot,
              "opacity": np.full((cap, 1), math.log(0.01 / 0.99), np.float32)}
    params["features_dc"][:n, 0] = rgb2sh(rng.uniform(0, 1, (n, 3)))
    return gaussians_from_numpy(params, np.arange(cap) < n, 0, 0, dev)


def warp_edge_scene(dev, n: int = 600, size: int = 64):
    """`warp_edge`, 64x64: n anisotropic splats made in screen space (σ
    0.4-20 px at any angle; 30 % at opacities within 2 % above 1/255), each
    placed so that an extreme point of its 1/255 ellipse lies on an integer
    pixel column or row and 0.02-0.3 px inside or outside the last row of
    a 16x2 strip, the first row of the next, or a tile's last or first
    column: the edges of the kernels' per-warp cull. -> (records, bins)."""
    from d3gs_tpu_torch.ops.binning import bin_splats_records
    from d3gs_tpu_torch.ops.projection import ProjectedSplats
    from d3gs_tpu_torch.ops.rasterize import pack_records
    rng = np.random.default_rng(11)
    th = rng.uniform(0.0, np.pi, n)
    sl, ss = rng.uniform(2.0, 20.0, n), rng.uniform(0.4, 2.5, n)
    opa = np.where(rng.random(n) < 0.3,
                   (1.0 + rng.uniform(1e-5, 0.02, n)) / 255.0,
                   rng.uniform(0.02, 0.99, n))
    co, si = np.cos(th), np.sin(th)
    sxx = co * co * sl * sl + si * si * ss * ss
    syy = si * si * sl * sl + co * co * ss * ss
    sxy = co * si * (sl * sl - ss * ss)
    det = sxx * syy - sxy * sxy
    tau = 2.0 * np.log(255.0 * opa)
    hx, hy = np.sqrt(tau * sxx), np.sqrt(tau * syy)
    # off the edge by at least 0.02 px either way: a pixel within rounding
    # of alpha = 1/255 flips between any two f32 evaluations, the kernel's
    # and the plain version's (`check_cull` probes the cull itself within
    # 1e-3 px of the edges, against the kernels' own alpha)
    delta = rng.choice([-0.3, -0.05, -0.02, 0.02, 0.05, 0.3], n)
    side = rng.integers(0, 4, n)
    row = 2 * rng.integers(0, size // 2, n) + 1       # a strip's last row
    col = 16 * rng.integers(0, size // 16, n) + 15    # a tile's last column
    at = rng.integers(0, size, n).astype(np.float64)  # the extreme's pixel
    # the y-extreme sits at x = mean.x ± sxy/syy·hy, the x-extreme at
    # y = mean.y ± sxy/sxx·hx
    my = np.select([side == 0, side == 1], [row + delta - hy,
                                            row + 1 - delta + hy],
                   at - np.where(side == 2, 1.0, -1.0) * sxy / sxx * hx)
    mx = np.select([side == 2, side == 3], [col + delta - hx,
                                            col + 1 - delta + hx],
                   at - np.where(side == 0, 1.0, -1.0) * sxy / syy * hy)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,  # noqa: E731
                               device=dev)
    tiles = size // 16
    lo_x, hi_x = np.floor((mx - hx - 1) / 16), np.floor((mx + hx + 1) / 16)
    lo_y, hi_y = np.floor((my - hy - 1) / 16), np.floor((my + hy + 1) / 16)
    tmin = np.clip(np.stack([lo_x, lo_y], -1), 0, tiles)
    tmax = np.clip(np.stack([hi_x, hi_y], -1) + 1, 0, tiles)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    splats = ProjectedSplats(
        means2d=f(np.stack([mx, my], -1)), depths=f(rng.uniform(1, 10, n)),
        conics=f(np.stack([syy / det, -sxy / det, sxx / det], -1)),
        radii=i32(np.ceil(np.maximum(hx, hy))),
        colors=f(rng.uniform(0, 1, (n, 3))),
        opacities=f(opa), tile_min=i32(tmin), tile_max=i32(tmax),
        visible=torch.ones(n, dtype=torch.bool, device=dev),
        cull_radius=f(np.maximum(hx, hy)))
    return pack_records(splats), bin_splats_records(splats, tiles_x=tiles,
                                                    tiles_y=tiles)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def profile(fn, calls: int = 10, top: int = 12) -> dict:
    """torch.profiler over `calls` calls of fn: wall time, device kernel
    time and the device's busy share per call, and the kernels by device
    time."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [(e.key, e.self_device_time_total / 1e3 / calls,
                e.count / calls) for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.device_type.name == "CUDA"]
    kernels.sort(key=lambda k: -k[1])
    dev_ms = sum(k[1] for k in kernels)
    return {"wall_ms_per_call": wall_ms, "device_ms_per_call": dev_ms,
            "device_busy_share": dev_ms / wall_ms,
            "device_kernels_per_call": sum(k[2] for k in kernels),
            "top_kernels_ms_per_call": [
                [name[:60], round(ms, 4), round(c, 1)]
                for name, ms, c in kernels[:top]]}


def compare_blend(name, records, bins, bg, grid) -> float:
    """Kernel vs plain version on the same inputs; raises on disagreement.
    Returns the largest absolute difference of image, depth and alpha."""
    from d3gs_tpu_torch.ops import blend as B
    got = B.blend_forward_cuda(records, bins, bg, **grid)
    ref = B.blend_forward_torch(records, bins, bg, **grid)
    torch.cuda.synchronize()
    worst, msgs = 0.0, []
    for field in ("image", "depth", "alpha", "t_final"):
        a, b = getattr(got, field), getattr(ref, field)
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite {field} from the kernel")
        err = (a - b).abs()
        excess = float((err - (ATOL + RTOL * b.abs())).max())
        if field != "t_final":
            worst = max(worst, float(err.max()))
        msgs.append(f"{field} {float(err.max()):.3e}")
        if excess > 0:
            raise AssertionError(f"{name}: {field} differs beyond atol {ATOL} "
                                 f"/ rtol {RTOL} (max abs {float(err.max())})")
    same_walk = float((got.n_walked == ref.n_walked).float().mean())
    same_last = float((got.last_contrib == ref.last_contrib).float().mean())
    log(f"[3] {name}: M={int(bins.starts[-1])} max|kernel-plain| "
        + ", ".join(msgs) + f" (tol {ATOL} + {RTOL}|ref|); "
        f"records walked equal at {100 * same_walk:.3f}%, last included "
        f"record equal at {100 * same_last:.3f}% of pixels")
    # the two sum log T in different orders, so a pixel whose T lands on
    # the 1e-4 threshold within rounding may end one record apart
    if same_last < 1.0 - LAST_MISMATCH_SHARE:
        raise AssertionError(f"{name}: last included record differs at "
                             f"{100 * (1 - same_last):.4f}% of pixels")
    return worst


def cull_edge_records(seed: int, n: int = 4000) -> np.ndarray:
    """(n, 16) f32 records around a 64x64 image, at the per-warp cull's
    edges: anisotropic conics (σ 0.3-60 px at any angle), opacities within
    1e-6..2 % above 1/255 for half of them, and one extreme point of each
    1/255 ellipse on an integer pixel of a strip's last row (or a tile's
    last column) within ±1e-3 px. tests/test_torch_port_blend_cull.py holds
    `blend.warp_rows_hit` to the same records."""
    alpha_min = np.float64(np.float32(1.0 / 255.0))
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, np.pi, n)
    sl = np.exp(rng.uniform(np.log(0.5), np.log(60.0), n))
    ss = np.exp(rng.uniform(np.log(0.3), np.log(4.0), n))
    opa = np.where(rng.random(n) < 0.5,
                   alpha_min * (1 + np.exp(rng.uniform(np.log(1e-6),
                                                       np.log(2e-2), n))),
                   rng.uniform(0.01, 1.0, n))
    co, si = np.cos(th), np.sin(th)
    sxx = co * co * sl * sl + si * si * ss * ss
    syy = si * si * sl * sl + co * co * ss * ss
    sxy = co * si * (sl * sl - ss * ss)
    det = sxx * syy - sxy * sxy
    tau = 2 * np.log(opa / alpha_min)
    hx, hy = np.sqrt(tau * sxx), np.sqrt(tau * syy)
    delta = rng.uniform(-1e-3, 1e-3, n)
    at = rng.integers(0, 64, n)
    ycase = rng.random(n) < 0.5
    # bottom of the ellipse on a strip's last row, at an integer column
    my = np.where(ycase, 2 * rng.integers(0, 32, n) + 1 + delta - hy,
                  at - sxy / sxx * hx)
    mx = np.where(ycase, at - sxy / syy * hy,
                  16 * rng.integers(0, 4, n) + 15 + delta - hx)
    rec = np.zeros((n, 16), np.float32)
    rec[:, 0], rec[:, 1] = mx, my
    rec[:, 2], rec[:, 3], rec[:, 4] = syy / det, -sxy / det, sxx / det
    rec[:, 8] = opa
    return rec


def check_cull(dev) -> dict:
    """Phase 3: the blend kernels' per-warp cull (`rows_hit`) against their
    own alpha as nvcc compiles both (csrc/blend_checks.cu), on the
    records of `cull_edge_records` (seeds 0-2) and every 16x2 strip of a
    64x64 image. Raises if the cull rules out a strip where a pixel reaches
    1/255, or if no ruled-out strip comes within 10 % of 1/255 (the edges
    went untested)."""
    import ctypes
    from d3gs_tpu_torch.ops import _build
    fn = _build.load("blend_checks").d3gs_blend_cull_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rec = torch.from_numpy(np.concatenate(
        [cull_edge_records(seed) for seed in range(3)])).to(dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    if fn(rec.data_ptr(), rec.stride(0), rec.shape[0], 64 // 16, 64 // 2,
          counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream):
        raise RuntimeError("cull check kernel failed to launch")
    misses, kept, grazing = (int(c) for c in counts.cpu())
    pairs = rec.shape[0] * (64 // 16) * (64 // 2)
    log(f"[3] per-warp cull vs the kernels' alpha on {rec.shape[0]} edge "
        f"records x 128 strips: {misses} strips ruled out with a pixel at "
        f"alpha >= 1/255, {kept} of {pairs} kept, {grazing} ruled out "
        f"within 10 % of 1/255")
    if misses:
        raise AssertionError(f"the cull drops {misses} visible strips")
    if not grazing:
        raise AssertionError("no ruled-out strip came near 1/255")
    return {"misses": misses, "kept": kept, "grazing": grazing}


def check_log1p(dev) -> int:
    """Phase 3: the forward kernel's branch-free log1p (`log1p_neg`, a copy
    of CUDA 12.9's log1pf) against this toolkit's log1pf, bit for bit, on
    every f32 alpha in (0, 0.99] (csrc/blend_checks.cu); raises on any
    mismatch."""
    import ctypes
    from d3gs_tpu_torch.ops import _build
    fn = _build.load("blend_checks").d3gs_blend_log1p_check
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    if fn(count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream):
        raise RuntimeError("log1p check kernel failed to launch")
    bad = int(count)
    log(f"[3] log1p of the forward kernel vs log1pf over the f32 alpha in "
        f"(0, 0.99]: {bad} differ")
    if bad:
        raise AssertionError(f"log1p_neg differs from this toolkit's log1pf "
                             f"at {bad} inputs: copy its normal path anew")
    return bad


def blend_loss_grads(out):
    """Upstream gradients of a loss that touches image, depth and alpha
    (tests/test_pallas_blend.py:81-86): sum (image - 0.5)² + 0.01 sum depth
    + 0.02 sum alpha."""
    return (2.0 * (out.image - 0.5), torch.full_like(out.depth, 0.01),
            torch.full_like(out.alpha, 0.02))


def compare_blend_bwd(name, records, bins, bg, grid, tol) -> float:
    """Backward kernel vs plain version on the same inputs (the kernel's
    forward output and the same upstream gradients), with and without the
    depth term; raises unless finite and within `tol` of the largest
    plain gradient. Returns the largest absolute difference."""
    from d3gs_tpu_torch.ops import blend as B
    fwd = B.blend_forward_cuda(records, bins, bg, **grid)
    g_img, g_dep, g_alp = blend_loss_grads(fwd)
    worst, msgs = 0.0, []
    for depth_grad in (True, False):
        args = (records, bins, bg, fwd, g_img, g_dep, g_alp)
        got = B.blend_backward_cuda(*args, **grid, depth_grad=depth_grad)
        ref = B.blend_backward_torch(*args, **grid, depth_grad=depth_grad)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite gradient from the "
                                 "backward kernel")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        worst = max(worst, err)
        msgs.append(f"depth_grad={depth_grad}: max {err:.3e} = "
                    f"{err / scale:.2e} of max {scale:.3e}")
        if not err <= tol * scale:
            raise AssertionError(f"{name}: backward differs by {err} > "
                                 f"{tol} x {scale} (depth_grad={depth_grad})")
    log(f"[3b] {name}: " + "; ".join(msgs) + f" (tol {tol} of max)")
    return worst


def write_dnerf_dataset(root: str, n_train=4, n_test=2, size=WIDTH):
    """D-NeRF layout: transforms_{train,test}.json + RGBA PNGs, cameras on a
    radius-4 orbit looking at the origin, `time` spread over [0, 1]."""
    from d3gs_tpu_torch.data.image_io import write_png
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1)

    def c2w(angle, radius=4.0):
        # inverse of the D-NeRF reader's pose flip
        R = np.array([[math.cos(angle), 0, math.sin(angle)], [0, 1, 0],
                      [-math.sin(angle), 0, math.cos(angle)]])
        Rr = -R
        Rr[:, 0] = -Rr[:, 0]
        inv = np.eye(4)
        inv[:3, :3] = Rr.T
        inv[:3, 3] = -np.array([0.0, 0.0, radius])
        return np.linalg.inv(inv)

    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for k in range(n):
            t = k / max(n - 1, 1)
            rgba = np.stack([xx, yy, np.full_like(xx, t),
                             np.ones_like(xx)], -1)
            write_png(os.path.join(root, split, f"r_{k:03d}.png"),
                      (rgba * 255).astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{k:03d}", "time": t,
                           "transform_matrix": c2w(k * 2 * math.pi / n
                                                   + 0.3).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": math.radians(60), "frames": frames},
                      f)


def roofline(bytes_moved, flops, sfu):
    """-> (least ms, what bounds it) for `bytes_moved`, `flops` f32
    operations and `sfu` transcendentals on the H100's published peaks."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS, sfu / SFU_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


@torch.no_grad()
def blend_work(records, bins, fwd, *, tiles_x, tiles_y, width, height,
               tile_chunk: int = 16) -> dict:
    """Pixel-record pairs the blend kernels evaluate on these inputs, from
    the records as the kernels read them. A kernel's warp owns a 16x2
    strip and visits only the records of its tile's list that the cull
    (`blend.warp_rows_hit`) keeps for the strip, up to the strip's deepest
    pixel. `walked` / `range`: a pixel's pairs with a kept record before
    its n_walked (the forward) / last_contrib (the backward);
    `walked_all` / `range_all`: the same without the cull (sum of n_walked,
    of last_contrib: what a per-tile kernel without the cull evaluates); of
    each, the pairs whose alpha
    reaches 1/255 (`walked_inc`, `range_inc`; the cull keeps them all);
    `fwd_visits` / `bwd_visits`: the (warp, record) visits, kept records
    before the strip's largest n_walked / last_contrib; and the Gaussians
    with at least one included pair in the backward's range
    (`gaussians_reached`)."""
    from d3gs_tpu_torch.ops import blend as B
    dev = records.device
    starts = bins.starts.long()
    counts = starts[1:] - starts[:-1]
    gid = B.sorted_gids(bins).long()
    pix = torch.arange(B.P, device=dev)
    lx, ly = (pix % B.TILE).float(), (pix // B.TILE).float()
    walked = B._tiles(fwd.n_walked, tiles_x, tiles_y).long()
    last = B._tiles(fwd.last_contrib, tiles_x, tiles_y).long()
    strips = B.TILE // 2
    w_max = walked.view(-1, strips, 32).amax(-1)            # (T, 8)
    l_max = last.view(-1, strips, 32).amax(-1)
    work = dict.fromkeys(("walked", "walked_inc", "range", "range_inc",
                          "fwd_visits", "bwd_visits"), 0)
    reached = torch.zeros(records.shape[0], dtype=torch.bool, device=dev)
    for c0 in range(0, tiles_x * tiles_y, tile_chunk):
        tiles = torch.arange(c0, min(c0 + tile_chunk, tiles_x * tiles_y),
                             device=dev)
        cnt = counts[tiles]
        k = torch.arange(int(cnt.max()), device=dev)
        live = k[None, :] < cnt[:, None]
        idx = torch.where(live, starts[tiles][:, None] + k[None, :], 0)
        r = records[gid[idx]]                                  # (Tc, K, 16)
        ox = ((tiles % tiles_x) * B.TILE).float()
        oy = ((tiles // tiles_x) * B.TILE).float()
        dx = r[..., 0:1] - (ox[:, None, None] + lx)
        dy = r[..., 1:2] - (oy[:, None, None] + ly)
        power = (-0.5 * (r[..., 2:3] * dx * dx + r[..., 4:5] * dy * dy)
                 - r[..., 3:4] * dx * dy)
        hit = (power <= 0.0) & (r[..., 8:9] * torch.exp(power)
                                >= B.ALPHA_MIN)                # (Tc, K, P)
        y0 = oy[:, None] + 2.0 * torch.arange(strips, device=dev)
        keep = B.warp_rows_hit(r[:, :, None, :], ox[:, None, None],
                               y0[:, None, :]) & live[..., None]  # (Tc,K,8)
        keep_pix = keep.repeat_interleave(32, dim=-1)          # (Tc, K, P)
        kk = k[None, :, None]
        before_w = kk < walked[tiles][:, None, :]
        before_l = kk < last[tiles][:, None, :]
        work["walked"] += int((keep_pix & before_w).sum())
        work["walked_inc"] += int((hit & before_w).sum())
        work["range"] += int((keep_pix & before_l).sum())
        used = hit & before_l
        work["range_inc"] += int(used.sum())
        work["fwd_visits"] += int((keep & (kk < w_max[tiles][:, None, :]))
                                  .sum())
        work["bwd_visits"] += int((keep & (kk < l_max[tiles][:, None, :]))
                                  .sum())
        reached[gid[idx][used.any(dim=-1)]] = True
    work.update(walked_all=int(walked.sum()), range_all=int(last.sum()),
                gaussians_reached=int(reached.sum()))
    return work


def sass_loops(lib: str) -> list[dict]:
    """The loops of each kernel in the shared library `lib`, read from
    `cuobjdump -sass`: for every backward branch, the kernel, the loop's
    first and last offsets, its SASS instruction count and how many of
    those are MUFU (SFU), SHFL, LDS, LDG, STS and RED/ATOM. The count
    includes both sides of any branch inside the loop."""
    import re
    from d3gs_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    loops, fn, insts = [], None, []

    def flush():
        for off, op, args in insts:
            targets = re.findall(r"0x([0-9a-f]+)", args)
            if not op.startswith("BRA") or not targets:
                continue
            target = int(targets[-1], 16)
            if target > off:
                continue
            body = [o for a, o, _ in insts if target <= a <= off]
            loops.append({"kernel": fn, "first": hex(target),
                          "last": hex(off), "instructions": len(body),
                          **{cls: sum(o.startswith(cls) for o in body)
                             for cls in ("MUFU", "SHFL", "LDS", "LDG",
                                         "STS", "RED", "ATOM")}})

    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            flush()
            fn, insts = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and fn:
            code = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip())
            insts.append((int(m.group(1), 16), code.split()[0], code))
    flush()
    return loops


def issue_model(src: str, loops: list[dict], visits: int) -> dict:
    """The issue-rate model of one blend kernel, `src` its source: its walk
    loop (the smallest loop with an SFU instruction, in the kernel's
    photometric instantiation) has `instructions` SASS instructions per
    iteration and one iteration visits `group` records for a warp (the
    source's kGroup, else 1); `visits` (warp, record) visits at 4
    instructions per clock per SM on 132 SMs take `ms`."""
    import re
    kernel = os.path.basename(src)[:-3]
    found = re.search(r"constexpr int kGroup = (\d+);", open(src).read())
    group = int(found[1]) if found else 1
    mine = [lp for lp in loops if lp["MUFU"] > 0
            and f"{kernel}_kernel" in lp["kernel"]
            and (kernel == "blend_fwd" or "Lb0E" in lp["kernel"])]
    loop = min(mine, key=lambda lp: lp["instructions"])
    per_visit = loop["instructions"] / group
    return {"loop": loop, "group": group, "per_visit": per_visit,
            "visits": visits, "ms": visits * per_visit / ISSUE_PER_S * 1e3}


def blend_bounds(records, bins, grid, work) -> dict:
    """Phase 6: the roofline bound of each blend kernel on this scene from
    the pairs it evaluates (`blend_work`), under the new count (culled
    pairs, this source's operations) and without the cull (every pair
    before n_walked / last_contrib; the log-space backward's 46 operations,
    log1p and exp per included pair). Bytes: the 10 record fields of every
    row, gid and the tile starts in; the forward writes 9 words per pixel,
    the backward reads 6 (T_final, last_contrib, the image and alpha
    cotangents) and writes the (N, 16) gradient."""
    n_rows, m = records.shape[0], int(bins.starts[-1])
    pixels = grid["width"] * grid["height"]
    inputs = (n_rows * 10 + m + grid["tiles_x"] * grid["tiles_y"] + 1) * 4
    fwd_bytes = inputs + pixels * 9 * 4
    bwd_bytes = inputs + pixels * 6 * 4 + n_rows * 16 * 4
    w, out = work, {}
    for count, pairs, bwd_inc in (
            ("new", "", (BWD_INC_FLOPS, BWD_INC_SFU)),
            ("uncull", "_all", BWD_INC_LOG_T)):
        out[count] = {
            "blend_fwd": roofline(
                fwd_bytes, w["walked" + pairs] * PAIR_FLOPS
                + w["walked_inc"] * FWD_INC_FLOPS,
                w["walked" + pairs] * PAIR_SFU
                + w["walked_inc"] * FWD_INC_SFU),
            "blend_bwd": roofline(
                bwd_bytes, w["range" + pairs] * PAIR_FLOPS
                + w["range_inc"] * bwd_inc[0],
                w["range" + pairs] * PAIR_SFU + w["range_inc"] * bwd_inc[1])}
    return out


def render_main_path(dev, data, mp) -> dict:
    """Phase 4: a model directory at the bench scale, rendered through
    `d3gs_tpu_torch.render.main([... "--benchmark"])`; the forward's launch
    count is read around that call and test render 0 is held against the
    plain blend."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch import render as R
    from d3gs_tpu_torch.data.image_io import read_png
    from d3gs_tpu_torch.data.scene import Scene, save_gaussians_ply
    from d3gs_tpu_torch.models.deform.fields import (
        DeformFieldSpec, create_deform_field, load_deform_weights,
        save_deform_weights)
    from d3gs_tpu_torch.models.gaussians import gaussians_from_numpy
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.train.flagship import pick_field_spec
    params4, alive4 = bench_params(dev, f_rest_std=0.05, seed=1)
    os.makedirs(os.path.join(mp, "point_cloud", "iteration_1"))
    save_gaussians_ply(
        os.path.join(mp, "point_cloud", "iteration_1", "point_cloud.ply"),
        gaussians_from_numpy(params4, alive4, 3, 3, "cpu"))
    save_deform_weights(mp, 1, create_deform_field(
        DeformFieldSpec(kind="baseline", is_blender=True), seed=1,
        device="cpu"))
    C.save_cfg_args(mp, C.ModelParams(source_path=data, model_path=mp,
                                      eval=True, is_blender=True,
                                      sh_degree=3, D=8, W=256))
    B.launches = 0
    t0 = time.perf_counter()
    result = R.main(["-m", mp, "--mode", "render", "--benchmark"])
    torch.cuda.synchronize()
    launches = {"blend_fwd": B.launches}
    result["launches"] = launches
    log(f"[4] render.main: {result} in {time.perf_counter() - t0:.1f} s; "
        f"kernel launches {launches}")
    frames = result["views"] + result["benchmark"]["frames"]
    if launches["blend_fwd"] < frames:
        raise AssertionError(f"blend_fwd launched {launches['blend_fwd']}"
                             f" times for {frames} frames")
    cov = []
    for split, n in (("train", 4), ("test", 2)):
        for i in range(n):
            img = read_png(os.path.join(mp, split, "ours_1", "renders",
                                        f"{i:05d}.png"))
            assert img.shape == (HEIGHT, WIDTH, 3), img.shape
            cov.append(float((img.max(axis=-1) > 0).mean()))
    if min(cov) <= 0.05:
        raise AssertionError(f"renders cover too little: {cov}")
    # the CLI's test render 0 against the plain blend of the same view
    cfg = C.ModelParams(**C.load_cfg_args(mp))
    scene = Scene(cfg, load_iteration=-1, shuffle=False, device=dev)
    fld = load_deform_weights(mp, create_deform_field(
        pick_field_spec(cfg, C.OptimizationParams()), device=dev))
    view = scene.get_test_cameras()[0]
    bg = torch.zeros(3, device=dev)
    rec_v, bins_v, grid_v = stages(scene.gaussians, view, fld, bg)
    plain = B.blend_forward_torch(rec_v, bins_v, bg, **grid_v)
    assert torch.isfinite(plain.image).all()
    want = (255 * plain.image.clamp(0, 1)).to(torch.uint8).cpu().numpy()
    got = read_png(os.path.join(mp, "test", "ours_1", "renders",
                                "00000.png"))
    diff = int(np.abs(got.astype(int) - want.astype(int)).max())
    log(f"[4] coverage of the 6 renders {[round(c, 3) for c in cov]}; "
        f"test render 0 vs the plain blend: max {diff} of 255")
    if diff > 1:
        raise AssertionError("CLI render disagrees with the plain blend")
    return result


def train_main_path(dev, data, mp) -> dict:
    """Phase 4b: `python -m d3gs_tpu_torch.train` in-process at the bench
    width (bench.py's 43,132 points as the dataset's point cloud, 400x400,
    SH 3, the 8x256 Blender MLP), with flags that reach every branch of
    the loop in a few seconds: warm-up then deform steps, two densify
    passes at a threshold low enough to clone and split, a PSNR evaluation
    and a checkpoint. The kernels' launch counts
    are read around that call. Then the checkpoint is rendered through
    `render.main`."""
    from d3gs_tpu_torch.data.image_io import read_png
    from d3gs_tpu_torch.data.ply import write_pointcloud_ply
    from d3gs_tpu_torch import render as R
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.train.__main__ import main as train_main
    pts, cols = bench_points()
    write_pointcloud_ply(os.path.join(data, "points3d.ply"), pts,
                         np.round(cols * 255))
    n_eval = 2
    B.launches = B.launches_bwd = 0
    t0 = time.perf_counter()
    result = train_main([
        "-s", data, "-m", mp, "--eval", "--is_blender", "--quiet",
        "--iterations", str(TRAIN_ITERATIONS), "--warm_up", "6",
        "--sh_degree", "3", "--densify_from_iter", "8",
        "--densify_until_iter", "18", "--densification_interval", "4",
        # far below this scene's screen-space gradients (phase 5 prints
        # them; the default 7e-4 and 2e-5 clone nothing in 12 steps here),
        # so that the passes clone, split and grow the buffer
        "--densify_grad_threshold", "1e-8",
        "--test_iterations", str(TRAIN_ITERATIONS),
        "--save_iterations", str(TRAIN_ITERATIONS),
        "--sequence_length", "4"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"blend_fwd": B.launches, "blend_bwd": B.launches_bwd}
    log(f"[4b] train.main: {TRAIN_ITERATIONS} iterations in {wall:.1f} s; "
        f"kernel launches {launches}; losses {result.losses}; PSNR "
        f"{result.test_psnrs}; densify (iteration, alive, capacity before, "
        f"alive, capacity after) {result.densify_events}; best PSNR "
        f"{result.best_psnr} at {result.best_iteration}")
    if launches["blend_bwd"] < TRAIN_ITERATIONS:
        raise AssertionError(f"blend_bwd launched {launches['blend_bwd']} "
                             f"times for {TRAIN_ITERATIONS} train steps")
    if launches["blend_fwd"] < TRAIN_ITERATIONS + n_eval:
        raise AssertionError(f"blend_fwd launched {launches['blend_fwd']} "
                             f"times for {TRAIN_ITERATIONS} steps and "
                             f"{n_eval} evaluation renders")
    values = [v for _, v in result.losses] + list(result.test_psnrs.values())
    if not (values and all(math.isfinite(v) for v in values)
            and TRAIN_ITERATIONS in result.test_psnrs):
        raise AssertionError(f"loss or PSNR not finite: {result.losses}, "
                             f"{result.test_psnrs}")
    # the low threshold makes the passes clone and split
    if not any(n1 != n0 for _, n0, _, n1, _ in result.densify_events):
        raise AssertionError(f"densification changed no alive count: "
                             f"{result.densify_events}")
    if result.state.num_alive == 0:
        raise AssertionError("every Gaussian was pruned")

    t0 = time.perf_counter()
    out = R.main(["-m", mp, "--mode", "render"])
    torch.cuda.synchronize()
    it = TRAIN_ITERATIONS
    imgs = [read_png(os.path.join(mp, split, f"ours_{it}", "renders",
                                  f"{i:05d}.png"))
            for split, n in (("train", 4), ("test", 2)) for i in range(n)]
    if out != {"iteration": it, "views": 6} or any(
            im.shape != (HEIGHT, WIDTH, 3) for im in imgs):
        raise AssertionError(f"render of the trained model: {out}")
    log(f"[4b] render.main of the checkpoint: {out} in "
        f"{time.perf_counter() - t0:.1f} s; mean pixel of the renders "
        f"{[round(float(im.mean()), 1) for im in imgs]}")
    return launches


def row_inputs(dev) -> dict:
    """The three tools' inputs on the card, drawn as the tools draw them
    (numpy seed 0): the channel-major (3072, 16, 128) gradient rows of
    exp_r5_reduce seen as the (3072, 128, 16) view that V2 copies, the
    (44,032, 16) table and (512, 128) indices of exp_vmem_gather, the
    (2752, 128, 16) rows and ranks below 44,032 of exp_vmem_scatter."""
    from d3gs_tpu_torch.tools import exp_r5_reduce as TR
    from d3gs_tpu_torch.tools import exp_vmem_gather as TG
    from d3gs_tpu_torch.tools import exp_vmem_scatter as TS
    g = TR.make_inputs(dev).g
    rows, rank = TS.make_inputs(dev)
    return {"row_copy": (g.transpose(1, 2),),
            "row_gather": TG.make_inputs(dev),
            "scatter_add_rows": (rows, rank, TS.N1)}


def compare_rows(inp: dict) -> dict:
    """Phase 3c: each row kernel against its plain version on the tools'
    inputs; the copy and the gather must be bit-equal, the scatter-add
    within ROW_SCATTER_TOL of the largest |sum| (atomics add in no fixed
    order). Returns each kernel's largest absolute difference."""
    from d3gs_tpu_torch.ops import rows as R
    errs = {}
    for name in ("row_copy", "row_gather", "scatter_add_rows"):
        got = getattr(R, name + "_cuda")(*inp[name])
        ref = getattr(R, name + "_torch")(*inp[name])
        torch.cuda.synchronize()
        if not torch.isfinite(got).all() or got.shape != ref.shape:
            raise AssertionError(f"{name}: non-finite or misshapen output")
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        tol = ROW_SCATTER_TOL * scale if name == "scatter_add_rows" else 0.0
        log(f"[3c] {name}: shape {tuple(got.shape)}, max|kernel-plain| "
            f"{err:.3e} (tol {tol:.3e}, largest |plain| {scale:.3e})")
        if not err <= tol:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by {err} > {tol}")
        errs[name] = err
    return errs


def tool_paths() -> dict:
    """Phase 4c: the three tools through their main(), each with the row
    kernels' counts set to 0 just before it and read just after; each must
    launch its kernel and pass its own correctness check."""
    from d3gs_tpu_torch.ops import rows as R
    from d3gs_tpu_torch.tools import exp_r5_reduce, exp_vmem_gather, \
        exp_vmem_scatter
    launches = {}
    for kernel, tool in (("row_copy", exp_r5_reduce),
                         ("row_gather", exp_vmem_gather),
                         ("scatter_add_rows", exp_vmem_scatter)):
        for k in R.launches:
            R.launches[k] = 0
        t0 = time.perf_counter()
        out = tool.main(["--reps", "10"])
        torch.cuda.synchronize()
        launches[kernel] = R.launches[kernel]
        log(f"[4c] {tool.__name__}.main: {time.perf_counter() - t0:.1f} s, "
            f"launches {dict(R.launches)}; {json.dumps(out)}")
        if launches[kernel] == 0:
            raise AssertionError(f"{tool.__name__} did not launch {kernel}")
        if tool is exp_r5_reduce:
            ok = all(out[k] <= 1e-4 * out["max_abs_v0"] for k in
                     ("max_abs_v0_v1", "max_abs_v0_v2", "max_abs_v0_v3"))
        elif tool is exp_vmem_gather:
            ok = out["exact"]
        else:
            ok = out["max_abs_err"] <= ROW_SCATTER_TOL * out["max_abs_sum"]
        if not ok:
            raise AssertionError(f"{tool.__name__}: check failed: {out}")
    return launches


def flagship_main_path(dev, data, mp) -> dict:
    """Phase 4d: `python -m d3gs_tpu_torch.train --trainer flagship` in
    process at the bench width: bench.py's 43,132 points on a 12-view
    D-NeRF set at 400x400, the 8x256 Blender ODE field (`--is_ode`, rk4 with
    4 substeps per segment), 10 cameras per step; 10 iterations through the
    warm-up, deform-only steps, a switch to Gaussian-only and back to both,
    one densify pass, a PSNR evaluation and a checkpoint, which
    `render.main` then renders. The blend kernels' counts are read around
    the trainer; test render 0 of the checkpoint is held against the plain
    blend of the same view."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch import render as R
    from d3gs_tpu_torch.data.image_io import read_png
    from d3gs_tpu_torch.data.ply import write_pointcloud_ply
    from d3gs_tpu_torch.data.scene import Scene
    from d3gs_tpu_torch.models.deform.fields import (create_deform_field,
                                                     load_deform_weights)
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.train.__main__ import main as train_main
    from d3gs_tpu_torch.train.flagship import pick_field_spec
    pts, cols = bench_points()
    write_pointcloud_ply(os.path.join(data, "points3d.ply"), pts,
                         np.round(cols * 255))
    it, k = FLAGSHIP_ITERATIONS, FLAGSHIP_K
    n_train, n_test = FLAGSHIP_VIEWS
    B.launches = B.launches_bwd = 0
    t0 = time.perf_counter()
    result = train_main([
        "-s", data, "-m", mp, "--eval", "--is_blender", "--quiet",
        "--trainer", "flagship", "--is_ode", "--D", "8", "--W", "256",
        "--num_cams_per_iter", str(k), "--iterations", str(it),
        "--warm_up", "3", "--use_iterative_update",
        "--iterative_update_interval", "5", "--max_training_switches", "1",
        "--sh_degree", "3", "--densify_from_iter", "4",
        "--densify_until_iter", "9", "--densification_interval", "4",
        "--densify_grad_threshold", "1e-8",
        "--test_iterations", str(it), "--save_iterations", str(it)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"blend_fwd": B.launches, "blend_bwd": B.launches_bwd}
    log(f"[4d] train.main --trainer flagship: {it} iterations x {k} cameras "
        f"in {wall:.1f} s; kernel launches {launches}; losses "
        f"{result.losses}; PSNR {result.test_psnrs}; densify "
        f"{result.densify_events}; deform updates "
        f"{result.deform_state.count}")
    if result.field.spec.kind != "ode" or result.field.spec.n_substeps != 4:
        raise AssertionError(f"flagship field: {result.field.spec}")
    if launches["blend_bwd"] < it * k:
        raise AssertionError(f"blend_bwd launched {launches['blend_bwd']} "
                             f"times for {it} steps of {k} cameras")
    if launches["blend_fwd"] < it * k + n_test:
        raise AssertionError(f"blend_fwd launched {launches['blend_fwd']} "
                             f"times for {it} steps of {k} cameras and "
                             f"{n_test} evaluation renders")
    values = [v for _, v in result.losses] + list(result.test_psnrs.values())
    if not (values and all(math.isfinite(v) for v in values)
            and it in result.test_psnrs):
        raise AssertionError(f"loss or PSNR not finite: {result.losses}, "
                             f"{result.test_psnrs}")
    # iterations 3..10 update the field except 5, the Gaussian-only one
    if result.deform_state.count != it - 3:
        raise AssertionError(f"{result.deform_state.count} deform updates")
    if not any(n1 != n0 for _, n0, _, n1, _ in result.densify_events):
        raise AssertionError(f"densification changed no alive count: "
                             f"{result.densify_events}")

    t0 = time.perf_counter()
    out = R.main(["-m", mp, "--mode", "render"])
    torch.cuda.synchronize()
    if out != {"iteration": it, "views": n_train + n_test}:
        raise AssertionError(f"render of the flagship checkpoint: {out}")
    cfg = C.ModelParams(**C.load_cfg_args(mp))
    scene = Scene(cfg, load_iteration=-1, shuffle=False, device=dev)
    fld = load_deform_weights(mp, create_deform_field(
        pick_field_spec(cfg, C.OptimizationParams()), device=dev))
    view = scene.get_test_cameras()[0]
    bg = torch.zeros(3, device=dev)
    plain = B.blend_forward_torch(*stages(scene.gaussians, view, fld, bg)[:2],
                                  bg, tiles_x=(WIDTH + 15) // 16,
                                  tiles_y=(HEIGHT + 15) // 16, width=WIDTH,
                                  height=HEIGHT)
    want = (255 * plain.image.clamp(0, 1)).to(torch.uint8).cpu().numpy()
    got = read_png(os.path.join(mp, "test", f"ours_{it}", "renders",
                                "00000.png"))
    diff = int(np.abs(got.astype(int) - want.astype(int)).max())
    log(f"[4d] render.main of the flagship checkpoint: {out} in "
        f"{time.perf_counter() - t0:.1f} s; test render 0 vs the plain "
        f"blend of the ODE field's positions: max {diff} of 255")
    if diff > 1:
        raise AssertionError("flagship render disagrees with the plain blend")
    return launches


def blend_kernel_times(records, bins, bg, grid) -> dict:
    """Phase 5: both blend kernels alone on one scene, launched into
    preallocated outputs (so the wrappers' host work, checks and
    allocation, is not in the time; the backward accumulating into one
    buffer zeroed once, with the trainers' depth_grad=False and again with
    depth): CUDA events around back-to-back launches (`*_ms`) and
    torch.profiler's device time per launch (`*_device_ms`)."""
    from d3gs_tpu_torch.ops import blend as B
    gid = B.sorted_gids(bins)
    tiles = dict(tiles_x=grid["tiles_x"], tiles_y=grid["tiles_y"])
    out = B.blend_forward_cuda(records, bins, bg, **grid, gid=gid)
    g_img, g_dep, g_alp = blend_loss_grads(out)
    buf = torch.zeros((records.shape[0], 16), device=records.device)

    def fwd():
        B.launch(records, gid, bins.starts, bg, out, **tiles)

    def bwd(depth_grad=False):
        B.launch_bwd(records, gid, bins.starts, bg, out, g_img, g_dep, g_alp,
                     buf, **tiles, depth_grad=depth_grad)

    def device_ms(fn):
        return profile(fn, calls=50, top=2)["device_ms_per_call"]
    return {"blend_fwd_ms": cuda_ms(fwd, 200),
            "blend_fwd_device_ms": device_ms(fwd),
            "blend_bwd_ms": cuda_ms(bwd, 100),
            "blend_bwd_device_ms": device_ms(bwd),
            "blend_bwd_depth_ms": cuda_ms(lambda: bwd(True), 100)}


def render_timings(state, field, cam, bg, records, bins, grid):
    """Phase 5, render side: the stages of one frame at the bench shape
    (CUDA events), both blend kernels alone on the bench scene, and a
    torch.profiler pass over frames."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.ops.binning import bin_splats_records
    from d3gs_tpu_torch.ops.projection import project_gaussians
    from d3gs_tpu_torch.ops.sh import eval_sh_upto
    from d3gs_tpu_torch.render_eval.render_modes import make_render_fn
    st = state
    with torch.no_grad():
        dx, dr, ds = field.step(st.params.xyz, 0.5)
        xyz = st.params.xyz + dx
        dirs = xyz - cam.campos
        dirs = dirs / dirs.norm(dim=-1, keepdim=True).clamp_min(1e-8)

        def sh_proj():
            c = (eval_sh_upto(3, 3, st.get_features, dirs) + 0.5).clamp_min(0)
            return project_gaussians(
                xyz, st.get_scaling + ds, st.get_rotation + dr,
                st.get_opacity[:, 0], c, cam.viewmatrix, cam.projmatrix,
                cam.tanfovx, cam.tanfovy, WIDTH, HEIGHT, alive=st.alive)
        splats = sh_proj()
        out = B.blend_forward_cuda(records, bins, bg, **grid)
        render_at = make_render_fn(st, field, C.PipelineParams())
        t = {
            "deform_mlp_ms": cuda_ms(lambda: field.step(st.params.xyz, 0.5), 20),
            "sh_projection_ms": cuda_ms(sh_proj, 20),
            "binning_ms": cuda_ms(lambda: bin_splats_records(
                splats, tiles_x=25, tiles_y=25), 20),
            "blend_wrapper_ms": cuda_ms(lambda: B.blend_forward_cuda(
                records, bins, bg, **grid), 50),
            "blend_plain_ms": cuda_ms(lambda: B.blend_forward_torch(
                records, bins, bg, **grid), 5, warmup=1),
            "frame_ms": cuda_ms(lambda: render_at(st, field, cam, bg), 20),
        }
        prof = profile(lambda: render_at(st, field, cam, bg))
    t["fps"] = 1000.0 / t["frame_ms"]
    t["kernels"] = blend_kernel_times(records, bins, bg, grid)
    work = blend_work(records, bins, out, **grid)
    t.update(M=int(bins.starts[-1]), pixel_record_pairs=work,
             gaussians=N_BENCH, size=f"{WIDTH}x{HEIGHT}")
    return t, prof, work


def train_timings(dev, state, cam, bg, records, bins, grid):
    """Phase 5, train side, at the bench shape with every SH band active
    (bench.py:50-54): one deform-phase train step, its layers one by one,
    the backward kernel through its wrapper and in its plain version (CUDA
    events), both blend kernels alone on the step's own scene, and a
    torch.profiler pass over train steps."""
    import dataclasses
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.models import gaussians as G
    from d3gs_tpu_torch.models.deform.fields import (DeformFieldSpec,
                                                     create_deform_field)
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.ops.losses import l1_loss, ssim
    from d3gs_tpu_torch.ops.rasterize import pack_records
    from d3gs_tpu_torch.ops.projection import project_gaussians
    from d3gs_tpu_torch.ops.sh import eval_sh_upto
    from d3gs_tpu_torch.train.step import densify_fns, make_train_step
    opt, pipe = C.OptimizationParams(), C.PipelineParams()
    field = create_deform_field(DeformFieldSpec(kind="baseline",
                                                is_blender=True), seed=2,
                                device=dev, opt_cfg=opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    gt = torch.rand((HEIGHT, WIDTH, 3), device=dev, generator=gen)
    cam = dataclasses.replace(cam, image=gt)
    dstate = field.init_state()
    step = make_train_step(
        opt_cfg=opt, pipe_cfg=pipe,
        deform_fn=lambda xyz, fid, it, g: field.step(xyz, fid),
        deform_params=list(field.net.parameters()),
        deform_update_fn=field.update)
    train_step = lambda: step(state, dstate, cam, 5000, None, bg)  # noqa: E731

    # the layers of the step, each forward + backward where it has one
    xyz = state.params.xyz
    cot = [torch.randn((xyz.shape[0], k), device=dev, generator=gen)
           for k in (3, 4, 3)]

    def mlp_fwd_bwd():
        outs = field.step(xyz, 0.5)
        return torch.autograd.grad(outs, list(field.net.parameters()), cot)

    g_rec = torch.randn_like(records)

    def sh_proj_fwd_bwd():
        p = G.GaussianParams(*(x.detach().requires_grad_()
                               for x in state.params))
        st = dataclasses.replace(state, params=p)
        dirs = p.xyz - cam.campos
        dirs = dirs / dirs.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        c = (eval_sh_upto(3, 3, st.get_features, dirs) + 0.5).clamp_min(0)
        splats = project_gaussians(
            p.xyz, st.get_scaling, st.get_rotation, st.get_opacity[:, 0], c,
            cam.viewmatrix, cam.projmatrix, cam.tanfovx, cam.tanfovy, WIDTH,
            HEIGHT, alive=st.alive)
        return torch.autograd.grad(pack_records(splats), p, g_rec,
                                   allow_unused=True)

    img = torch.rand((HEIGHT, WIDTH, 3), device=dev, generator=gen,
                     requires_grad=True)

    def losses_fwd_bwd():
        loss = 0.8 * l1_loss(img, gt) + 0.2 * (1.0 - ssim(img, gt))
        return torch.autograd.grad(loss, img)

    grads = G.GaussianParams(*(1e-3 * torch.randn_like(p)
                               for p in state.params))
    d_grads = [1e-3 * torch.randn_like(p) for p in field.net.parameters()]
    lrs = G.group_learning_rates(opt, 5000, 1.0)

    def adams():
        G.adam_step(state.params, grads, state.opt, lrs, mask=state.alive)
        field.update(dstate, d_grads, 5000)

    densify, _, _ = densify_fns(opt)
    dense_state = dataclasses.replace(
        state, grad_accum=torch.rand(state.capacity, device=dev,
                                     generator=gen) * 2e-3,
        denom=torch.ones(state.capacity, device=dev))
    cpu_gen = torch.Generator().manual_seed(0)

    fwd = B.blend_forward_cuda(records, bins, bg, **grid)
    g_img, g_dep, g_alp = blend_loss_grads(fwd)
    bwd_args = (records, bins, bg, fwd, g_img, g_dep, g_alp)
    t = {
        "train_step_ms": cuda_ms(train_step, 10),
        "deform_mlp_fwd_bwd_ms": cuda_ms(mlp_fwd_bwd, 10),
        "sh_projection_fwd_bwd_ms": cuda_ms(sh_proj_fwd_bwd, 10),
        "losses_fwd_bwd_ms": cuda_ms(losses_fwd_bwd, 10),
        "adams_ms": cuda_ms(adams, 10),
        "densify_ms": cuda_ms(lambda: densify(dense_state, cpu_gen, 20.0,
                                              4.0), 5),
        "blend_bwd_wrapper_ms": cuda_ms(lambda: B.blend_backward_cuda(
            *bwd_args, **grid, depth_grad=False), 50),
        "blend_bwd_plain_ms": cuda_ms(lambda: B.blend_backward_torch(
            *bwd_args, **grid, depth_grad=False), 5, warmup=1),
    }
    t["train_mrays_per_s"] = WIDTH * HEIGHT / t["train_step_ms"] / 1e3
    # the scene the step renders (its own MLP weights, as the timed steps
    # left them): the blend kernels' work there, and the kernels alone
    rec_s, bins_s, _ = stages(state, cam, field, bg)
    fwd_s = B.blend_forward_cuda(rec_s, bins_s, bg, **grid)
    st1 = step(state, dstate, cam, 5000, None, bg)[0]
    g1 = st1.grad_accum[st1.denom > 0]
    t["step_scene"] = {
        "M": int(bins_s.starts[-1]),
        # one step's |dL/dmean2d| (pixels) over the visible Gaussians
        "screen_grad_quantiles_10_50_90_max": [
            float(q) for q in torch.quantile(
                g1, torch.tensor([0.1, 0.5, 0.9, 1.0], device=dev))],
        "visible": int(g1.numel()),
        "nonzero_screen_grad": int((g1 > 0).sum()),
        "pixel_record_pairs": blend_work(rec_s, bins_s, fwd_s, **grid),
        "kernels": blend_kernel_times(rec_s, bins_s, bg, grid)}
    return t, profile(train_step, calls=5)


def row_timings(inp: dict) -> dict:
    """Phase 5, the row kernels at the tools' shapes: each kernel alone
    (launched into a preallocated output) and the library call that
    computes the same function, by the device time torch.profiler reads
    per call (`ms`, `library_ms`) and by CUDA events around back-to-back
    calls (`event_ms`, `library_event_ms`: at ~20 us a call these are
    bound by the host's launch rate, not the device), and the plain version
    (CUDA events); with the bytes each must move (each input read once,
    each output written once; the gather reads only the table rows its
    indices name) and their bound."""
    from d3gs_tpu_torch.ops import rows as R

    def timed(kernel, library, plain, plain_reps=20):
        return {"ms": profile(kernel, calls=50, top=2)["device_ms_per_call"],
                "event_ms": cuda_ms(kernel, 200),
                "library_ms": profile(library, calls=50,
                                      top=2)["device_ms_per_call"],
                "library_event_ms": cuda_ms(library, 200),
                "plain_ms": cuda_ms(plain, plain_reps, warmup=1)}

    (view,) = inp["row_copy"]
    table, idx = inp["row_gather"]
    rows, rank, n1 = inp["scatter_add_rows"]
    rows, rank = rows.reshape(-1, 16), rank.reshape(-1)
    flat_idx = idx.reshape(-1)
    copy_out = torch.empty((view.shape[0] * view.shape[1], 16), device=view.device)
    gather_out = torch.empty((idx.numel(), 16), device=view.device)
    scatter_out = torch.zeros((n1, 16), device=view.device)
    lib_out = torch.zeros((n1, 16), device=view.device)
    t = {
        "row_copy": {
            **timed(lambda: R.launch_row_copy(view, copy_out),
                    lambda: view.contiguous(),
                    lambda: R.row_copy_torch(view)),
            "bytes": 2 * view.numel() * 4},
        "row_gather": {
            **timed(lambda: R.launch_row_gather(table, idx, gather_out),
                    lambda: torch.index_select(table, 0, flat_idx),
                    lambda: R.row_gather_torch(table, idx)),
            "bytes": (int(torch.unique(flat_idx).numel()) * 64
                      + idx.numel() * 4 + idx.numel() * 64)},
        "scatter_add_rows": {
            **timed(lambda: R.launch_scatter_add_rows(rows, rank,
                                                      scatter_out),
                    lambda: lib_out.index_add_(0, rank, rows),
                    lambda: R.scatter_add_rows_torch(rows, rank, n1),
                    plain_reps=5),
            "bytes": rows.numel() * 4 + rank.numel() * 4 + n1 * 16 * 4},
    }
    for name, r in t.items():
        # the scatter's additions (16 per row) are far below the byte time
        flops = rows.numel() if name == "scatter_add_rows" else 0
        r["bound_ms"], r["bound_by"] = roofline(r["bytes"], flops, 0)
    return t


def flagship_timings(dev, state, bg) -> tuple[dict, dict]:
    """Phase 5, flagship side, at the bench shape with every SH band
    active: one ODE flagship step (the 8x256 Blender ODE field, rk4 with 4
    substeps, k = 10 cameras with fids 0..1) and its layers (the ODE
    integral forward, and forward + backward; the k renders forward +
    backward; the k losses forward + backward; both Adams), one MLP-kind
    flagship step at k = 10 (CUDA events), the peak device memory of the
    ODE step, and torch.profiler over ODE steps and over the integral
    alone (the ODE's share of device time)."""
    import dataclasses
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.models import gaussians as G
    from d3gs_tpu_torch.models.deform.fields import create_deform_field
    from d3gs_tpu_torch.models.renderer import render
    from d3gs_tpu_torch.ops.losses import l1_loss, ssim
    from d3gs_tpu_torch.train.flagship import (make_batched_step,
                                               pick_field_spec)
    k = FLAGSHIP_K
    gen = torch.Generator(device=dev).manual_seed(3)
    cams = [dataclasses.replace(
        look_from_z(4.0, WIDTH, dev, fid=i / (k - 1)),
        image=torch.rand((HEIGHT, WIDTH, 3), device=dev, generator=gen))
        for i in range(k)]
    fids = [c.fid for c in cams]
    opt, pipe = C.OptimizationParams(num_cams_per_iter=k), C.PipelineParams()
    out = {}
    for kind in ("mlp", "ode"):
        model = C.ModelParams(is_blender=True, is_ode=kind == "ode", D=8,
                              W=256, sh_degree=3)
        field = create_deform_field(pick_field_spec(model, opt), seed=4,
                                    device=dev, opt_cfg=opt)
        dstate = field.init_state()
        step = make_batched_step(opt_cfg=opt, pipe_cfg=pipe,
                                 model_cfg=model, field=field,
                                 update_gaussians=True, update_deform=True,
                                 use_deform=True)
        run = lambda: step(state, dstate, cams, 5000, bg)  # noqa: E731
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(run, 3, warmup=1)
        out[f"{kind}_step_ms"] = ms
        out[f"{kind}_step_ms_per_camera"] = ms / k
        out[f"{kind}_peak_memory_gb"] = torch.cuda.max_memory_allocated(
            dev) / 1e9
    # the ODE step's layers (field, step, run: the ODE kind's, last above)
    params = list(field.net.parameters())
    xyz = state.params.xyz
    cot = torch.randn((k, xyz.shape[0], 3), device=dev, generator=gen)

    def ode_fwd():
        with torch.no_grad():
            return field.step_multi(xyz, fids, y0=xyz)

    def ode_fwd_bwd():
        ys = field.step_multi(xyz, fids, y0=xyz)[0]
        return torch.autograd.grad(ys, params, cot)

    with torch.no_grad():
        means = field.step_multi(xyz, fids, y0=xyz)[0]

    def renders_fwd_bwd():
        p = G.GaussianParams(*(x.detach().requires_grad_()
                               for x in state.params))
        st = dataclasses.replace(state, params=p)
        tap = torch.zeros((state.capacity, 2), device=dev,
                          requires_grad=True)
        total = sum((render(st, c, d_xyz=means[i], direct_compute=True, bg=bg,
                            means2d_tap=tap, depth_grad=False).image
                     * cams[(i + 1) % k].image).sum()
                    for i, c in enumerate(cams))
        return torch.autograd.grad(total, [*p, tap], allow_unused=True)

    imgs = [torch.rand((HEIGHT, WIDTH, 3), device=dev, generator=gen,
                       requires_grad=True) for _ in range(k)]

    def losses_fwd_bwd():
        loss = sum(0.8 * l1_loss(im, c.image) + 0.2 * (1 - ssim(im, c.image))
                   for im, c in zip(imgs, cams)) / k
        return torch.autograd.grad(loss, imgs)

    grads = G.GaussianParams(*(1e-3 * torch.randn_like(p)
                               for p in state.params))
    d_grads = [1e-3 * torch.randn_like(p) for p in params]
    lrs = G.group_learning_rates(opt, 5000, 1.0)

    def adams():
        G.adam_step(state.params, grads, state.opt, lrs, mask=state.alive)
        field.update(dstate, d_grads, 5000)

    out.update({
        "ode_integral_fwd_ms": cuda_ms(ode_fwd, 3, warmup=1),
        "ode_integral_fwd_bwd_ms": cuda_ms(ode_fwd_bwd, 3, warmup=1),
        "k_renders_fwd_bwd_ms": cuda_ms(renders_fwd_bwd, 3, warmup=1),
        "k_losses_fwd_bwd_ms": cuda_ms(losses_fwd_bwd, 3, warmup=1),
        "adams_ms": cuda_ms(adams, 5),
        "k": k, "gaussians": N_BENCH, "size": f"{WIDTH}x{HEIGHT}",
        "ode_evaluations_per_step": (k - 1) * 4 * 4})
    prof = profile(run, calls=2)
    ode_prof = profile(ode_fwd_bwd, calls=2, top=4)
    out["ode_share_of_device_time"] = (ode_prof["device_ms_per_call"]
                                       / prof["device_ms_per_call"])
    out["ode_integral_profile"] = ode_prof
    return out, prof


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] nvidia-smi: {smi}")
    log(f"[1] torch {torch.__version__} CUDA {torch.version.cuda}, "
        f"device 0: {kind}, {torch.cuda.device_count()} visible")

    import d3gs_tpu_torch  # noqa: F401  (sets the TF32 flags)
    log(f"[1] TF32: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("TF32 must stay off (SSIM, the deform MLP)")
    from d3gs_tpu_torch.models.deform.fields import (DeformFieldSpec,
                                                     create_deform_field)
    from d3gs_tpu_torch.models.gaussians import gaussians_from_numpy
    from d3gs_tpu_torch.ops import _build

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    release = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    release = [ln for ln in release.splitlines() if "release" in ln]
    log(f"[2] built {_build.sources()} in {time.perf_counter() - t0:.1f} s "
        f"by {release[-1] if release else 'nvcc'}")
    for name, text in logs.items():
        for line in text.strip().splitlines():
            log(f"[2] {name}: {line}")
    loops = {k: sass_loops(str(_build.library_path(k)))
             for k in ("blend_fwd", "blend_bwd")}
    for k, lps in loops.items():
        for lp in lps:
            log(f"[2] {k} SASS loop: {json.dumps(lp)}")

    # ---- 3. kernels vs plain --------------------------------------------
    params, alive = bench_params(dev)
    state = gaussians_from_numpy(params, alive, 3, 3, dev)
    cam = look_from_z(4.0, WIDTH, dev)
    field = create_deform_field(DeformFieldSpec(kind="baseline",
                                                is_blender=True), device=dev)
    bg = torch.zeros(3, device=dev)
    records, bins, grid = stages(state, cam, field, bg)
    check_cull(dev)
    check_log1p(dev)
    bench = f"bench scene {N_BENCH} @ {WIDTH}x{HEIGHT}"
    bench_err = compare_blend(bench, records, bins, bg, grid)
    bench_bwd_err = compare_blend_bwd(bench, records, bins, bg, grid,
                                      BWD_TOL["bench"])
    small = dict(tiles_x=4, tiles_y=4, width=64, height=64)
    for name, st, z, dup, bgs in small_scenes(dev):
        rec_s, bins_s, _ = stages(st, look_from_z(z, 64, dev), None, bgs, dup)
        compare_blend(name, rec_s, bins_s, bgs, small)
        compare_blend_bwd(name, rec_s, bins_s, bgs, small, BWD_TOL[name])
    # the per-warp design's edges: ~30 chunks of one strip's walk, and
    # ellipses that end on the boundaries of its cull
    bg1 = torch.tensor([0.1, 0.2, 0.3], device=dev)
    edges = [("deep", *stages(deep_scene(dev), look_from_z(4.0, 64, dev),
                              None, bg1)[:2]),
             ("warp_edge", *warp_edge_scene(dev))]
    for name, rec_s, bins_s in edges:
        compare_blend(name, rec_s, bins_s, bg1, small)
        compare_blend_bwd(name, rec_s, bins_s, bg1, small, BWD_TOL[name])
    # ---- 3c. the row kernels vs plain at the tools' shapes ---------------
    rows_in = row_inputs(dev)
    row_errs = compare_rows(rows_in)

    with tempfile.TemporaryDirectory(prefix="d3gs_smoke_") as tmp:
        # ---- 4. main path: render ---------------------------------------
        data = os.path.join(tmp, "data")
        write_dnerf_dataset(data, size=WIDTH)
        render_result = render_main_path(dev, data, os.path.join(tmp,
                                                                 "model"))
        # ---- 4b. main path: train ---------------------------------------
        train_launches = train_main_path(dev, data,
                                         os.path.join(tmp, "trained"))
        # ---- 4c. the three tool paths -----------------------------------
        tool_launches = tool_paths()
        # ---- 4d. main path: the flagship ODE trainer --------------------
        data_f = os.path.join(tmp, "data_flagship")
        write_dnerf_dataset(data_f, *FLAGSHIP_VIEWS, size=WIDTH)
        launches = flagship_main_path(dev, data_f,
                                      os.path.join(tmp, "flagship"))
    log(f"[4] kernel launches by path: render {render_result['launches']}, "
        f"train {train_launches}, tools {tool_launches}, flagship "
        f"{launches}")

    # ---- 5. timings at the bench shape ------------------------------------
    t, prof, work = render_timings(state, field, cam, bg, records, bins,
                                   grid)
    t["cli_benchmark_fps"] = render_result["benchmark"]["fps"]
    t["card"] = smi
    log("[5] " + json.dumps(t))
    log("[5] profile of one frame: " + json.dumps(prof))
    tt, tprof = train_timings(dev, state, cam, bg, records, bins, grid)
    tt["card"] = smi
    log("[5] train step: " + json.dumps(tt))
    log("[5] profile of one train step: " + json.dumps(tprof))
    rt = row_timings(rows_in)
    log("[5] row kernels at the tools' shapes: " + json.dumps(rt))
    ft, fprof = flagship_timings(dev, state, bg)
    ft["card"] = smi
    log("[5] flagship steps: " + json.dumps(ft))
    log("[5] profile of one flagship ODE step: " + json.dumps(fprof))

    bounds = blend_bounds(records, bins, grid, work)
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = (
        bounds["new"]["blend_fwd"], bounds["new"]["blend_bwd"])
    log(f"[6] bounds on the bench scene (ms, what bounds it): {bounds} "
        f"from the pairs {work}")
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "d3gs_tpu_torch", "csrc")
    models = {k: issue_model(os.path.join(csrc, f"{k}.cu"), loops[k],
                             work[f"{k[6:]}_visits"])
              for k in ("blend_fwd", "blend_bwd")}
    log(f"[6] issue-rate model on the bench scene: {json.dumps(models)}")
    kb = t["kernels"]
    kernels = [{
        "name": "blend_fwd", "route": "cuda",
        "source": "d3gs_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "d3gs_tpu/ops/pallas_blend.py:188",
        "launches": launches["blend_fwd"], "max_abs_err": bench_err,
        "ms": kb["blend_fwd_ms"], "plain_ms": t["blend_plain_ms"],
        "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None,
    }, {
        "name": "blend_bwd", "route": "cuda",
        "source": "d3gs_tpu_torch/csrc/blend_bwd.cu",
        "replaces": "d3gs_tpu/ops/pallas_blend.py:277",
        "launches": launches["blend_bwd"], "max_abs_err": bench_bwd_err,
        "ms": kb["blend_bwd_ms"], "plain_ms": tt["blend_bwd_plain_ms"],
        "bound_ms": bwd_bound, "bound_by": bwd_by, "library_ms": None,
    }] + [{
        "name": name, "route": "cuda",
        "source": f"d3gs_tpu_torch/csrc/{name}.cu", "replaces": replaces,
        "launches": tool_launches[name], "max_abs_err": row_errs[name],
        "ms": rt[name]["ms"], "plain_ms": rt[name]["plain_ms"],
        "bound_ms": rt[name]["bound_ms"], "bound_by": rt[name]["bound_by"],
        "library_ms": rt[name]["library_ms"],
    } for name, replaces in (("row_copy", "tools/exp_r5_reduce.py:146"),
                             ("row_gather", "tools/exp_vmem_gather.py:33"),
                             ("scatter_add_rows",
                              "tools/exp_vmem_scatter.py:31"))]
    log(f"[6] done in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
