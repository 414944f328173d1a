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
     library's log1pf on every f32 alpha in (0, 0.99]; the forward
     kernel against `blend_forward_torch` on those 12,000 edge records,
     each alone in its own scene, counting the pixels whose include
     decision differs and how far (in ulp) their alpha is from 1/255,
     at most EDGE_FLIPS_ALLOWED (0), and for the check's control, a copy
     of the forward with `gauss_power` left to nvcc's contraction (built
     beside the kernels in phase 2), at least one; then the blend
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
     scatter-add within 1e-5 of the largest |sum|; (3d) the fused RK4 step
     of the 8x256 ODE field (csrc/ode_rk4.cu) at trex's 78,624 points
     against its plain version and `_rk4_step`, after one step and after
     the viewer's 8-step integral from 0 to 0.73 (within 1e-5), and a
     3-substep forward and backward against the checkpointed path, each
     gradient's gap held to a control's (the checkpointed path with its
     input moved one ulp); the backward kernel (csrc/ode_rk4_bwd.cu) of
     one step against its plain version, held to the same kind of
     control, and twice on one input, bit for bit; (3e) the fused
     deformation MLP (csrc/mlp_field.cu) at the real-scene cell's 400,000
     points and at a ragged count, its forward against the plain version
     (and bit for bit with and without the backward's scratch, run to
     run), its VJP and DeformMLP under autograd held to a control as in
     3d, and the real-scene train step launching both kernels a step;
  4. the main paths, each with the kernels' counts set to 0 just before it
     and read just after:
     4.  render: a D-NeRF-format dataset (bench.py's scene moving by
         t·MOTION, through the plain blend) and a model directory at the
         bench scale, rendered through `d3gs_tpu_torch.render.main([...
         "--mode", "render", "--benchmark"])`;
     4b. train: `d3gs_tpu_torch.train.__main__.main` on that dataset with
         bench.py's point cloud, 1000 iterations through warm-up, deform
         steps, three densify passes, an opacity reset at 500 and the
         large-screen prune at 750, the SH ramp at 1000, PSNR evaluations
         and a checkpoint, which `render.main` then renders; the losses
         must fall and the PSNRs reach their floors;
     4c. the three tools (`d3gs_tpu_torch.tools.exp_r5_reduce`,
         `exp_vmem_gather`, `exp_vmem_scatter`) through their main();
     4d. flagship: the train CLI with `--trainer flagship --is_ode` (the
         8x256 ODE field, k = 10 cameras) on a 12-view set with bench.py's
         point cloud, 10 iterations through warm-up, the alternating
         switch, a densify pass, an evaluation and a checkpoint, rendered
         through `render.main` and held against the plain blend;
     4e. the same trainer with `--ode_solver adaptive` (Dopri5 with
         adjoint gradients, rtol 1e-3 / atol 1e-4), 6 iterations, k = 10,
         its checkpoint rendered and held against the plain blend, with
         the solver's steps, evaluations and host reads;
     4f. the same with `--use_torch_ode` (simple_start), 4 iterations;
     4g. distillation: `d3gs_tpu_torch.train_synth_gau` with 4b's
         checkpoint as the teacher and the 8x256 ODE student (adaptive),
         5 iterations, a bounded trajectory loss and a PSNR evaluation;
     4h. the synthetic-ODE CLIs (60 of the default 500 training
         iterations), then `step_multi` on
         (16, 10) per-sample grids (simple_start, adaptive, a duplicate
         time, a parameter gradient) on the card against the CPU;
     4i. the baseline CLI with `--deform_dtype bfloat16`, 10 iterations
         and a render of its checkpoint, and `tools/exp_r5_mlp` (the MLP's
         time in float32 and bfloat16);
     4j. evaluation on 4b's checkpoint: `render.main` in the five
         interpolation modes (time, view, pose, all, original) at their
         default frame counts, one frame each held against the plain blend,
         `--trajectories`, `metrics.main` without and with (random) LPIPS
         weights held against the CPU's metrics on the same PNGs,
         `full_eval.main` on one scene (200 iterations), and the camera
         resize against `data/resize.py`;
     4k. the side trainers and tools: (a) `train_baseline_sam.main` on a
         copy of 4b's set at full width with SLIC label maps (64 masks),
         260 iterations (211 deform steps) with the regularizer watched,
         one step with the mask term card against CPU, and
         `train_baseline` with a recording tb_writer and a live_hook;
         (b) `forecast.main` at its defaults on 4j's trajectories for one
         epoch, the training step and the rollout timed, a forward card
         against CPU; (c) `ode_demo.main` (spiral, sine3d) at 20
         iterations; (d) `train_gui --view_only --no_gui` on 4b's
         checkpoint and its training route (50 iterations) in
         subprocesses, frames taken by a loopback client, each ended by
         SIGINT with exit code 0, and `GUI.test_step` against the plain
         blend; (e) `train_loops.main` on 4d's set, sequence lengths 6 and
         12;
     4l. multi-GPU (`d3gs_tpu_torch/parallel/`) on the one card: (a) the
         bench frame cut into 2 and 4 strips of tile rows, both blend
         kernels on each strip at its tile_y0 against their plain versions,
         the strips against the whole frame; (b) `torchrun --standalone
         --nproc_per_node 1 -m d3gs_tpu_torch.train --trainer flagship
         --is_ode --mesh_shape 1` in both layouts on 4d's set (NCCL, 6
         iterations, a densify pass, an evaluation, a checkpoint and its
         render), the first loss held to 4d's; (c) ranks sharing the card
         over gloo (torch.multiprocessing, a FileStore): the sharded
         render at D = 4, a camera-parallel step at D = 2, gauss+tile
         steps at D = 4 and 2 x 2, each against the single-device step,
         with the collectives' bytes per step; (d) the world-size-1
         camera and gauss+tile steps timed beside the single-device step;
     4m. (a) every JPEG of tests/torch_port_jpeg/ decoded on the host,
         bit-equal to its committed PNG of Pillow's decode; (b) the
         committed six-view COLMAP JPEG set loaded and trained by the
         baseline CLI for 50 iterations; (c) PointTransformerV3 at the
         defaults on 4b's checkpoint, card against CPU;
     4n. (a) the JPEG encoder on render_420.png's pixels, byte-equal to
         the committed Pillow encode, in ms per megapixel; (b)
         `convert.main([... "--skip_matching", "--resize"])` with a fake
         `colmap` on the COLMAP JPEG set (18 pyramid JPEGs byte-equal to
         Pillow's) and on an RGBA PNG set (9 PNGs pixel-equal); (c) 4b's
         set rewritten as 16-bit RGBA frames, half of them Adam7, loaded
         equal to the 8-bit set and trained by the baseline CLI for 50
         iterations with the blend launches counted;
     4o. `d3gs_tpu_torch.bench.main([])` in-process at bench.py's
         configuration (train step, render, flagship step at k = 10), the
         blend launches counted, its JSON line printed and checked (every
         key of bench.py's line positive, dup_total under the budget);
     4p. tight_cull: (a) the bench frame and 4b's checkpoint rendered with
         and without the cull, M each way, images and gradients held to
         each other (flipped pixels counted, none allowed), both blend
         kernels alone on the culled bins against their plain versions and
         timed beside the uncut bins; (b) the bench frame in 2 and 4 culled
         strips (`parallel/sharded.py::blend_strip`) against the whole
         frame; (c) the baseline CLI with `--tight_cull` for 50 iterations
         on 4b's set, the launches counted and every binning watched;
  5. timings at the bench shape (CUDA events, torch.profiler): the render
     stages and the frame, the train step and its layers, both blend
     kernels alone (CUDA events and profiler device time) on the bench
     scene and on the train step's own scene, through their wrappers and
     in their plain versions; the row kernels alone beside their library
     calls and plain versions; the fused RK4 step beside its f32 bound,
     its plain version and `_rk4_step`, and its backward kernels beside
     theirs (three steps' f32 FLOPs), their plain version and `_rk4_step`
     again under autograd; one ODE flagship step at k = 10 and its
     layers, one MLP-kind flagship step, one adaptive ODE flagship step
     with its solver counts, integral and device times;
  6. the card, the blend bounds (from the pixel-record pairs each kernel
     evaluates on the bench scene, counted by `blend_work`, under this
     source's count and without the cull) and the issue-rate model (SASS
     instructions per visit times visits over 4 per clock on 132 SMs), one
     JSON line of the kernels (the blend kernels' and the fused RK4
     step's and its backward's launches from the flagship path, the row
     kernels' from their tools' paths; the row bounds from the bytes each
     must move, the RK4 step's and its backward's from their f32 FLOPs),
     and the final status line.
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
TRAIN_ITERATIONS = 1000          # the training main path's steps: the
#                                  SH ramp comes every 1000 (not a flag)
# 4b's host events: densify passes at 250, 500 and 750, the opacity reset
# at 500, so that the pass at 750 applies the large-screen prune and 250
# steps follow it
TRAIN_DENSIFY_INTERVAL, TRAIN_DENSIFY_UNTIL = 250, 751
TRAIN_RESET_INTERVAL = 500
MOTION = (0.3, 0.1, 0.0)         # the datasets' scene moves by t·MOTION
# 4b: the mean test PSNR at the end, and each checkpoint render's PSNR
# against its view, at least these (dB). Seven runs read 26.1-28.9 and
# 17.8-44.6 (the lowest: test view 1, at t = 1 from the pose of a t = 2/3
# train view); the first evaluation 15.1, a black render 6.6-7.8
TRAIN_PSNR_FLOOR, VIEW_PSNR_FLOOR = 20.0, 15.0
# 4g: the teacher's trajectories over a window depart from their start by
# about |t·MOTION| <= 0.3 per coordinate, and a student at rest is that far
# off: its L1 loss stays below twice that (the run from a diverged teacher
# read 2,832)
DISTILL_LOSS_BOUND = 2 * max(abs(m) for m in MOTION)
FLAGSHIP_ITERATIONS = 10         # the flagship main path's steps
FLAGSHIP_K = 10                  # cameras per flagship step
FLAGSHIP_VIEWS = (12, 2)         # train / test views of its dataset
ADAPTIVE_ITERATIONS = 6          # 4e: adaptive ODE flagship (3 warm-up)
SIMPLE_START_ITERATIONS = 4      # 4f: adaptive simple_start (2 warm-up)
DISTILL_ITERATIONS = 5           # 4g: distillation steps
BF16_ITERATIONS = 10             # 4i: the baseline CLI in bf16
SYNTH_GRID = (16, 10)            # 4h: per-sample (N, T) grids
# 4h: train_synth_ode's iterations, cut from its default 500 (167-225 s,
# host-bound) to make room for 4l within the call's time limit
SYNTH_ITERATIONS = 60
ADAPTIVE_TOL = (1e-3, 1e-4)      # rtol, atol of the adaptive paths
# 4h: card against CPU at rtol 1e-5 / atol 1e-7, within 2e-3 of the
# largest value and gradient (tests/test_torch_port_ode_adaptive.py holds
# the CPU against JAX there to 2e-3)
SYNTH_CHECK_TOL, SYNTH_CHECK_ERR = (1e-5, 1e-7), 2e-3
EDGE_SCENES = 16                 # phase 3 flips: 16x16 scenes per launch


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print msg after the seconds since the script started."""
    print(f"{time.perf_counter() - _T0:7.1f}s {msg}", flush=True)


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
    from d3gs_tpu_torch.tools.exp_empty_views import bench_points as points
    return points(N_BENCH)


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
    from d3gs_tpu_torch.ops.rasterize import pack_records
    splats = stage_splats(state, cam, field)
    tiles_x, tiles_y = (cam.width + 15) // 16, (cam.height + 15) // 16
    bins = bin_splats_records(splats, tiles_x=tiles_x, tiles_y=tiles_y,
                              dup_capacity=dup)
    grid = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=cam.width,
                height=cam.height)
    return pack_records(splats), bins, grid


@torch.no_grad()
def stage_splats(state, cam, field):
    """`stages` up to the projection: -> ProjectedSplats."""
    from d3gs_tpu_torch.ops.projection import project_gaussians
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
    return project_gaussians(
        xyz, state.get_scaling + d_sc, state.get_rotation + d_rot,
        state.get_opacity[:, 0], colors, cam.viewmatrix, cam.projmatrix,
        cam.tanfovx, cam.tanfovy, cam.width, cam.height, alive=state.alive)


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
    # off the edge by at least 0.02 px either way (`check_cull` probes the
    # cull within 1e-3 px of the edges against the kernels' own alpha, and
    # `edge_flips` the forward's include decision there against the plain
    # version's)
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

def profile(fn, calls: int = 10, top: int = 12, cpu: bool = True) -> dict:
    """torch.profiler over `calls` calls of fn: wall time, device kernel
    time and the device's busy share per call, and the kernels by device
    time. cpu=False traces the device alone: for calls of ~10^5 kernels,
    whose host-side trace takes minutes to reduce."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with tprofile(activities=acts) as prof:
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


# gauss_power as the kernels evaluate it (csrc/blend_common.cuh: every
# rounding pinned to the plain version's order), and as nvcc compiles the
# same expression unpinned, contracting the products into fused
# multiply-adds (the kernels before ROADMAP Queue 3's check)
PINNED_POWER = ("return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn("
                "__fmul_rn(__fmul_rn(q0.z, dx), dx),\n"
                "                                              "
                "__fmul_rn(__fmul_rn(q1.x, dy), dy))),\n"
                "                   __fmul_rn(__fmul_rn(q0.w, dx), dy));")
CONTRACTED_POWER = ("return -0.5f * (q0.z * dx * dx + q1.x * dy * dy) "
                    "- q0.w * dx * dy;")
# include decisions of the shipped forward that may differ from the plain
# version's on the 12,000 edge records (phase 3): none, with gauss_power
# pinned. The contracted copy is the check's control: it must differ (it
# differed on 117 pixels, up to 42,355 ulp of 1/255 away), or the records
# no longer reach the threshold closely enough to tell the two apart.
EDGE_FLIPS_ALLOWED = 0


def start_contracted_build():
    """Phase 2: start nvcc on a copy of csrc/blend_fwd.cu whose
    `gauss_power` (csrc/blend_common.cuh) is left to nvcc's contraction;
    -> (process, library path). Built into build/contracted/ beside the
    port's kernels, with the same flags."""
    import shutil
    from d3gs_tpu_torch.ops import _build
    out = _build.BUILD_DIR / "contracted"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "blend_fwd.cu", out / "blend_fwd.cu")
    header = (_build.CSRC / "blend_common.cuh").read_text()
    if PINNED_POWER not in header:
        raise AssertionError("gauss_power changed: update PINNED_POWER")
    (out / "blend_common.cuh").write_text(
        header.replace(PINNED_POWER, CONTRACTED_POWER))
    lib = out / "libblend_fwd_contracted.so"
    proc = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
         str(out / "blend_fwd.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, lib


def finish_contracted_build(proc, lib):
    """The contracted forward's C entry (as `ops/blend.py` binds the
    shipped one); raises if nvcc failed."""
    import ctypes
    from d3gs_tpu_torch.ops import blend as B
    text = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the contracted forward:\n{text}")
    fn = ctypes.CDLL(str(lib)).d3gs_blend_fwd
    fn.argtypes, fn.restype = B._FWD_ARGTYPES, ctypes.c_int
    return fn


def forward_with(fn, records, gid, starts, bg, *, tiles_x, tiles_y, width,
                 height, out=None, tile_y0=0):
    """One launch of a forward kernel's C entry `fn`, into `out` or fresh
    outputs."""
    from d3gs_tpu_torch.ops import blend as B
    dev = records.device
    empty = lambda *shape, dt=torch.float32: torch.empty(  # noqa: E731
        shape, dtype=dt, device=dev)
    if out is None:
        out = B.BlendOutput(
            image=empty(height, width, 3), depth=empty(height, width),
            alpha=empty(height, width), t_final=empty(height, width),
            log_t=empty(height, width),
            n_walked=empty(height, width, dt=torch.int32),
            last_contrib=empty(height, width, dt=torch.int32))
    err = fn(records.data_ptr(), records.stride(0), gid.data_ptr(),
             starts.data_ptr(), bg.data_ptr(), tiles_x, tiles_y, width,
             height, tile_y0, out.image.data_ptr(), out.depth.data_ptr(),
             out.alpha.data_ptr(), out.t_final.data_ptr(),
             out.log_t.data_ptr(), out.n_walked.data_ptr(),
             out.last_contrib.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"forward launch failed: cudaError {err}")
    return out


def isolated_scenes(rec: np.ndarray, dev, per: int = EDGE_SCENES):
    """The records of `rec`, each alone in its own 64x64 scene: per x per
    scenes a launch, record b moved by 64·(b % per, b // per) px in float32
    (at most 1024 px, so its edge moves by <= 6e-5 px) and listed in its
    scene's 16 tiles only. Yields (records, bins, gid, grid, origin of each
    record's scene)."""
    from d3gs_tpu_torch.ops.binning import RecordBins
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32),  # noqa: E731
                                    device=dev)
    tiles_x = 4 * per
    tiles = np.arange(tiles_x * tiles_x)
    owner = (tiles // tiles_x // 4) * per + (tiles % tiles_x) // 4
    for c0 in range(0, rec.shape[0], per * per):
        r = rec[c0:c0 + per * per].copy()
        m = r.shape[0]
        b = np.arange(m)
        origin = np.stack([64 * (b % per), 64 * (b // per)], -1)
        r[:, :2] += origin.astype(np.float32)
        live = owner < m
        gid = i32(owner[live])
        starts = np.concatenate([[0], np.cumsum(live)])
        bins = RecordBins(rank_sorted=gid, starts=i32(starts),
                          counts=i32(live), order=i32(np.arange(m)),
                          rank_bounds=i32(np.arange(m + 1)))
        grid = dict(tiles_x=tiles_x, tiles_y=tiles_x, width=64 * tiles_x // 4,
                    height=64 * tiles_x // 4)
        yield (torch.from_numpy(r).to(dev), bins, gid, grid, origin)


def edge_flips(dev, contracted_fn) -> dict:
    """Phase 3, ROADMAP Queue 3: the forward kernel against
    `blend_forward_torch` on the 12,000 records of `cull_edge_records`
    (seeds 0-2), each alone in its scene so that a pixel's last_contrib is
    the include decision of that one record. Counts the pixels whose
    decision differs, and for each the plain version's float32 alpha
    opa·e^power in ulp of 1/255 away from it; the same for the copy with
    `gauss_power` contracted. Raises if the shipped forward differs on
    more than EDGE_FLIPS_ALLOWED pixels, or the contracted control on
    none."""
    from d3gs_tpu_torch.ops import _build
    from d3gs_tpu_torch.ops import blend as B
    shipped = _build.entry("blend_fwd", B._FWD_ARGTYPES)
    rec_all = np.concatenate([cull_edge_records(seed) for seed in range(3)])
    bg = torch.zeros(3, device=dev)
    alpha_min = float(np.float32(1.0 / 255.0))
    ulp = 2.0 ** -31                    # of f32 values in [2^-8, 2^-7)
    out = {"records": int(rec_all.shape[0]), "pixels": 0}
    flips = {"shipped": [], "contracted": []}
    for recs, bins, gid, grid, origin in isolated_scenes(rec_all, dev):
        ref = B.blend_forward_torch(recs, bins, bg, **grid,
                                    tile_chunk=grid["tiles_x"] ** 2)
        out["pixels"] += int((ref.last_contrib > 0).sum())
        for name, fn in (("shipped", shipped), ("contracted", contracted_fn)):
            got = forward_with(fn, recs, gid, bins.starts, bg, **grid)
            diff = (got.last_contrib > 0) != (ref.last_contrib > 0)
            ys, xs = torch.nonzero(diff, as_tuple=True)
            if ys.numel() == 0:
                continue
            per = EDGE_SCENES
            b = (ys // 64) * per + xs // 64
            r = recs[b]
            dx = r[:, 0] - xs.float()
            dy = r[:, 1] - ys.float()
            power = (-0.5 * (r[:, 2] * dx * dx + r[:, 4] * dy * dy)
                     - r[:, 3] * dx * dy)
            raw = r[:, 8] * torch.exp(power)
            kernel_in = got.last_contrib[ys, xs] > 0
            for a, k in zip(raw.tolist(), kernel_in.tolist()):
                flips[name].append({"ulp": abs(a - alpha_min) / ulp,
                                    "kernel_includes": bool(k)})
    for name, fl in flips.items():
        out[name] = {"flips": len(fl),
                     "max_ulp": max((f["ulp"] for f in fl), default=0.0),
                     "kernel_includes": sum(f["kernel_includes"] for f in fl),
                     "ulp_each": sorted(round(f["ulp"], 2) for f in fl)}
    log(f"[3] edge flips, forward kernel vs plain on {out['records']} edge "
        f"records each alone ({out['pixels']} included pixels by the plain "
        f"version): {json.dumps(out)} (allowed for the shipped forward: "
        f"{EDGE_FLIPS_ALLOWED})")
    if out["shipped"]["flips"] > EDGE_FLIPS_ALLOWED:
        raise AssertionError(f"the forward's include decision differs from "
                             f"the plain version's on {out['shipped']}")
    if out["contracted"]["flips"] == 0:
        raise AssertionError("the contracted control flips no pixel: the "
                             "edge records no longer test the roundings")
    return out


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


def write_dnerf_dataset(root: str, dev, n_train=4, n_test=2, size=WIDTH):
    """D-NeRF layout: transforms_{train,test}.json + RGBA PNGs, cameras on a
    radius-4 orbit looking at the origin, `time` spread over [0, 1]. Each
    image shows bench.py's scene (`bench_params`) translated by t·MOTION at
    the view's time t, through the plain blend on a black background, from
    the camera the port's reader makes of the view's pose: a scene that a
    deform field can fit."""
    import dataclasses
    from d3gs_tpu_torch.data.cameras import camera_from_info
    from d3gs_tpu_torch.data.dataset_readers import \
        read_cameras_from_transforms
    from d3gs_tpu_torch.data.image_io import write_png
    from d3gs_tpu_torch.models.gaussians import gaussians_from_numpy
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.tools.exp_empty_views import orbit_c2w
    state = gaussians_from_numpy(*bench_params(dev), 3, 3, dev)
    motion = torch.tensor(MOTION, device=dev)
    bg = torch.zeros(3, device=dev)

    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for k in range(n):
            # a placeholder until the reader has made the view's camera
            write_png(os.path.join(root, split, f"r_{k:03d}.png"),
                      np.zeros((size, size, 4), np.uint8))
            frames.append({"file_path": f"./{split}/r_{k:03d}",
                           "time": k / max(n - 1, 1),
                           "transform_matrix": orbit_c2w(
                               k * 2 * math.pi / n + 0.3).tolist()})
        name = f"transforms_{split}.json"
        with open(os.path.join(root, name), "w") as f:
            json.dump({"camera_angle_x": math.radians(60), "frames": frames},
                      f)
        for k, info in enumerate(read_cameras_from_transforms(root, name,
                                                              False)):
            cam = camera_from_info(info, device=dev)
            moved = dataclasses.replace(state, params=state.params._replace(
                xyz=state.params.xyz + cam.fid * motion))
            img = B.blend_forward_torch(*stages(moved, cam, None, bg)[:2], bg,
                                        tiles_x=(size + 15) // 16,
                                        tiles_y=(size + 15) // 16,
                                        width=size, height=size).image
            rgb = (255 * img.clamp(0, 1)).round().to(torch.uint8).cpu()
            write_png(os.path.join(root, split, f"r_{k:03d}.png"),
                      np.concatenate([rgb.numpy(), np.full(
                          (size, size, 1), 255, np.uint8)], -1))


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
    plain blend. The deformation MLP (the 8x256 Blender field, at each
    frame's host time and without autograd) must run its forward kernel
    once a frame."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch import render as R
    from d3gs_tpu_torch.data.image_io import read_png
    from d3gs_tpu_torch.data.scene import Scene, save_gaussians_ply
    from d3gs_tpu_torch.models.deform.fields import (
        DeformFieldSpec, create_deform_field, load_deform_weights,
        save_deform_weights)
    from d3gs_tpu_torch.models.gaussians import gaussians_from_numpy
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.ops import mlp_field as M
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
    reset_counts()
    t0 = time.perf_counter()
    result = R.main(["-m", mp, "--mode", "render", "--benchmark"])
    torch.cuda.synchronize()
    launches = {"blend_fwd": B.launch_counts()["blend_fwd"],
                **M.launch_counts()}
    result["launches"] = launches
    log(f"[4] render.main: {result} in {time.perf_counter() - t0:.1f} s; "
        f"kernel launches {launches}")
    frames = result["views"] + result["benchmark"]["frames"]
    for kernel in ("blend_fwd", "mlp_field"):
        if launches[kernel] < frames:
            raise AssertionError(f"{kernel} launched {launches[kernel]} "
                                 f"times for {frames} frames")
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


class WatchHostEvents:
    """Counts, while active, the baseline loop's host events that leave no
    trace in its result: each opacity reset (and the largest opacity of a
    live Gaussian after it) and each densify pass's removals by rule, read
    from `gaussians.pruned` around the pass (with its max_screen_size)."""

    def __enter__(self):
        from d3gs_tpu_torch.models import gaussians as G
        self.G, self.resets, self.prunes = G, [], []
        self.reset0, self.densify0 = G.reset_opacity, G.densify_and_prune

        def reset(state):
            out = self.reset0(state)
            self.resets.append(float(out.get_opacity[out.alive].max()))
            return out

        def densify(state, **kw):
            before = dict(G.pruned)
            out = self.densify0(state, **kw)
            self.prunes.append((kw["max_screen_size"], {
                k: G.pruned[k] - before[k] for k in before}))
            return out
        G.reset_opacity, G.densify_and_prune = reset, densify
        return self

    def __exit__(self, *exc):
        self.G.reset_opacity = self.reset0
        self.G.densify_and_prune = self.densify0


def train_main_path(dev, data, mp) -> dict:
    """Phase 4b: `python -m d3gs_tpu_torch.train` in-process at the bench
    width (bench.py's 43,132 points as the dataset's point cloud, 400x400,
    SH 3, the 8x256 Blender MLP), with flags that reach every branch of
    the loop: warm-up then deform steps, densify passes at a threshold low
    enough to clone and split (the first grows the buffer), an opacity
    reset and the large-screen prune in the pass after it, the SH ramp at
    1000, PSNR evaluations at 1 and 1000 and a checkpoint. The kernels'
    launch counts are read around that call: each deform step must run the
    deformation MLP's forward and VJP kernels (AST's host time, xyz
    detached), every MLP evaluation fused. The run must have learned
    the scene: no step's render empty (`EmptyViewWatch`), the late
    losses below the first, the mean test PSNR up
    from the first evaluation's and at least TRAIN_PSNR_FLOOR, and every
    view of the checkpoint's render (`render.main`) at least
    VIEW_PSNR_FLOOR."""
    from d3gs_tpu_torch import tracing
    from d3gs_tpu_torch.data.image_io import read_png
    from d3gs_tpu_torch.data.ply import write_pointcloud_ply
    from d3gs_tpu_torch import render as R
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.ops import mlp_field as M
    from d3gs_tpu_torch.tools.exp_empty_views import EmptyViewWatch
    from d3gs_tpu_torch.train.__main__ import main as train_main
    pts, cols = bench_points()
    write_pointcloud_ply(os.path.join(data, "points3d.ply"), pts,
                         np.round(cols * 255))
    it, warm_up = TRAIN_ITERATIONS, 6
    n_eval = 2 * 2
    deform_steps = it - warm_up + 1       # iterations warm_up ... it
    reset_counts()
    t0 = time.perf_counter()
    with WatchHostEvents() as events, EmptyViewWatch() as views:
        result = train_main([
            "-s", data, "-m", mp, "--eval", "--is_blender", "--quiet",
            "--iterations", str(it), "--warm_up", str(warm_up),
            "--sh_degree", "3", "--densify_from_iter", "8",
            "--densification_interval", str(TRAIN_DENSIFY_INTERVAL),
            "--densify_until_iter", str(TRAIN_DENSIFY_UNTIL),
            # far below this scene's screen-space gradients (phase 5 prints
            # them; the default 7e-4 and 2e-5 clone nothing here), so that
            # the passes clone, split and grow the buffer
            "--densify_grad_threshold", "1e-8",
            "--opacity_reset_interval", str(TRAIN_RESET_INTERVAL),
            "--test_iterations", "1", str(it), "--save_iterations", str(it),
            "--sequence_length", "4"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**B.launch_counts(), **M.launch_counts()}
    c = tracing.counters()
    mlp = {k: c.get(f"deform.mlp.{k}", 0) for k in ("evals", "fused")}
    log(f"[4b] train.main: {it} iterations in {wall:.1f} s; "
        f"kernel launches {launches}; MLP evaluations {mlp}; losses "
        f"{result.losses}; PSNR "
        f"{result.test_psnrs}; densify (iteration, alive, capacity before, "
        f"alive, capacity after) {result.densify_events}; opacity resets "
        f"(largest live opacity after) {events.resets}; removals by pass "
        f"(max_screen_size, Gaussians removed by rule) {events.prunes}; "
        f"active SH degree {result.state.active_sh_degree}; steps that "
        f"rendered no pixel {len(views.empty)}")
    # the SH ramp (every 1000), the reset (opacities <= 0.01) and the pass
    # after it removing Gaussians over 20 px
    if result.state.active_sh_degree != 1:
        raise AssertionError("the SH ramp did not fire at 1000: active "
                             f"degree {result.state.active_sh_degree}")
    if len(events.resets) != 1 or not events.resets[0] <= 0.0101:
        raise AssertionError(f"opacity reset: {events.resets}")
    if not any(size > 0 and n["oversized"] > 0 for size, n in events.prunes):
        raise AssertionError(f"no large-screen prune: {events.prunes}")
    if launches["blend_bwd"] < it:
        raise AssertionError(f"blend_bwd launched {launches['blend_bwd']} "
                             f"times for {it} train steps")
    if launches["blend_fwd"] < it + n_eval:
        raise AssertionError(f"blend_fwd launched {launches['blend_fwd']} "
                             f"times for {it} steps and {n_eval} "
                             f"evaluation renders")
    if not (launches["mlp_field"] >= deform_steps
            and launches["mlp_field_bwd"] >= deform_steps
            and mlp["evals"] >= deform_steps
            and mlp["fused"] == mlp["evals"]):
        raise AssertionError(f"the fused MLP over {deform_steps} deform "
                             f"steps: launches {launches}, evaluations "
                             f"{mlp}")
    values = [v for _, v in result.losses] + list(result.test_psnrs.values())
    if not (values and all(math.isfinite(v) for v in values)
            and it in result.test_psnrs):
        raise AssertionError(f"loss or PSNR not finite: {result.losses}, "
                             f"{result.test_psnrs}")
    # the low threshold makes the passes clone and split
    if not any(n1 != n0 for _, n0, _, n1, _ in result.densify_events):
        raise AssertionError(f"densification changed no alive count: "
                             f"{result.densify_events}")
    # a deform field that throws every Gaussian out of a view leaves that
    # view no gradient to recover by (tools/exp_empty_views.py)
    if views.empty:
        raise AssertionError(f"{len(views.empty)} steps rendered no pixel, "
                             f"the first at {views.empty[:4]}; the state "
                             f"behind them: {views.details}")
    # learned, not diverged: the losses of the last 200 steps' logs below
    # the first, the test PSNR up from the first evaluation's and at least
    # the floor
    late = [v for i, v in result.losses if i > it - 200]
    if not (late and max(late) < result.losses[0][1]):
        raise AssertionError(f"the late losses {late} are not below the "
                             f"first {result.losses[0]}")
    if not (result.test_psnrs[it] >= TRAIN_PSNR_FLOOR
            and result.test_psnrs[it] > result.test_psnrs[1]):
        raise AssertionError(f"test PSNR {result.test_psnrs} (floor "
                             f"{TRAIN_PSNR_FLOOR} dB at {it})")

    t0 = time.perf_counter()
    out = R.main(["-m", mp, "--mode", "render"])
    torch.cuda.synchronize()
    views = [(split, i) for split, n in (("train", 4), ("test", 2))
             for i in range(n)]
    imgs = {kind: [read_png(os.path.join(mp, split, f"ours_{it}", kind,
                                         f"{i:05d}.png")).astype(np.float64)
                   / 255 for split, i in views]
            for kind in ("renders", "gt")}
    if out != {"iteration": it, "views": 6} or any(
            im.shape != (HEIGHT, WIDTH, 3) for im in imgs["renders"]):
        raise AssertionError(f"render of the trained model: {out}")
    def psnr(a, b):
        return float(-10 * np.log10(max(np.mean((a - b) ** 2), 1e-20)))
    psnrs = [psnr(r, g) for r, g in zip(imgs["renders"], imgs["gt"])]
    log(f"[4b] render.main of the checkpoint: {out} in "
        f"{time.perf_counter() - t0:.1f} s; mean pixel of the renders "
        f"{[round(float(255 * im.mean()), 1) for im in imgs['renders']]}, "
        f"PSNR of each against its view {[round(p, 2) for p in psnrs]} "
        f"(of a black render {[round(psnr(0, g), 2) for g in imgs['gt']]})")
    if min(psnrs) < VIEW_PSNR_FLOOR:
        raise AssertionError(f"a view of the checkpoint renders below "
                             f"{VIEW_PSNR_FLOOR} dB: {psnrs}")
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


# 3d: the fused RK4 step (csrc/ode_rk4.cu) at trex's size, the ODE cells'
# field (8x256 Blender DeformNetworkODE, nn.Linear's init), positions
# uniform in [-1.3, 1.3]^3 as the benchmark draws them
ODE_N = 78_624
ODE_T1, ODE_STEPS = 0.73, 8       # the viewer's integral from 0 to t
ODE_INTEGRAL_TOL = 1e-5           # kernel vs plain after it (TF32 anywhere
#                                   in the trunk reads ~1e-3)
ODE_GRAD_SUBSTEPS = 3
# The gradient through the ReLU trunk is ill-conditioned in f32: a change
# of the state by rounding flips units near their kink. Phase 3d's control
# is the checkpointed path against itself with the input moved by one ulp
# (relative 2^-23); the fused path's gradients, whose forward differs by
# rounding, are held to the control's gap (relative L2 norm of a leaf's
# difference), times ODE_GRAD_CONTROL_X, and never above ODE_GRAD_TOL
ODE_GRAD_CONTROL_X = 4.0
ODE_GRAD_TOL = 1e-3


def ode_rk4_inputs(dev, seed: int = 0):
    """(net, y) of phase 3d."""
    from d3gs_tpu_torch.models.deform.networks import DeformNetworkODE
    g = torch.Generator().manual_seed(seed)
    net = DeformNetworkODE(is_blender=True, generator=g).to(dev)
    y = (torch.rand(ODE_N, 3, generator=g) * 2.6 - 1.3).to(dev)
    return net, y


def ode_vjp_check(dev, net, y, dt: float) -> dict:
    """Phase 3d: the backward kernel (`rk4_step_vjp_cuda`) of one RK4 step
    at ODE_N against its plain version on the card, each leaf's gap
    (relative L2) held to the control's, the plain version against itself
    with the input moved by one ulp, as the integral's gradients are; then
    the kernel twice on the same input, bit for bit."""
    from d3gs_tpu_torch.ops import ode_rk4 as K
    gc = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)
                     ).to(dev)
    before = K.launch_counts()["ode_rk4_bwd"]
    first = K.rk4_step_vjp_cuda(net, y, 0.1, dt, gc)
    again = K.rk4_step_vjp_cuda(net, y, 0.1, dt, gc)
    plain = K.rk4_step_vjp_torch(net, y, 0.1, dt, gc)
    moved = K.rk4_step_vjp_torch(net, y * (1 + 2.0 ** -23), 0.1, dt, gc)
    torch.cuda.synchronize()
    flat = lambda r: [r[0], *r[1]]  # noqa: E731
    l2 = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    gap = [l2(a, b) for a, b in zip(flat(first), flat(plain))]
    control = [l2(a, b) for a, b in zip(flat(moved), flat(plain))]
    same = all(torch.equal(a, b) for a, b in zip(flat(first), flat(again)))
    out = {"vjp_l2_state": gap[0], "vjp_l2_params": max(gap[1:]),
           "vjp_control_state": control[0],
           "vjp_control_params": max(control[1:]), "vjp_bitwise": same,
           "vjp_launches": K.launch_counts()["ode_rk4_bwd"] - before}
    log(f"[3d] ode_rk4_bwd at N = {ODE_N}, one step: relative L2 gap to "
        f"rk4_step_vjp_torch, state / worst parameter {gap[0]:.3e} / "
        f"{max(gap[1:]):.3e}; control (plain, input moved one ulp) "
        f"{control[0]:.3e} / {max(control[1:]):.3e}; two runs bit-equal: "
        f"{same}; launches {out['vjp_launches']}")
    for a, b in zip(gap, control):
        if not a <= min(ODE_GRAD_TOL, max(ODE_GRAD_CONTROL_X * b, 1e-6)):
            raise AssertionError(f"ode_rk4_bwd differs from its plain "
                                 f"version: {gap} against the control's "
                                 f"{control}")
    if not same or out["vjp_launches"] != 2:
        raise AssertionError(f"ode_rk4_bwd: bit-equal {same}, launches "
                             f"{out['vjp_launches']} (2 expected)")
    return out


def ode_step_flops() -> float:
    """f32 FLOPs of one fused RK4 step at ODE_N: 4 evaluations of the
    trunk with the time input folded (PE(x) 63 -> 256, 4 x 256 -> 256,
    the skip 63 + 256 -> 256, 2 x 256 -> 256, 256 -> 3)."""
    macs = 63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256 + 256 * 3
    return 2.0 * 4 * ODE_N * macs


def ode_rk4_check(dev) -> dict:
    """Phase 3d: the fused RK4 kernel against its plain version
    (`rk4_step_torch` on the card) and today's `_rk4_step`, after one step
    and after the viewer's 8-step integral from 0 to 0.73 (within
    ODE_INTEGRAL_TOL); then a 3-substep forward and backward through
    `integrate_segment`, fused against checkpointed, the gap of the state's
    and every parameter's gradient over that leaf's largest (within
    ODE_GRAD_TOL), whose backward is the fused VJP kernel; and
    `ode_vjp_check`. Returns the errors and the launches it made."""
    from unittest import mock
    from d3gs_tpu_torch.models.deform import ode as O
    from d3gs_tpu_torch.ops import ode_rk4 as K
    net, y = ode_rk4_inputs(dev)
    reset_counts()
    # the host times of `integrate_segment`: f32 arithmetic, then floats
    h1 = torch.tensor(ODE_T1, dtype=torch.float32)
    step = h1 / ODE_STEPS
    dt = float(step)
    with torch.no_grad():
        one = {"kernel": K.rk4_step_cuda(net, y, 0.0, dt),
               "plain": K.rk4_step_torch(net, y, 0.0, dt),
               "rk4": O._rk4_step(net, y, 0.0, dt)}
        fused = O.odeint_from_zero(net, y, ODE_T1, n_substeps=ODE_STEPS)
        plain, today = y, y
        for i in range(ODE_STEPS):
            t = float(step * i)
            plain = K.rk4_step_torch(net, plain, t, dt)
            today = O._rk4_step(net, today, t, dt)
    torch.cuda.synchronize()
    err = lambda a, b: float((a - b).abs().max())  # noqa: E731
    out = {"step_vs_plain": err(one["kernel"], one["plain"]),
           "step_vs_rk4": err(one["kernel"], one["rk4"]),
           "integral_vs_plain": err(fused, plain),
           "integral_vs_rk4": err(fused, today),
           "plain_vs_rk4": err(plain, today),
           "integral_moved": float((fused - y).abs().max())}
    log(f"[3d] ode_rk4 at N = {ODE_N}: max |difference| after one step "
        f"{out['step_vs_plain']:.3e} vs plain, {out['step_vs_rk4']:.3e} vs "
        f"_rk4_step; after {ODE_STEPS} steps to t = {ODE_T1} "
        f"{out['integral_vs_plain']:.3e} vs plain, "
        f"{out['integral_vs_rk4']:.3e} vs _rk4_step (plain vs _rk4_step "
        f"{out['plain_vs_rk4']:.3e}; the integral moves the points by up "
        f"to {out['integral_moved']:.3e})")
    if not (torch.isfinite(fused).all()
            and max(out["integral_vs_plain"], out["integral_vs_rk4"])
            <= ODE_INTEGRAL_TOL):
        raise AssertionError(f"ode_rk4 differs from its plain version: "
                             f"{out}")

    c = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)
                    ).to(dev)
    params = list(net.parameters())

    def grads(y_in):
        y0 = y_in.clone().requires_grad_()
        ys = O.integrate_segment(net, y0, 0.1, 0.55, ODE_GRAD_SUBSTEPS)
        return torch.autograd.grad((ys * c).sum(), [y0] + params)
    got = grads(y)
    with mock.patch.object(K, "DEVICES", ()):     # today's path on the card
        want = grads(y)
        moved = grads(y * (1 + 2.0 ** -23))
    torch.cuda.synchronize()

    def gaps(a_set, b_set):
        """Per leaf: max |a - b| over max |b|, and ||a - b|| / ||b||."""
        return ([float((a - b).abs().max() / b.abs().max()) for a, b in
                 zip(a_set, b_set)],
                [float((a - b).norm() / b.norm()) for a, b in
                 zip(a_set, b_set)])
    g_max, g_l2 = gaps(got, want)
    c_max, c_l2 = gaps(moved, want)
    out.update(grad_gap_state=g_max[0], grad_gap_params=max(g_max[1:]),
               grad_l2_state=g_l2[0], grad_l2_params=max(g_l2[1:]),
               control_gap_state=c_max[0],
               control_gap_params=max(c_max[1:]),
               control_l2_state=c_l2[0], control_l2_params=max(c_l2[1:]),
               launches=K.launch_counts()["ode_rk4"],
               bwd_launches=K.launch_counts()["ode_rk4_bwd"])
    log(f"[3d] {ODE_GRAD_SUBSTEPS}-substep forward + backward, fused vs "
        f"checkpointed, state / worst parameter: largest gap (of the "
        f"leaf's largest) {g_max[0]:.3e} / {max(g_max[1:]):.3e}, relative "
        f"L2 {g_l2[0]:.3e} / {max(g_l2[1:]):.3e}; control (checkpointed, "
        f"input moved one ulp) {c_max[0]:.3e} / {max(c_max[1:]):.3e}, L2 "
        f"{c_l2[0]:.3e} / {max(c_l2[1:]):.3e}; ode_rk4 launches in 3d "
        f"{out['launches']}, ode_rk4_bwd {out['bwd_launches']}")
    for a, b in zip(g_l2, c_l2):
        if not a <= min(ODE_GRAD_TOL, max(ODE_GRAD_CONTROL_X * b, 1e-6)):
            raise AssertionError(f"fused RK4 gradients differ: {g_l2} "
                                 f"against the control's {c_l2}")
    if out["bwd_launches"] != ODE_GRAD_SUBSTEPS:
        raise AssertionError(f"the fused backward launched ode_rk4_bwd "
                             f"{out['bwd_launches']} times for "
                             f"{ODE_GRAD_SUBSTEPS} substeps")
    out.update(ode_vjp_check(dev, net, y, dt))
    return out


def ode_rk4_timings(dev) -> dict:
    """Phase 5: one RK4 step at ODE_N, no grad, by CUDA events: the kernel
    (through its wrapper: the pack is cached, the time biases are computed
    each call), its plain version and today's `_rk4_step`; the kernel's
    bound is its f32 FLOPs over the f32 peak, and its device time from the
    profiler."""
    from d3gs_tpu_torch.models.deform import ode as O
    from d3gs_tpu_torch.ops import ode_rk4 as K
    net, y = ode_rk4_inputs(dev)
    dt = ODE_T1 / ODE_STEPS
    with torch.no_grad():
        t = {"ms": cuda_ms(lambda: K.rk4_step_cuda(net, y, 0.0, dt), 20),
             "plain_ms": cuda_ms(lambda: K.rk4_step_torch(net, y, 0.0, dt),
                                 5),
             "rk4_ms": cuda_ms(lambda: O._rk4_step(net, y, 0.0, dt), 5),
             "bound_ms": 1e3 * ode_step_flops() / F32_FLOPS,
             "profile": profile(lambda: K.rk4_step_cuda(net, y, 0.0, dt),
                                calls=5, top=4)}
    t["device_ms"] = t["profile"]["device_ms_per_call"]
    t["share_of_f32_peak"] = t["bound_ms"] / t["ms"]
    log(f"[5] ode_rk4 at N = {ODE_N}: {t['ms']:.3f} ms a step (device "
        f"{t['device_ms']:.3f}), bound {t['bound_ms']:.3f} ms "
        f"({100 * t['share_of_f32_peak']:.1f} % of the f32 peak), plain "
        f"{t['plain_ms']:.3f} ms, _rk4_step {t['rk4_ms']:.3f} ms; "
        f"{json.dumps(t['profile'])}")
    t["bwd"] = ode_vjp_timings(dev, net, y, dt)
    return t


def ode_vjp_timings(dev, net, y, dt: float) -> dict:
    """Phase 5: the VJP of one RK4 step at ODE_N by CUDA events: the
    backward kernels through their wrapper (the time biases and the
    parameter gradients' assembly included), its plain version, and the
    path they replace, `_rk4_step` run again under autograd and its VJPs
    (cuBLAS products), as the library's yardstick; the bound is three
    forwards' f32 FLOPs over the f32 peak. The kernels' device time by
    the profiler."""
    from d3gs_tpu_torch.models.deform import ode as O
    from d3gs_tpu_torch.ops import ode_rk4 as K
    gc = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)
                     ).to(dev)
    params = list(net.parameters())

    def library():
        with torch.enable_grad():
            y_ = y.detach().requires_grad_()
            out = O._rk4_step(net, y_, 0.1, dt)
            return torch.autograd.grad(out, [y_, *params], gc)
    kernel = lambda: K.rk4_step_vjp_cuda(net, y, 0.1, dt, gc)  # noqa: E731
    t = {"ms": cuda_ms(kernel, 10),
         "plain_ms": cuda_ms(
             lambda: K.rk4_step_vjp_torch(net, y, 0.1, dt, gc), 3),
         "library_ms": cuda_ms(library, 5),
         "bound_ms": 3e3 * ode_step_flops() / F32_FLOPS,
         "profile": profile(kernel, calls=5, top=8)}
    torch.cuda.reset_peak_memory_stats()
    kernel()
    torch.cuda.synchronize()
    t["peak_bytes"] = torch.cuda.max_memory_allocated()
    t["device_ms"] = t["profile"]["device_ms_per_call"]
    t["share_of_f32_peak"] = t["bound_ms"] / t["ms"]
    log(f"[5] ode_rk4_bwd at N = {ODE_N}: {t['ms']:.3f} ms a step (device "
        f"{t['device_ms']:.3f}), bound {t['bound_ms']:.3f} ms "
        f"({100 * t['share_of_f32_peak']:.1f} % of the f32 peak), plain "
        f"{t['plain_ms']:.3f} ms, _rk4_step + autograd {t['library_ms']:.3f}"
        f" ms; peak {t['peak_bytes'] / 1e9:.2f} GB; "
        f"{json.dumps(t['profile'])}")
    return t


# 3e: the fused deformation MLP (csrc/mlp_field.cu) at the real-scene
# cell's size, its field (8x256, PE(x, 10) and PE(t, 10), full heads,
# nn.Linear's init), positions uniform in [-1.3, 1.3]^3; and a ragged N
# whose tail takes the 64-row tile, on the Blender time net with the
# `warp` kind's one head
MLP_N = 400_000
MLP_RAGGED_N = 21_899
MLP_T = 0.41
MLP_FWD_TOL = 2e-6                # heads: largest gap over largest head
#                                   (products in another order)
# The gradients are held to the 3d control (ODE_GRAD_CONTROL_X times the
# plain version's gap with x moved one ulp), never below MLP_GRAD_FLOOR and
# never above MLP_GRAD_TOL. The floor: the heads' bias gradients are the
# column sums of the cotangents, which x does not move (their control reads
# 0), and 400,000 f32 terms summed in another order differ by ~2e-6
# (relative L2). The cap: at 400,000 points one ulp of x moves the trunk's
# gradients by ~7e-3 (ReLU masks flip), so 3d's 1e-3 is below the noise of
# the layers' own f32 path; 5e-3 still shows a fault that moves a gradient
# by a percent
MLP_GRAD_FLOOR = 1e-5
MLP_GRAD_TOL = 5e-3


def mlp_field_inputs(dev, n: int, seed: int = 0, **kw):
    """(net, x) of phase 3e."""
    from d3gs_tpu_torch.models.deform.networks import DeformMLP
    g = torch.Generator().manual_seed(seed)
    net = DeformMLP(generator=g, **kw).to(dev)
    x = (torch.rand(n, 3, generator=g) * 2.6 - 1.3).to(dev)
    return net, x


def mlp_field_flops(n: int, heads: int = 10) -> tuple[float, float]:
    """f32 FLOPs that the forward kernel and the VJP kernel need for one
    evaluation at n rows: the forward's products with the time input
    folded into c0 and c5 (PE(x) 63 -> 256 at layer 0, 63 + 256 -> 256 at
    the skip; 256 -> `heads`); the VJP's sweep (the input gradients of
    layers 7 ... 1 and of the heads, none of layer 0's or of PE(x)) and
    its weight gradients (the forward's products again).
    `benchmark/counts.py` counts the time input per point (84 and 340
    wide), work that neither kernel does."""
    fwd = (63 * 256 + 4 * 256 * 256 + (63 + 256) * 256 + 2 * 256 * 256
           + 256 * heads)
    sweep = 7 * 256 * 256 + 256 * heads
    return 2.0 * n * fwd, 2.0 * n * (sweep + fwd)


def mlp_field_check(dev) -> dict:
    """Phase 3e: at MLP_N (10 heads, PE(t)) and MLP_RAGGED_N (3 heads, the
    Blender time net), the forward kernel against `mlp_field_torch` (the
    largest gap over the largest head, within MLP_FWD_TOL), with and
    without the backward's scratch and twice, bit for bit; the VJP kernel
    against `mlp_field_vjp_torch`, each leaf's gap (relative L2) held to
    the control's (the plain VJP with x moved one ulp: the ReLU masks make
    the gradients ill-conditioned in f32, as the ODE's), and twice, bit
    for bit; DeformMLP under autograd (`_FusedMLP`) against its layers
    under autograd, held to the same control. Then the real-scene cell's
    train step (`make_train_step` with `train/baseline.py::make_deform_fn`,
    AST) on the bench scene must launch both kernels once a step."""
    from unittest import mock
    from d3gs_tpu_torch.ops import mlp_field as M
    out = {}
    for n, kw in ((MLP_N, {}), (MLP_RAGGED_N, dict(is_blender=True,
                                                   full_heads=False))):
        net, x = mlp_field_inputs(dev, n, **kw)
        params = list(net.parameters())
        reset_counts()
        with torch.no_grad():
            heads, kept = M.mlp_field(net, x, MLP_T, keep=True)
            alone = M.mlp_field(net, x, MLP_T)[0]
            again = M.mlp_field(net, x, MLP_T)[0]
            plain = M.mlp_field_torch(net, x, MLP_T)
        gc = [torch.randn(h.shape, generator=torch.Generator().manual_seed(
            2 + i)).to(dev) for i, h in enumerate(heads)]
        first = M.mlp_field_vjp(net, x, MLP_T, gc, kept)
        second = M.mlp_field_vjp(net, x, MLP_T, gc, kept)
        ref = M.mlp_field_vjp_torch(net, x, MLP_T, gc)
        moved = M.mlp_field_vjp_torch(net, x * (1 + 2.0 ** -23), MLP_T, gc)

        def through(x_in):
            return torch.autograd.grad(net(x_in, MLP_T)[:len(gc)], params,
                                       gc)
        fused = through(x)
        with mock.patch.object(M, "DEVICES", ()):   # the layers
            layers = through(x)
            layers_moved = through(x * (1 + 2.0 ** -23))
        torch.cuda.synchronize()
        l2 = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
        fwd = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(heads, plain))
        gap = [l2(a, b) for a, b in zip(first, ref)]
        control = [l2(a, b) for a, b in zip(moved, ref)]
        via = [l2(a, b) for a, b in zip(fused, layers)]
        via_control = [l2(a, b) for a, b in zip(layers_moved, layers)]
        r = {"fwd_gap": fwd,
             "fwd_bitwise": all(torch.equal(a, b) and torch.equal(a, c)
                                for a, b, c in zip(heads, alone, again)),
             "finite": all(bool(torch.isfinite(h).all()) for h in heads),
             "vjp_l2_params": max(gap), "vjp_control": max(control),
             "vjp_bitwise": all(torch.equal(a, b)
                                for a, b in zip(first, second)),
             "autograd_l2_params": max(via),
             "autograd_control": max(via_control),
             "launches": M.launch_counts()}
        out[n] = r
        log(f"[3e] mlp_field at N = {n} ({len(heads)} head(s), "
            f"{'Blender time net' if kw else 'PE(t)'}): largest head gap "
            f"{fwd:.3e} of the largest head vs plain; bit-equal with and "
            f"without the scratch and run to run: {r['fwd_bitwise']}; VJP "
            f"relative L2, worst parameter {max(gap):.3e} (control, plain "
            f"with x moved one ulp, {max(control):.3e}), bit-equal run to "
            f"run: {r['vjp_bitwise']}; DeformMLP under autograd fused vs "
            f"layers {max(via):.3e} (control {max(via_control):.3e}); "
            f"launches {r['launches']}")
        if not (r["finite"] and fwd <= MLP_FWD_TOL and r["fwd_bitwise"]
                and r["vjp_bitwise"]):
            raise AssertionError(f"mlp_field at N = {n}: {r}")
        for a, b in list(zip(gap, control)) + list(zip(via, via_control)):
            if not a <= min(MLP_GRAD_TOL, max(ODE_GRAD_CONTROL_X * b,
                                              MLP_GRAD_FLOOR)):
                raise AssertionError(f"mlp_field gradients at N = {n}: "
                                     f"{gap} / {via} against the controls "
                                     f"{control} / {via_control}")
        del kept
    out["train_real_step"] = mlp_train_real_launches(dev)
    return out


def mlp_train_real_launches(dev, steps: int = 3) -> dict:
    """Phase 3e: `steps` steps of the real-scene cell's train step (the
    baseline trainer's deform phase with AST, `make_train_step` and
    `make_deform_fn`, as `benchmark/loops/train_real.py` builds it) on the
    bench scene with the cell's field (PE(t), full heads): each step must
    run the forward kernel and the VJP kernel once, every evaluation
    fused."""
    import dataclasses
    import types
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch import tracing
    from d3gs_tpu_torch.models.deform.fields import (DeformFieldSpec,
                                                     create_deform_field)
    from d3gs_tpu_torch.models.gaussians import gaussians_from_numpy
    from d3gs_tpu_torch.ops import mlp_field as M
    from d3gs_tpu_torch.train.baseline import make_deform_fn
    from d3gs_tpu_torch.train.step import make_train_step
    opt, pipe = C.OptimizationParams(), C.PipelineParams()
    params, alive = bench_params(dev)
    state = gaussians_from_numpy(params, alive, 3, 3, dev)
    field = create_deform_field(DeformFieldSpec(kind="baseline"), seed=2,
                                device=dev, opt_cfg=opt)
    gt = torch.rand((HEIGHT, WIDTH, 3), device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    cam = dataclasses.replace(look_from_z(4.0, WIDTH, dev, fid=0.3), image=gt)
    step = make_train_step(
        opt_cfg=opt, pipe_cfg=pipe,
        deform_fn=make_deform_fn(field, types.SimpleNamespace(
            is_blender=False), 1.0 / 120),
        deform_params=list(field.net.parameters()),
        deform_update_fn=field.update)
    dstate = field.init_state()
    gen = torch.Generator().manual_seed(7)
    reset_counts()
    for i in range(steps):
        state, dstate, _ = step(state, dstate, cam, 16_000 + i, gen,
                                torch.zeros(3, device=dev))
    torch.cuda.synchronize()
    c = tracing.counters()
    out = {"launches": M.launch_counts(),
           "evals": c.get("deform.mlp.evals", 0),
           "fused": c.get("deform.mlp.fused", 0),
           "ast": c.get("deform.ast", 0)}
    log(f"[3e] {steps} steps of the real-scene train step (AST): {out}")
    if out["launches"] != {"mlp_field": steps, "mlp_field_bwd": steps} or \
            out["evals"] != steps or out["fused"] != steps or \
            out["ast"] != steps:
        raise AssertionError(f"the real-scene train step did not run the "
                             f"fused MLP once a step: {out}")
    return out


def mlp_field_timings(dev) -> dict:
    """Phase 5: one evaluation at MLP_N (the real-scene field) by CUDA
    events: the forward kernel (through its wrapper: the pack cached, the
    time biases computed each call), its plain version and the library's
    yardstick, today's DeformMLP layers (cuBLAS SGEMMs and glue); the
    forward keeping the scratch and the VJP kernel over it against their
    plain versions and DeformMLP's layers forward + autograd backward. The
    bounds: `mlp_field_flops` over the f32 peak. Device times by the
    profiler."""
    from unittest import mock
    from d3gs_tpu_torch.ops import mlp_field as M
    net, x = mlp_field_inputs(dev, MLP_N)
    params = list(net.parameters())
    gc = [torch.randn((MLP_N, k), generator=torch.Generator().manual_seed(
        2 + i)).to(dev) for i, k in enumerate((3, 4, 3))]
    with torch.no_grad():
        kept = M.mlp_field(net, x, MLP_T, keep=True)[1]

    def layers_fwd():
        with mock.patch.object(M, "DEVICES", ()), torch.no_grad():
            return net(x, MLP_T)

    def layers_fwd_bwd():
        with mock.patch.object(M, "DEVICES", ()):
            return torch.autograd.grad(net(x, MLP_T), params, gc)

    def fused_fwd_bwd():
        return torch.autograd.grad(net(x, MLP_T), params, gc)
    fwd = lambda: M.mlp_field(net, x, MLP_T)  # noqa: E731
    vjp = lambda: M.mlp_field_vjp(net, x, MLP_T, gc, kept)  # noqa: E731
    with torch.no_grad():
        t = {"fwd_ms": cuda_ms(fwd, 10),
             "fwd_keep_ms": cuda_ms(
                 lambda: M.mlp_field(net, x, MLP_T, keep=True), 10),
             "fwd_plain_ms": cuda_ms(
                 lambda: M.mlp_field_torch(net, x, MLP_T), 5),
             "fwd_library_ms": cuda_ms(layers_fwd, 5),
             "vjp_ms": cuda_ms(vjp, 10),
             "vjp_plain_ms": cuda_ms(
                 lambda: M.mlp_field_vjp_torch(net, x, MLP_T, gc), 3),
             "fwd_bound_ms": 1e3 * mlp_field_flops(MLP_N)[0] / F32_FLOPS,
             "vjp_bound_ms": 1e3 * mlp_field_flops(MLP_N)[1] / F32_FLOPS}
    t["fused_fwd_bwd_ms"] = cuda_ms(fused_fwd_bwd, 5)
    t["library_fwd_bwd_ms"] = cuda_ms(layers_fwd_bwd, 5)
    t["fwd_profile"] = profile(fwd, calls=5, top=4)
    t["vjp_profile"] = profile(vjp, calls=5, top=8)
    torch.cuda.reset_peak_memory_stats()
    fused_fwd_bwd()
    torch.cuda.synchronize()
    t["fused_fwd_bwd_peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    layers_fwd_bwd()
    torch.cuda.synchronize()
    t["library_fwd_bwd_peak_bytes"] = torch.cuda.max_memory_allocated()
    t["fwd_share_of_f32_peak"] = t["fwd_bound_ms"] / t["fwd_ms"]
    t["vjp_share_of_f32_peak"] = t["vjp_bound_ms"] / t["vjp_ms"]
    log(f"[5] mlp_field at N = {MLP_N}: forward {t['fwd_ms']:.3f} ms "
        f"(keeping the scratch {t['fwd_keep_ms']:.3f}; device "
        f"{t['fwd_profile']['device_ms_per_call']:.3f}), bound "
        f"{t['fwd_bound_ms']:.3f} ms ({100 * t['fwd_share_of_f32_peak']:.1f}"
        f" % of the f32 peak), plain {t['fwd_plain_ms']:.3f}, DeformMLP's "
        f"layers {t['fwd_library_ms']:.3f}; VJP {t['vjp_ms']:.3f} ms "
        f"(device {t['vjp_profile']['device_ms_per_call']:.3f}), bound "
        f"{t['vjp_bound_ms']:.3f} ({100 * t['vjp_share_of_f32_peak']:.1f} "
        f"%), plain {t['vjp_plain_ms']:.3f}; forward + backward through "
        f"autograd fused {t['fused_fwd_bwd_ms']:.3f} ms vs the layers "
        f"{t['library_fwd_bwd_ms']:.3f} ms, peak "
        f"{t['fused_fwd_bwd_peak_bytes'] / 1e9:.2f} vs "
        f"{t['library_fwd_bwd_peak_bytes'] / 1e9:.2f} GB; "
        f"{json.dumps(t['fwd_profile'])}; {json.dumps(t['vjp_profile'])}")
    return t


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
        reset_counts()
        t0 = time.perf_counter()
        out = tool.main(["--reps", "10"])
        torch.cuda.synchronize()
        launches[kernel] = R.launch_counts()[kernel]
        log(f"[4c] {tool.__name__}.main: {time.perf_counter() - t0:.1f} s, "
            f"launches {R.launch_counts()}; {json.dumps(out)}")
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
    from d3gs_tpu_torch.ops import ode_rk4 as K
    from d3gs_tpu_torch.train.__main__ import main as train_main
    from d3gs_tpu_torch.train.flagship import pick_field_spec
    pts, cols = bench_points()
    write_pointcloud_ply(os.path.join(data, "points3d.ply"), pts,
                         np.round(cols * 255))
    it, k = FLAGSHIP_ITERATIONS, FLAGSHIP_K
    n_train, n_test = FLAGSHIP_VIEWS
    reset_counts()
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
    launches = {**B.launch_counts(), **K.launch_counts()}
    log(f"[4d] train.main --trainer flagship: {it} iterations x {k} cameras "
        f"in {wall:.1f} s; kernel launches {launches}; losses "
        f"{result.losses}; PSNR {result.test_psnrs}; densify "
        f"{result.densify_events}; deform updates "
        f"{result.deform_state.count}")
    if result.field.spec.kind != "ode" or result.field.spec.n_substeps != 4:
        raise AssertionError(f"flagship field: {result.field.spec}")
    if launches["ode_rk4"] < it:
        raise AssertionError(f"the 8x256 ODE field ran the fused RK4 step "
                             f"{launches['ode_rk4']} times in {it} steps")
    if launches["ode_rk4_bwd"] == 0:
        raise AssertionError("the flagship's backward never ran the fused "
                             "RK4 step's VJP kernel")
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
    return launches, result.losses[0][1]


def reset_counts() -> None:
    """Zero the port's counters (`d3gs_tpu_torch.tracing`), the adaptive
    solver's among them."""
    from d3gs_tpu_torch import tracing
    tracing.drain()


def ode_counts() -> dict:
    """The adaptive solver's counts since the last reset, forward and
    backward."""
    import dataclasses
    from d3gs_tpu_torch.models.deform import ode as O
    return {d: dataclasses.asdict(O.solve_counts(d))
            for d in ("forward", "backward")}


def per_step(counts: dict, steps: int) -> dict:
    """Counts per step of `steps` steps, rounded for the log."""
    return {d: {k: round(v / max(steps, 1), 2) for k, v in c.items()}
            for d, c in counts.items()}


def check_checkpoint_render(dev, mp, it, n_views, tag):
    """`render.main` on the checkpoint at `it`; its test render 0 against
    the plain blend of the same field's positions (at most 1 of 255)."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch import render as R
    from d3gs_tpu_torch.data.image_io import read_png
    from d3gs_tpu_torch.data.scene import Scene
    from d3gs_tpu_torch.models.deform.fields import (create_deform_field,
                                                     load_deform_weights)
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.train.flagship import pick_field_spec
    t0 = time.perf_counter()
    reset_counts()
    out = R.main(["-m", mp, "--mode", "render"])
    torch.cuda.synchronize()
    counts = ode_counts()
    if out != {"iteration": it, "views": n_views}:
        raise AssertionError(f"{tag}: render of the checkpoint: {out}")
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
    log(f"[{tag}] render.main of the checkpoint ({fld.spec.kind}, solver "
        f"{fld.spec.solver}, {fld.spec.compute_dtype}): {out} in "
        f"{time.perf_counter() - t0:.1f} s; adaptive solves of the render "
        f"{counts['forward']}; test render 0 vs the plain blend of the "
        f"field's positions: max {diff} of 255")
    if diff > 1:
        raise AssertionError(f"{tag}: render disagrees with the plain blend")


def adaptive_flagship_path(dev, data, mp, *, kind_flag, iterations, warm_up,
                           tag) -> dict:
    """Phases 4e / 4f: `python -m d3gs_tpu_torch.train --trainer flagship
    --ode_solver adaptive` at the bench width with `kind_flag` (`--is_ode`:
    the 8x256 Blender ODE field; `--use_torch_ode`: simple_start), k = 10,
    rtol 1e-3 / atol 1e-4, through the warm-up and the deform steps, an
    evaluation and a checkpoint, whose render is held against the plain
    blend. Reads the blend kernels' counts and the solver's around the
    trainer."""
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.train.__main__ import main as train_main
    it, k = iterations, FLAGSHIP_K
    n_train, n_test = FLAGSHIP_VIEWS
    reset_counts()
    t0 = time.perf_counter()
    result = train_main([
        "-s", data, "-m", mp, "--eval", "--is_blender", "--quiet",
        "--trainer", "flagship", kind_flag, "--ode_solver", "adaptive",
        "--rtol", str(ADAPTIVE_TOL[0]), "--atol", str(ADAPTIVE_TOL[1]),
        "--D", "8", "--W", "256", "--num_cams_per_iter", str(k),
        "--iterations", str(it), "--warm_up", str(warm_up),
        "--sh_degree", "3", "--test_iterations", str(it),
        "--save_iterations", str(it)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = B.launch_counts()
    counts = ode_counts()
    deform_steps = it - warm_up + 1
    log(f"[{tag}] train.main --trainer flagship {kind_flag} --ode_solver "
        f"adaptive: {it} iterations x {k} cameras in {wall:.1f} s; kernel "
        f"launches {launches}; losses {result.losses}; PSNR "
        f"{result.test_psnrs}; deform updates {result.deform_state.count}")
    log(f"[{tag}] adaptive solves: {json.dumps(counts)}; per deform step "
        f"(the backward; the forward includes the {n_test} evaluation "
        f"renders' solves from 0): {json.dumps(per_step(counts, deform_steps))}"
        f"; RK4 spends 4 x 4 x (T-1) = {16 * (k - 1)} forward evaluations "
        f"per step at T = {k}")
    spec = result.field.spec
    if spec.solver != "adaptive" or (spec.rtol, spec.atol) != ADAPTIVE_TOL:
        raise AssertionError(f"{tag}: field {spec}")
    if launches["blend_bwd"] < it * k or \
            launches["blend_fwd"] < it * k + n_test:
        raise AssertionError(f"{tag}: blend launches {launches} for {it} "
                             f"steps of {k} cameras and {n_test} renders")
    values = [v for _, v in result.losses] + list(result.test_psnrs.values())
    if not (values and all(math.isfinite(v) for v in values)
            and it in result.test_psnrs):
        raise AssertionError(f"{tag}: loss or PSNR not finite: "
                             f"{result.losses}, {result.test_psnrs}")
    if result.deform_state.count != deform_steps or deform_steps < 2:
        raise AssertionError(f"{tag}: {result.deform_state.count} updates")
    if counts["backward"]["solves"] < deform_steps * (k - 1):
        raise AssertionError(f"{tag}: adaptive backward solves {counts}")
    check_checkpoint_render(dev, mp, it, n_train + n_test, tag)
    return {"launches": launches, "counts": counts,
            "deform_steps": deform_steps, "wall_s": wall}


def distill_path(dev, data, teacher, mp) -> dict:
    """Phase 4g: `python -m d3gs_tpu_torch.train_synth_gau` with 4b's
    checkpoint as the teacher (its Gaussians and 8x256 Blender MLP), the
    8x256 Blender ODE student with the adaptive solver, 5 iterations and a
    PSNR evaluation at 5; every trajectory loss below
    DISTILL_LOSS_BOUND."""
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.train_synth_gau import main as distill_main
    n_test = FLAGSHIP_VIEWS[1]
    reset_counts()
    t0 = time.perf_counter()
    result = distill_main([
        "-s", data, "-m", mp, "--base_model_path", teacher, "--eval",
        "--is_blender", "--is_ode", "--D", "8", "--W", "256",
        "--sh_degree", "3", "--ode_solver", "adaptive",
        "--distill_iterations", str(DISTILL_ITERATIONS),
        "--test_iterations", str(DISTILL_ITERATIONS), "--quiet"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = B.launch_counts()
    counts = ode_counts()
    log(f"[4g] train_synth_gau.main: {DISTILL_ITERATIONS} iterations on "
        f"{result.state.num_alive} teacher Gaussians in {wall:.1f} s; kernel "
        f"launches {launches}; losses {result.losses}; PSNR "
        f"{result.test_psnrs}; adaptive solves {json.dumps(counts)}")
    if result.field.spec.solver != "adaptive" or \
            result.deform_state.count != DISTILL_ITERATIONS:
        raise AssertionError(f"4g: {result.field.spec}, "
                             f"{result.deform_state.count} updates")
    if launches["blend_fwd"] < n_test:
        raise AssertionError(f"4g: blend_fwd launched {launches}")
    values = [v for _, v in result.losses] + list(result.test_psnrs.values())
    if not (all(math.isfinite(v) for v in values)
            and DISTILL_ITERATIONS in result.test_psnrs):
        raise AssertionError(f"4g: loss or PSNR not finite: {result.losses},"
                             f" {result.test_psnrs}")
    if not all(v < DISTILL_LOSS_BOUND for _, v in result.losses):
        raise AssertionError(f"4g: the trajectory loss {result.losses} is "
                             f"not below {DISTILL_LOSS_BOUND}: the teacher "
                             f"moves further than its scene")
    return {"launches": launches, "counts": counts, "wall_s": wall}


def synth_paths(dev, out_dir) -> dict:
    """Phase 4h: the synthetic-ODE CLIs at their defaults but the
    iterations (SYNTH_ITERATIONS of 500; 16 windows of 10 on per-sample
    grids, the `simple` net, RK4), then
    `step_multi` of a `simple_start` field on (16, 10) per-sample grids
    with a duplicate time, adaptive, with a parameter gradient: on the
    card against the same call on the CPU, in this process."""
    from d3gs_tpu_torch import render_synth_ode, train_synth_ode
    from d3gs_tpu_torch.models.deform import fields as F
    t0 = time.perf_counter()
    mse = train_synth_ode.main(["--out", out_dir, "--iterations",
                                str(SYNTH_ITERATIONS)])
    mse2 = render_synth_ode.main(["--params", os.path.join(
        out_dir, "deform_params.npz"), "--out", out_dir])
    wall = time.perf_counter() - t0
    log(f"[4h] train_synth_ode ({SYNTH_ITERATIONS} iterations) / "
        f"render_synth_ode at their defaults: "
        f"rollout MSE {mse} / {mse2} in {wall:.1f} s")
    if not (math.isfinite(mse) and abs(mse2 - mse) <= 1e-6 * max(mse, 1)):
        raise AssertionError(f"4h: rollout MSE {mse} vs {mse2}")

    n, T = SYNTH_GRID
    rng = np.random.default_rng(5)
    y0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    ts = np.sort(rng.uniform(0, 1, (n, T)), axis=1).astype(np.float32)
    ts[:, 3] = ts[:, 2]
    cot = rng.normal(size=(T, n, 3)).astype(np.float32)
    spec = F.DeformFieldSpec(kind="simple_start", solver="adaptive",
                             rtol=SYNTH_CHECK_TOL[0],
                             atol=SYNTH_CHECK_TOL[1])
    res = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        field = F.create_deform_field(spec, seed=3, device=where)
        y = torch.from_numpy(y0).to(where).requires_grad_()
        reset_counts()
        t1 = time.perf_counter()
        ys = field.step_multi(y, torch.from_numpy(ts).to(where), y0=y)[0]
        grads = torch.autograd.grad(
            (ys * torch.from_numpy(cot).to(where)).sum(),
            [y, *field.net.parameters()])
        torch.cuda.synchronize()
        res[name] = {"ys": ys.detach().cpu(), "grads": [
            g.cpu() for g in grads], "s": time.perf_counter() - t1,
            "counts": ode_counts(), "dup": bool(torch.equal(ys[3], ys[2]))}
    card, cpu = res["card"], res["cpu"]
    errs = {"ys": float((card["ys"] - cpu["ys"]).abs().max()
                        / cpu["ys"].abs().max()),
            "grads": max(float((a - b).abs().max() / b.abs().max())
                         for a, b in zip(card["grads"], cpu["grads"]))}
    log(f"[4h] step_multi (simple_start, adaptive at {SYNTH_CHECK_TOL}, "
        f"({n}, {T}) per-sample grids with a duplicate): card "
        f"{card['s']:.1f} s {json.dumps(card['counts'])}, CPU "
        f"{cpu['s']:.1f} s {json.dumps(cpu['counts'])}; card vs CPU, of "
        f"the largest: {errs} (tol {SYNTH_CHECK_ERR}); duplicates "
        f"bit-equal: {card['dup']}, {cpu['dup']}")
    if not (card["dup"] and cpu["dup"]):
        raise AssertionError("4h: a duplicate time differs")
    if not max(errs.values()) <= SYNTH_CHECK_ERR:
        raise AssertionError(f"4h: card and CPU differ: {errs}")
    return {"rollout_mse": mse, "card_vs_cpu": errs}


def bf16_path(dev, data, mp) -> dict:
    """Phase 4i: the baseline CLI with `--deform_dtype bfloat16`, 10
    iterations through the warm-up, an evaluation and a checkpoint, whose
    render is held against the plain blend; then `tools/exp_r5_mlp`'s
    main, the MLP's time in float32 and bfloat16."""
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.tools import exp_r5_mlp
    from d3gs_tpu_torch.train.__main__ import main as train_main
    it = BF16_ITERATIONS
    reset_counts()
    t0 = time.perf_counter()
    result = train_main([
        "-s", data, "-m", mp, "--eval", "--is_blender", "--quiet",
        "--deform_dtype", "bfloat16", "--iterations", str(it),
        "--warm_up", "4", "--sh_degree", "3", "--test_iterations", str(it),
        "--save_iterations", str(it), "--sequence_length", "4"])
    torch.cuda.synchronize()
    launches = B.launch_counts()
    log(f"[4i] train.main --deform_dtype bfloat16: {it} iterations in "
        f"{time.perf_counter() - t0:.1f} s; kernel launches {launches}; "
        f"losses {result.losses}; PSNR {result.test_psnrs}")
    net = result.field.net
    if net.dtype != torch.bfloat16 or launches["blend_bwd"] < it:
        raise AssertionError(f"4i: {net.dtype}, launches {launches}")
    values = [v for _, v in result.losses] + list(result.test_psnrs.values())
    if not (all(math.isfinite(v) for v in values) and it in result.test_psnrs):
        raise AssertionError(f"4i: loss or PSNR not finite: {result.losses}")
    check_checkpoint_render(dev, mp, it, 6, "4i")
    mlp = exp_r5_mlp.main(["--reps", "20"])
    log(f"[4i] tools/exp_r5_mlp: {json.dumps(mlp)}")
    # what the MLP's forward + backward spends in each dtype
    from d3gs_tpu_torch.models.deform.fields import (DeformFieldSpec,
                                                     create_deform_field)
    xyz = exp_r5_mlp.make_inputs(dev)
    for dtype in ("float32", "bfloat16"):
        fld = create_deform_field(DeformFieldSpec(
            kind="baseline", is_blender=True, compute_dtype=dtype),
            device=dev)

        def fwd_bwd():
            x = xyz.detach().requires_grad_()
            dx, dr, ds = fld.step(x, 0.5)
            loss = (dx * dx).sum() + (dr * dr).sum() + (ds * ds).sum()
            return torch.autograd.grad(loss, [*fld.net.parameters(), x])
        log(f"[4i] profile of the MLP's forward + backward in {dtype}: "
            f"{json.dumps(profile(fwd_bwd, calls=5, top=10))}")
    return {"launches": launches, "mlp": mlp}


# 4j: the render modes at the JAX defaults: mode -> (output directory,
# frames); `view` renders `wander_path`'s 60
EVAL_MODES = {"time": ("interpolate", 150), "view": ("interpolate_view", 60),
              "pose": ("interpolate_pose", 150),
              "all": ("interpolate_all", 150),
              "original": ("interpolate_hyper_view", 150)}
# 4j: the card's metrics against the CPU's on the same PNGs: PSNR (dB) and
# SSIM absolute, LPIPS relative
EVAL_TOL = {"PSNR": 1e-4, "SSIM": 1e-5, "LPIPS": 1e-4}
FULL_EVAL_ITERATIONS = 200       # 4j: full_eval's training run


def _mode_cameras(RM, views):
    """The cameras each mode of `render.main` renders, at its defaults."""
    v = views[0]
    return {"time": RM.time_cameras(v),
            "view": RM.view_cameras(v, *RM.reference_rt(v)),
            "pose": RM.pose_cameras(v, views[-1]),
            "all": RM.all_cameras(v), "original": RM.original_cameras(views)}


def _metrics_close(card: dict, cpu: dict, what: str) -> dict:
    """The largest card-vs-CPU gap per metric over `card` (a results.json
    or per_view.json dict); raises beyond EVAL_TOL."""
    gaps = {}
    for method, vals in cpu.items():
        for key, tol in EVAL_TOL.items():
            ref, got = vals[key], card[method][key]
            if not isinstance(ref, dict):
                ref, got = {"mean": ref}, {"mean": got}
            if ref.keys() != got.keys():
                raise AssertionError(f"4j {what} {key}: {got} vs {ref}")
            for view, r in ref.items():
                g = got[view]
                if r is None or g is None:
                    if r is not g:
                        raise AssertionError(f"4j {what} {key} {view}: "
                                             f"{g} vs {r}")
                    continue
                gap = abs(g - r) / (abs(r) if key == "LPIPS" else 1.0)
                gaps[key] = max(gaps.get(key, 0.0), gap)
                if not gap <= tol:
                    raise AssertionError(f"4j {what} {key} {view}: card {g} "
                                         f"vs CPU {r} (tolerance {tol})")
    return gaps


def eval_path(dev, data, mp, root) -> dict:
    """Phase 4j: the evaluation path on 4b's checkpoint (`mp`, ~78,500
    Gaussians, the 8x256 Blender MLP, 400x400, SH 3): `render.main` in each
    of the five interpolation modes at the JAX defaults (each mode's frame
    count in renders/ and depth/, at least one forward launch a frame, one
    frame held against the plain blend within 1 of 255, the frame time with
    and without the PNG writes), `--trajectories` ((150, N_alive, 3)),
    `metrics.main` without LPIPS weights (LPIPS null) and with random ones
    (LPIPS_WEIGHTS), each held against `evaluate_model_paths(...,
    device="cpu")` on the same PNGs, LPIPS's time per 400x400 pair,
    `full_eval.main` on a copy of the dataset as <root>/lego, and the camera
    resize (`resolution=2`) against `data/resize.py` on the host."""
    import shutil
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch import full_eval
    from d3gs_tpu_torch import metrics as M
    from d3gs_tpu_torch import render as R
    from d3gs_tpu_torch.data.cameras import camera_from_info
    from d3gs_tpu_torch.data.dataset_readers import \
        read_cameras_from_transforms
    from d3gs_tpu_torch.data.image_io import read_png
    from d3gs_tpu_torch.data.resize import resize
    from d3gs_tpu_torch.data.scene import Scene
    from d3gs_tpu_torch.models.deform.fields import (create_deform_field,
                                                     load_deform_weights)
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.render_eval import lpips as L
    from d3gs_tpu_torch.render_eval import render_modes as RM
    from d3gs_tpu_torch.render_eval.metrics import evaluate_model_paths
    from d3gs_tpu_torch.train.flagship import pick_field_spec
    t_start = time.perf_counter()
    os.makedirs(root)
    it = TRAIN_ITERATIONS
    cfg = C.ModelParams(**C.load_cfg_args(mp))
    scene = Scene(cfg, load_iteration=-1, shuffle=False, device=dev)
    state = scene.gaussians
    fld = load_deform_weights(mp, create_deform_field(
        pick_field_spec(cfg, C.OptimizationParams()), device=dev))
    bg = torch.zeros(3, device=dev)
    render_at = RM.make_render_fn(state, fld, C.PipelineParams())
    cams = _mode_cameras(RM, scene.get_test_cameras())
    n_alive = int(state.alive.sum())
    launches, modes = {}, {}
    for mode, (sub, n) in EVAL_MODES.items():
        reset_counts()
        out = R.main(["-m", mp, "--mode", mode])
        torch.cuda.synchronize()
        launches[mode] = B.launch_counts()["blend_fwd"]
        base = os.path.join(mp, "test", f"{sub}_{it}")
        counts = [len([f for f in os.listdir(os.path.join(base, d))
                       if f.endswith(".png")]) for d in ("renders", "depth")]
        if out.get("frames") != n or counts != [n, n] or len(cams[mode]) != n:
            raise AssertionError(f"4j {mode}: {out}, PNGs {counts}, "
                                 f"{len(cams[mode])} cameras, want {n}")
        if launches[mode] < n:
            raise AssertionError(f"4j {mode}: blend_fwd launched "
                                 f"{launches[mode]} times for {n} frames")
        k = n // 2
        plain = B.blend_forward_torch(
            *stages(state, cams[mode][k], fld, bg)[:2], bg,
            tiles_x=(WIDTH + 15) // 16, tiles_y=(HEIGHT + 15) // 16,
            width=WIDTH, height=HEIGHT)
        want = (255 * plain.image.clamp(0, 1)).to(torch.uint8).cpu().numpy()
        got = read_png(os.path.join(base, "renders", f"{k:05d}.png"))
        diff = int(np.abs(got.astype(int) - want.astype(int)).max())
        # the same frames without the PNG writes
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for cam in cams[mode]:
            render_at(state, fld, cam, bg)
        end.record()
        torch.cuda.synchronize()
        modes[mode] = {"frames": n, "launches": launches[mode],
                       "frame_diff_of_255": diff, "coverage": round(float(
                           (got.max(axis=-1) > 0).mean()), 4),
                       "ms_per_frame_with_png": 1e3 * out["seconds"] / n,
                       "ms_per_frame_render_only":
                           start.elapsed_time(end) / n}
        log(f"[4j] render.main --mode {mode}: {json.dumps(modes[mode])}")
        if diff > 1:
            raise AssertionError(f"4j {mode}: frame {k} disagrees with the "
                                 f"plain blend by {diff} of 255")

    reset_counts()
    out = R.main(["-m", mp, "--mode", "render", "--trajectories"])
    torch.cuda.synchronize()
    launches["trajectories"] = B.launch_counts()["blend_fwd"]
    traj = np.load(os.path.join(mp, "trajectories.npy"), mmap_mode="r")
    traj_info = {**out["trajectories"], "bytes": os.path.getsize(
        os.path.join(mp, "trajectories.npy"))}
    log(f"[4j] render.main --trajectories: {json.dumps(traj_info)} on "
        f"{n_alive} Gaussians")
    if traj.shape != (150, n_alive, 3) or not np.isfinite(traj[-1]).all():
        raise AssertionError(f"4j: trajectories {traj.shape}")

    saved_env = os.environ.pop("LPIPS_WEIGHTS", None)
    if os.path.exists("lpips_vgg.npz"):
        raise AssertionError("4j: ./lpips_vgg.npz exists; the run without "
                             "weights needs none")
    try:
        metrics = {}
        for tag, npz in (("no_weights", None), ("random_weights", os.path.join(
                root, "lpips_random.npz"))):
            if npz:
                os.environ["LPIPS_WEIGHTS"] = L.write_random_weights(npz, 0)
            t0 = time.perf_counter()
            card = M.main(["-m", mp])[mp]
            card_s = time.perf_counter() - t0
            with open(os.path.join(mp, "per_view.json")) as f:
                card_pv = json.load(f)
            cpu = evaluate_model_paths([mp], device="cpu")[mp]
            with open(os.path.join(mp, "per_view.json")) as f:
                cpu_pv = json.load(f)
            if list(card) != [f"ours_{it}"] or (
                    card[f"ours_{it}"]["LPIPS"] is None) != (npz is None):
                raise AssertionError(f"4j metrics ({tag}): {card}")
            gaps = {**_metrics_close(card, cpu, f"{tag} results"),
                    **{f"{k}_per_view": v for k, v in _metrics_close(
                        card_pv, cpu_pv, f"{tag} per_view").items()}}
            metrics[tag] = {"card": card[f"ours_{it}"], "seconds": card_s,
                            "card_vs_cpu": gaps}
            log(f"[4j] metrics.main ({tag}): {json.dumps(metrics[tag])}")
        params = L.load_params(device=dev)
        a, b = (torch.from_numpy(read_png(os.path.join(
            mp, "test", f"ours_{it}", d, "00000.png")).astype(np.float32)
            / 255).to(dev) for d in ("renders", "gt"))
        lpips_ms = cuda_ms(lambda: L.lpips(params, a, b), reps=20)
        log(f"[4j] LPIPS (VGG16, random weights) per {a.shape[1]}x"
            f"{a.shape[0]} pair: "
            f"{lpips_ms:.3f} ms")
    finally:
        os.environ.pop("LPIPS_WEIGHTS", None)
        if saved_env is not None:
            os.environ["LPIPS_WEIGHTS"] = saved_env

    lego = os.path.join(root, "dnerf", "lego")
    shutil.copytree(data, lego)
    reset_counts()
    t0 = time.perf_counter()
    paths = full_eval.main(["--dnerf_path", os.path.join(root, "dnerf"),
                            "--scenes", "lego", "--iterations",
                            str(FULL_EVAL_ITERATIONS), "--output_path",
                            os.path.join(root, "eval")])
    torch.cuda.synchronize()
    launches["full_eval"] = B.launch_counts()
    with open(os.path.join(paths[0], "results.json")) as f:
        fe = json.load(f)
    fe_psnr = fe.get(f"ours_{FULL_EVAL_ITERATIONS}", {}).get("PSNR")
    log(f"[4j] full_eval.main (lego, {FULL_EVAL_ITERATIONS} iterations): "
        f"{json.dumps(fe)} in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches['full_eval']}")
    if not (fe_psnr is not None and math.isfinite(fe_psnr)) or \
            launches["full_eval"]["blend_bwd"] < FULL_EVAL_ITERATIONS:
        raise AssertionError(f"4j full_eval: {fe}, {launches['full_eval']}")

    info = read_cameras_from_transforms(data, "transforms_test.json",
                                        False)[0]
    cam = camera_from_info(info, device=dev, resolution=2)
    half = (round(info.width / 2), round(info.height / 2))
    host = resize((np.clip(info.image, 0, 1) * 255).astype(np.uint8),
                  half).astype(np.float32) / 255.0
    if (cam.width, cam.height) != half or not np.array_equal(
            cam.image.cpu().numpy(), host):
        raise AssertionError(f"4j resize: {cam.width}x{cam.height}")
    seconds = time.perf_counter() - t_start
    log(f"[4j] camera_from_info(resolution=2): {info.width}x{info.height} "
        f"-> {cam.width}x{cam.height}, equal to data/resize.py on the host; "
        f"4j took {seconds:.1f} s")
    return {"launches": launches, "modes": modes, "trajectories": traj_info,
            "metrics": metrics, "lpips_ms": lpips_ms, "full_eval": fe,
            "seconds": seconds}


# --------------------------------------------------------------------------
# 4k: the SAM trainer, the forecaster, ode_demo, the viewer, train_loops
# --------------------------------------------------------------------------

SAM_ITERATIONS, SAM_WARM_UP = 260, 50   # 4k-a: 211 deform steps
SAM_MASKS = 64
# 4k-a: one deform step with the mask term, card against CPU: the loss
# within 1e-4 relative, the gradients within 2e-3 of the largest (the
# blend backward alone agrees to 2e-4; index_add sums in another order)
SAM_LOSS_RTOL, SAM_GRAD_ERR = 1e-4, 2e-3
SAM_TIME_REPS = 20               # 4k-a: steps in each timed reading
FORECAST_CHECK_ERR = 1e-4        # 4k-b: card vs CPU forward, of the largest
ODE_DEMO_ITERATIONS = 20         # 4k-c: each demo (the CLI's default is 400)
GUI_TRAIN_ITERATIONS = 50        # 4k-d: train_gui's training route
SWEEP_ITERATIONS = 4             # 4k-e: each train_loops run (2 warm-up)


def sam_step_setup(where, data, mp, num_masks):
    """The SAM run's checkpoint (Gaussians, deform weights) on `where`,
    its first train camera with that camera's cached SLIC label map, and
    the trainer's mask term -> (cfg, scene, camera, labels, field, extra)."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.data.scene import Scene
    from d3gs_tpu_torch.models.deform.fields import (create_deform_field,
                                                     load_deform_weights)
    from d3gs_tpu_torch.train import sam_reg as S
    from d3gs_tpu_torch.train.flagship import pick_field_spec
    cfg = C.ModelParams(**C.load_cfg_args(mp))
    scene = Scene(cfg, load_iteration=-1, shuffle=False, device=where)
    cam = scene.get_train_cameras()[0]
    lab = np.load(os.path.join(data, "sam_masks_cache",
                               f"{cam.image_name}_mask.npy"))
    labels = torch.as_tensor(np.clip(lab, 0, num_masks), dtype=torch.int32,
                             device=where)
    field = load_deform_weights(mp, create_deform_field(
        pick_field_spec(cfg, C.OptimizationParams()), device=where))

    def extra(out, deform_out, camera, state, lab_):
        dx, dr, ds = deform_out
        return 0.5 * S.mask_regularization(
            lab_, num_masks, state.params.xyz + dx, camera.projmatrix,
            dx, dr, ds, state.alive, camera.width, camera.height)
    return cfg, scene, cam, labels, field, extra


def sam_step_card_vs_cpu(dev, data, mp, num_masks) -> dict:
    """One deform step with the mask term from the SAM run's checkpoint
    and its cached SLIC label map, on the card and on the CPU: the loss
    and the deform gradients."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.train.step import make_loss_and_grads
    res = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        cfg, scene, cam, labels, field, extra = sam_step_setup(
            where, data, mp, num_masks)
        step = make_loss_and_grads(
            opt_cfg=C.OptimizationParams(), pipe_cfg=C.PipelineParams(),
            deform_fn=lambda xyz, fid, it, g: field.step(xyz, fid),
            deform_params=list(field.net.parameters()), extra_loss_fn=extra)
        t0 = time.perf_counter()
        r = step(scene.gaussians, cam, 5000, None,
                 torch.zeros(3, device=where), labels)
        reg = extra(None, field.step(scene.gaussians.params.xyz, cam.fid),
                    cam, scene.gaussians, labels)
        if where.type == "cuda":
            torch.cuda.synchronize()
        res[name] = {"loss": float(r.loss), "reg": float(reg.detach()),
                     "grads": [g.cpu() for g in r.deform],
                     "s": time.perf_counter() - t0}
    card, cpu = res["card"], res["cpu"]
    scale = max(float(g.abs().max()) for g in cpu["grads"])
    err = max(float((a - b).abs().max()) for a, b in zip(card["grads"],
                                                         cpu["grads"])) / scale
    out = {"loss_card": card["loss"], "loss_cpu": cpu["loss"],
           "loss_rel_err": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
           "reg_card": card["reg"], "reg_cpu": cpu["reg"],
           "grad_err_of_largest": err, "cpu_step_s": cpu["s"]}
    log(f"[4k-a] one deform step with the mask term, card vs CPU on "
        f"{cam.image_name}: {json.dumps(out)} (tol loss {SAM_LOSS_RTOL} "
        f"relative, gradients {SAM_GRAD_ERR} of the largest)")
    if not (out["loss_rel_err"] <= SAM_LOSS_RTOL and err <= SAM_GRAD_ERR
            and card["reg"] > 0):
        raise AssertionError(f"4k-a: card and CPU differ: {out}")
    return out


def sam_step_timings(dev, data, mp, num_masks) -> dict:
    """The deform-phase train step (Adam included) with and without the
    mask term, on the same checkpoint, camera and label map: CUDA events
    around SAM_TIME_REPS steps each, in the order plain, mask, mask,
    plain, so that drift shows as a gap between the two readings."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.train.step import make_train_step
    cfg, scene, cam, labels, field, extra = sam_step_setup(
        dev, data, mp, num_masks)
    bg, dstate = torch.zeros(3, device=dev), field.init_state()
    state = scene.gaussians
    steps = {k: make_train_step(
        opt_cfg=C.OptimizationParams(), pipe_cfg=C.PipelineParams(),
        deform_fn=lambda xyz, fid, it, g: field.step(xyz, fid),
        deform_params=list(field.net.parameters()),
        deform_update_fn=field.update, extra_loss_fn=fn)
        for k, fn in (("plain", None), ("mask", extra))}
    ms = {"plain": [], "mask": []}
    for k in ("plain", "mask", "mask", "plain"):
        ms[k].append(cuda_ms(lambda k=k: steps[k](
            state, dstate, cam, 5000, None, bg, labels), SAM_TIME_REPS))
    out = {"gaussians": int(state.num_alive), "camera": cam.image_name,
           "reps": SAM_TIME_REPS, "plain_step_ms": ms["plain"],
           "mask_step_ms": ms["mask"],
           "ratio": sum(ms["mask"]) / sum(ms["plain"])}
    log(f"[4k-a] deform train step with and without the mask term, same "
        f"state and camera: {json.dumps(out)}")
    if not all(math.isfinite(v) and v > 0 for v in ms["plain"] + ms["mask"]):
        raise AssertionError(f"4k-a step timings: {out}")
    return out


def hooks_check(dev, data) -> dict:
    """`train_baseline` for a few iterations at full width with a recording
    tb_writer and a live_hook: the JAX trainer's tags at its steps."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.data.scene import Scene
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.train.baseline import train_baseline
    from d3gs_tpu_torch.train.recording_writer import RecordingWriter
    model = C.ModelParams(source_path=data, eval=True, is_blender=True,
                          sh_degree=3)
    opt = C.OptimizationParams(iterations=6, warm_up=3)
    scene = Scene(model, seed=0, device=dev)
    writer, hooks = RecordingWriter(), []
    reset_counts()
    train_baseline(
        gaussians=scene.gaussians, train_cams=scene.get_train_cameras(),
        test_cams=scene.get_test_cameras(),
        cameras_extent=scene.cameras_extent, model_cfg=model, opt_cfg=opt,
        pipe_cfg=C.PipelineParams(), test_iterations={4, 6}, seed=0,
        log_every=2, tb_writer=writer, progress=False,
        live_hook=lambda st, ds, field, it: hooks.append(
            (it, st.num_alive, field.spec.kind)))
    torch.cuda.synchronize()
    launches = B.launch_counts()
    steps = {}
    for e in writer.events:
        steps.setdefault(e[1], []).append(e[2])
    want = {"train_loss_patches/total_loss": [1, 2, 4, 6],
            "train_loss_patches/l1_loss": [1, 2, 4, 6],
            "total_points": [1, 2, 4, 6], "iter_time": [1, 2, 4, 6],
            "test/psnr": [4, 6], "scene/opacity_histogram": [4, 6],
            "test_view_0/render": [4, 6], "test_view_1/render": [4, 6],
            "test_view_0/ground_truth": [4],
            "test_view_1/ground_truth": [4]}
    images = {e[3] for e in writer.events if e[0] == "image"}
    log(f"[4k-a] train_baseline with a recording tb_writer and a live_hook, "
        f"6 iterations: tags at steps {json.dumps(steps)}, image shapes "
        f"{sorted(images)}, hook calls {hooks}; kernel launches {launches}")
    if (steps != want or [h[0] for h in hooks] != [1, 2, 4, 6]
            or images != {(HEIGHT, WIDTH, 3)}
            or launches["blend_bwd"] < 6):
        raise AssertionError(f"4k-a hooks: {steps}, {hooks}, {launches}")
    return {"tags": len(steps), "hooks": len(hooks), "launches": launches}


def sam_path(dev, data, root) -> dict:
    """Phase 4k-a: `python -m d3gs_tpu_torch.train_baseline_sam` in process
    on a copy of 4b's dataset and point cloud at full width (43,132
    Gaussians, 400x400, SH 3, the 8x256 Blender MLP), --segmenter slic
    with 64 masks, SAM_ITERATIONS iterations after a SAM_WARM_UP warm-up;
    the regularizer watched at every deform step, the kernels' counts
    read around the trainer; then one step card against CPU and the
    trainers' hooks."""
    import shutil
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.train import sam_reg as S
    from d3gs_tpu_torch.train_baseline_sam import main as sam_main
    t_start = time.perf_counter()
    data_s = os.path.join(root, "data_sam")
    shutil.copytree(data, data_s)
    mp = os.path.join(root, "sam")
    regs, stamps = [], []
    real = S.mask_regularization

    def watch(*args, **kw):
        value = real(*args, **kw)
        regs.append(value.detach())
        stamps.append(time.perf_counter())
        return value

    S.mask_regularization = watch
    reset_counts()
    t0 = time.perf_counter()
    try:
        result = sam_main([
            "-s", data_s, "-m", mp, "--eval", "--is_blender", "--quiet",
            "--sh_degree", "3", "--iterations", str(SAM_ITERATIONS),
            "--warm_up", str(SAM_WARM_UP), "--segmenter", "slic",
            "--num_masks", str(SAM_MASKS), "--test_iterations",
            str(SAM_ITERATIONS), "--save_iterations", str(SAM_ITERATIONS)])
        torch.cuda.synchronize()
    finally:
        S.mask_regularization = real
    wall = time.perf_counter() - t0
    launches = B.launch_counts()
    deform_steps = SAM_ITERATIONS - SAM_WARM_UP + 1
    regs = [float(r) for r in regs]
    step_ms = 1e3 * (stamps[-1] - stamps[0]) / max(len(stamps) - 1, 1)
    cache = sorted(os.listdir(os.path.join(data_s, "sam_masks_cache")))
    out = {"seconds": wall, "deform_steps": len(regs),
           "reg_first": regs[0] if regs else None,
           "reg_last": regs[-1] if regs else None,
           "test_psnr": result.test_psnrs.get(SAM_ITERATIONS),
           "deform_step_ms_host_interval": step_ms, "launches": launches,
           "label_cache": cache}
    log(f"[4k-a] train_baseline_sam.main (slic, {SAM_MASKS} masks): "
        f"{json.dumps(out)}; losses {result.losses}")
    n_eval = 2
    if (len(regs) != deform_steps or not all(math.isfinite(r) and r >= 0
                                             for r in regs)
            or not regs[0] > 0):
        raise AssertionError(f"4k-a: regularizer {regs[:3]}...{regs[-3:]} "
                             f"over {len(regs)} of {deform_steps} steps")
    if (launches["blend_bwd"] < SAM_ITERATIONS
            or launches["blend_fwd"] < SAM_ITERATIONS + n_eval):
        raise AssertionError(f"4k-a: launches {launches}")
    if not (out["test_psnr"] is not None and math.isfinite(out["test_psnr"])
            and len(cache) == 4):
        raise AssertionError(f"4k-a: PSNR {result.test_psnrs}, cache {cache}")
    out["card_vs_cpu"] = sam_step_card_vs_cpu(dev, data_s, mp, SAM_MASKS)
    out["step_timings"] = sam_step_timings(dev, data_s, mp, SAM_MASKS)
    out["hooks"] = hooks_check(dev, data)
    out["phase_seconds"] = time.perf_counter() - t_start
    return out


def forecast_path(dev, traj_path, root) -> dict:
    """Phase 4k-b: `python -m d3gs_tpu_torch.forecast` at its defaults
    (d_model 128, 4 heads, 4+4 layers, past 80, future 30, stride 10,
    batch 1024, 5,000 Gaussians) on 4j's (150, N, 3) trajectories for one
    epoch; the training step and the rollout timed by CUDA events; a
    forward of the same weights on the card against the CPU."""
    from d3gs_tpu_torch.forecast import __main__ as FM
    from d3gs_tpu_torch.forecast import train as FT
    from d3gs_tpu_torch.forecast.model import (TrajectoryForecaster,
                                               normalize_window)
    from d3gs_tpu_torch.ops import blend as B
    t_start = time.perf_counter()
    reset_counts()
    t0 = time.perf_counter()
    metrics = FM.main(["--trajectories", traj_path, "--output_dir",
                       os.path.join(root, "forecast"), "--epochs", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    traj = np.load(traj_path)
    if traj.shape[1] > 5000:        # the CLI's subsample
        traj = traj[:, np.random.default_rng(0).choice(
            traj.shape[1], 5000, replace=False)]
    past, future = FT.make_windows(traj, 80, 30, 10)
    model = TrajectoryForecaster(seed=1).to(dev)
    state = FT.init_state(model)
    step = FT.make_train_step(model)
    pb = torch.as_tensor(past[:1024], device=dev)
    fb = torch.as_tensor(future[:1024], device=dev)

    def one():
        nonlocal state
        state, _ = step(state, pb, fb)
    step_ms = cuda_ms(one, reps=10)
    step_prof = profile(one, calls=3, top=6)
    n_val = max(int(len(past) * 0.1), 1)
    pv = torch.as_tensor(past[:n_val], device=dev)
    rollout_ms = cuda_ms(lambda: FT.forecast(model, pv, 30), reps=1,
                         warmup=1)
    with torch.no_grad():
        pn, mu, sd = normalize_window(pb[:64])
        fut_in = torch.cat([pn[:, -1:], ((fb[:64] - mu) / sd)[:, :-1]],
                           dim=1)
        card = model(pn, fut_in).cpu()
        cpu_model = TrajectoryForecaster(seed=1)
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        ref = cpu_model(pn.cpu(), fut_in.cpu())
    err = float((card - ref).abs().max() / ref.abs().max())
    out = {"metrics": metrics, "cli_seconds": wall,
           "windows": int(len(past)), "train_step_ms": step_ms,
           "train_step_profile": step_prof,
           "rollout_ms": rollout_ms, "rollout_windows": n_val,
           "card_vs_cpu_of_largest": err,
           "blend_launches": sum(B.launch_counts().values()),
           "phase_seconds": time.perf_counter() - t_start}
    log(f"[4k-b] forecast.main at its defaults, 1 epoch: {json.dumps(out)} "
        f"(card vs CPU forward on 64 windows, tol {FORECAST_CHECK_ERR} of "
        f"the largest)")
    if not (all(math.isfinite(v) for v in metrics.values())
            and err <= FORECAST_CHECK_ERR):
        raise AssertionError(f"4k-b: {out}")
    return out


def ode_demo_path(root) -> dict:
    """Phase 4k-c: `python -m d3gs_tpu_torch.ode_demo` with both demos at
    ODE_DEMO_ITERATIONS iterations (the rest at the CLI's defaults)."""
    from d3gs_tpu_torch import ode_demo
    out = {}
    for demo in ("spiral", "sine3d"):
        t0 = time.perf_counter()
        mse = ode_demo.main(["--demo", demo, "--iterations",
                             str(ODE_DEMO_ITERATIONS), "--out",
                             os.path.join(root, "ode_demo")])
        torch.cuda.synchronize()
        out[demo] = {"rollout_mse": mse,
                     "seconds": time.perf_counter() - t0}
    log(f"[4k-c] ode_demo.main, {ODE_DEMO_ITERATIONS} iterations: "
        f"{json.dumps(out)}")
    if not all(math.isfinite(v["rollout_mse"]) for v in out.values()):
        raise AssertionError(f"4k-c: {out}")
    return out


def viewer_path(dev, data, mp, root) -> dict:
    """Phase 4k-d: `train_gui --view_only --no_gui` on 4b's checkpoint in a
    subprocess (three loopback frames, SIGINT); in process, `GUI.test_step`
    on the same checkpoint at a fixed fid against the plain blend of its
    camera; `train_gui --no_gui`'s training route (GUI_TRAIN_ITERATIONS
    iterations on 4b's dataset at full width) while a client takes frames
    through its live_hook."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.data.scene import Scene
    from d3gs_tpu_torch.models.deform.fields import (create_deform_field,
                                                     load_deform_weights)
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.train.flagship import pick_field_spec
    from d3gs_tpu_torch.viewer.client import (client_message, look_from_z,
                                              serve_train_gui)
    from d3gs_tpu_torch.viewer.gui import GUI
    t_start = time.perf_counter()
    common = ["-s", data, "--is_blender", "--sh_degree", "3"]
    msg = client_message(WIDTH, HEIGHT, *look_from_z(4.0))
    view = serve_train_gui(["-m", mp, "--view_only", *common], 3, msg)
    cover = [float((img.max(axis=-1) > 0).mean())
             for img, _, _, _ in view["frames"]]
    log(f"[4k-d] train_gui --view_only --no_gui on 4b's checkpoint: 3 "
        f"frames of {WIDTH}x{HEIGHT}, coverage {cover}, at "
        f"{[round(f[3], 2) for f in view['frames']]} s (listening after "
        f"{view['startup_s']:.1f} s); exit code after SIGINT {view['rc']}")
    if view["rc"] != 0 or min(cover) <= 0.05:
        raise AssertionError(f"4k-d view_only: rc {view['rc']}, coverage "
                             f"{cover}: {view['output'][-3000:]}")

    cfg = C.ModelParams(**C.load_cfg_args(mp))
    scene = Scene(cfg, load_iteration=-1, shuffle=False, device=dev)
    fld = load_deform_weights(mp, create_deform_field(
        pick_field_spec(cfg, C.OptimizationParams()), device=dev))
    gui = GUI(scene.gaussians, width=WIDTH, height=HEIGHT, radius=4.0,
              deform_fn=lambda xyz, fid: fld.step(xyz, fid))
    gui.cam.orbit(150.0, 40.0)
    gui.playing, gui.fid = False, 0.5
    reset_counts()
    frame = gui.test_step()
    torch.cuda.synchronize()
    gui_launches = B.launch_counts()["blend_fwd"]
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        cam = gui._camera()
        rec, bins, grid = stages(scene.gaussians, cam, fld, bg)
        plain = B.blend_forward_torch(rec, bins, bg, **grid).image.clamp(
            0, 1).cpu().numpy()
    err = np.abs(frame - plain)
    gui_err = float(err.max())
    log(f"[4k-d] GUI.test_step at fid 0.5 on 4b's checkpoint: max "
        f"|frame - plain blend| {gui_err:.3e} (tol {ATOL} + {RTOL}|ref|), "
        f"coverage {float((frame.max(-1) > 0).mean()):.3f}, "
        f"{gui.infer_ms:.2f} ms, blend_fwd launches {gui_launches}")
    if gui_launches < 1 or (err > ATOL + RTOL * np.abs(plain)).any():
        raise AssertionError(f"4k-d GUI.test_step: launches {gui_launches}, "
                             f"max err {gui_err}")

    train = serve_train_gui(["-m", os.path.join(root, "gui"), *common,
                             "--iterations", str(GUI_TRAIN_ITERATIONS),
                             "--warm_up", "20"], 6, msg, wait_done=True)
    during = sum(1 for _, _, d, _ in train["frames"] if not d)
    log(f"[4k-d] train_gui --no_gui, {GUI_TRAIN_ITERATIONS} iterations: "
        f"{len(train['frames'])} frames, {during} of them through the "
        f"live_hook during training, at "
        f"{[round(f[3], 2) for f in train['frames']]} s; exit code after "
        f"SIGINT {train['rc']}")
    if (train["rc"] != 0 or during < 1
            or "training done" not in train["output"]
            or any(img.shape != (HEIGHT, WIDTH, 3)
                   for img, _, _, _ in train["frames"])):
        raise AssertionError(f"4k-d training route: rc {train['rc']}, "
                             f"{during} frames during training: "
                             f"{train['output'][-3000:]}")
    return {"view_only_coverage": cover, "gui_err": gui_err,
            "gui_launches": gui_launches, "train_frames": len(
                train["frames"]), "train_frames_during": during,
            "phase_seconds": time.perf_counter() - t_start}


def sweep_path(dev, data_f, root) -> dict:
    """Phase 4k-e: `python -m d3gs_tpu_torch.train_loops` on 4d's 12-view
    set with --sequence_lengths 6 12, SWEEP_ITERATIONS iterations each
    (the flagship trainer's MLP kind, its default k), the blend kernels'
    counts read around it."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch import train_loops
    from d3gs_tpu_torch.ops import blend as B
    t0 = time.perf_counter()
    reset_counts()
    res = train_loops.main([
        "-s", data_f, "-m", os.path.join(root, "sweep"), "--eval",
        "--is_blender", "--quiet", "--sh_degree", "3", "--iterations",
        str(SWEEP_ITERATIONS), "--warm_up", "2", "--sequence_lengths", "6",
        "12"])
    torch.cuda.synchronize()
    launches = B.launch_counts()
    k = C.OptimizationParams().num_cams_per_iter
    out = {"best_psnr": res, "launches": launches, "k": k,
           "seconds": time.perf_counter() - t0}
    log(f"[4k-e] train_loops.main --sequence_lengths 6 12: "
        f"{json.dumps(out)}")
    steps = 2 * SWEEP_ITERATIONS
    if (sorted(res) != [6, 12] or not all(math.isfinite(v)
                                          for v in res.values())
            or launches["blend_bwd"] < steps
            or launches["blend_fwd"] < steps + 2 * FLAGSHIP_VIEWS[1]):
        raise AssertionError(f"4k-e: {out}")
    return out


# --------------------------------------------------------------------------
# 4l: multi-GPU (d3gs_tpu_torch/parallel/) on the one card
# --------------------------------------------------------------------------

STRIP_MESHES = (2, 4)            # 4l-a: strips of the bench frame
MESH_ITERATIONS = 6              # 4l-b: each torchrun run (3 warm-up)
MESH_LOSS_RTOL = 1e-5            # 4l-b: its first loss vs 4d's
GLOO_K = 4                       # 4l-c: cameras of each gloo step
# 4l-c: sharded vs single-device step on the card, tests/test_parallel.py's
# tolerances (absolute, the loss relative)
GLOO_TOL = {"loss": 1e-5, "xyz": 2e-6, "opacity": 2e-6, "deform": 5e-6,
            "max_radii2d": 1e-6}
MESH_TIME_REPS = 3               # 4l-d: steps per reading


def strip_kernels(dev, state, cam, field, bg) -> dict:
    """Phase 4l-a: the bench frame (4d's ODE field at t = 0.5 off, phase
    3's MLP on) cut into D strips of ceil(25 / D) tile rows, D in
    STRIP_MESHES: both kernels on each strip at tile_y0 = s * rows held
    against their plain versions at the same offset (phase 3's bounds),
    the strips' images concatenated against the whole frame's (expected
    bit-equal) and the strips' record gradients summed against the whole
    frame's (2e-4 of the largest)."""
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.ops.binning import bin_splats_records
    from d3gs_tpu_torch.ops.rasterize import pack_records_full
    splats = stage_splats(state, cam, field)
    records = pack_records_full(splats)
    tiles_x = tiles_y = (WIDTH + 15) // 16
    full_grid = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=WIDTH,
                     height=HEIGHT)
    full_bins = bin_splats_records(splats, tiles_x=tiles_x, tiles_y=tiles_y)
    full = B.blend_forward_cuda(records, full_bins, bg, **full_grid)
    g_img, g_dep, g_alp = blend_loss_grads(full)
    g_full = B.blend_backward_cuda(records, full_bins, bg, full, g_img,
                                   g_dep, g_alp, **full_grid)
    out = {}
    for d in STRIP_MESHES:
        rows = -(-tiles_y // d)
        sh = rows * 16
        images, g_sum, errs = [], torch.zeros_like(g_full), []
        for s in range(d):
            y0 = s * rows
            bins = bin_splats_records(splats, tiles_x=tiles_x, tiles_y=rows,
                                      tile_y0=y0)
            grid = dict(tiles_x=tiles_x, tiles_y=rows, width=WIDTH,
                        height=sh, tile_y0=y0)
            name = f"4l strip {s} of {d} (tile_y0 = {y0})"
            errs.append((compare_blend(name, records, bins, bg, grid),
                         compare_blend_bwd(name, records, bins, bg, grid,
                                           BWD_TOL["bench"])))
            fwd = B.blend_forward_cuda(records, bins, bg, **grid)
            images.append(fwd.image)
            # the whole frame's upstream gradients on the strip's rows
            n = max(0, min(sh, HEIGHT - 16 * y0))
            gi, gd, ga = (torch.zeros((sh,) + t.shape[1:], device=dev)
                          for t in (g_img, g_dep, g_alp))
            for dst, src in ((gi, g_img), (gd, g_dep), (ga, g_alp)):
                dst[:n] = src[16 * y0:16 * y0 + n]
            g_sum += B.blend_backward_cuda(records, bins, bg, fwd, gi, gd,
                                           ga, **grid)
        frame_err = float((torch.cat(images)[:HEIGHT] - full.image).abs()
                          .max())
        grad_err = float((g_sum - g_full).abs().max()
                         / g_full.abs().max())
        out[d] = {"strip_h": sh, "padding_rows": d * sh - HEIGHT,
                  "max_abs_err_fwd_bwd": errs,
                  "strips_vs_frame_image": frame_err,
                  "strip_grads_vs_frame_of_largest": grad_err}
        log(f"[4l-a] {d} strips of {sh} rows: strips vs the whole frame "
            f"max |image| {frame_err:.3e} (expected 0), summed record "
            f"gradients {grad_err:.2e} of the largest (tol "
            f"{BWD_TOL['bench']})")
        if frame_err > ATOL or grad_err > BWD_TOL["bench"]:
            raise AssertionError(f"4l-a: strips disagree with the frame: "
                                 f"{out[d]}")
    return out


def run_group(cmd, timeout, **kw) -> subprocess.CompletedProcess:
    """subprocess.run in a session of its own, killed whole (torchrun and
    its workers) if it outlives `timeout`."""
    import signal
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True, **kw)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{cmd[:6]} timed out after {timeout} s:\n"
                             f"{out[-3000:]}")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, "")


def mesh_cli(dev, data, root, first_loss) -> dict:
    """Phase 4l-b: `torchrun --standalone --nproc_per_node 1 -m
    d3gs_tpu_torch.train --trainer flagship --is_ode --mesh_shape 1` on
    4d's set in both layouts, MESH_ITERATIONS iterations (warm-up to 3,
    the switch to Gaussian-only at 5, a densify pass at 4, an evaluation
    and a checkpoint), rank 0 on cuda:0 over NCCL; its checkpoint rendered
    by `render.main`. Each run's backend must read nccl, its first loss
    4d's (same seed and picks) within MESH_LOSS_RTOL, its blend launches
    cover its steps."""
    import re
    from d3gs_tpu_torch import render as R
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    it, k = MESH_ITERATIONS, FLAGSHIP_K
    out = {}
    for mode in ("camera", "gauss_tile"):
        mp = os.path.join(root, f"mesh_{mode}")
        t0 = time.perf_counter()
        run = run_group([
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1", "-m", "d3gs_tpu_torch.train",
            "-s", data, "-m", mp, "--eval", "--is_blender", "--trainer",
            "flagship", "--is_ode", "--D", "8", "--W", "256",
            "--num_cams_per_iter", str(k), "--iterations", str(it),
            "--warm_up", "3", "--use_iterative_update",
            "--iterative_update_interval", "5", "--max_training_switches",
            "1", "--sh_degree", "3", "--densify_from_iter", "3",
            "--densify_until_iter", str(it), "--densification_interval",
            "4", "--densify_grad_threshold", "1e-8", "--test_iterations",
            str(it), "--save_iterations", str(it), "--mesh_shape", "1",
            "--mesh_mode", mode], timeout=400, cwd=repo, env=env)
        wall = time.perf_counter() - t0
        text = run.stdout
        backend = re.search(r"^mesh: .*backend (\w+)", text, re.M)
        loss = re.search(rf"\[flagship 1/{it}\] loss \S+ \(step (\S+)\)",
                         text)
        launches = re.search(r"rank 0: blend kernel launches: forward "
                             r"(\d+), backward (\d+)", text)
        psnr = re.search(r"Best PSNR = (\S+)", text)
        if run.returncode or not (backend and loss and launches and psnr):
            raise AssertionError(f"4l-b {mode}: rc {run.returncode}:\n"
                                 f"{text[-4000:]}")
        rec = {"backend": backend.group(1), "first_loss": float(
            loss.group(1)), "launches": {"blend_fwd": int(launches.group(
                1)), "blend_bwd": int(launches.group(2))},
            "best_psnr": float(psnr.group(1)), "seconds": wall}
        rec["first_loss_vs_4d"] = abs(rec["first_loss"] - first_loss) / abs(
            first_loss)
        t1 = time.perf_counter()
        rendered = R.main(["-m", mp, "--mode", "render"])
        torch.cuda.synchronize()
        rec["render"] = rendered
        rec["render_seconds"] = time.perf_counter() - t1
        out[mode] = rec
        log(f"[4l-b] torchrun --nproc_per_node 1 --mesh_shape 1 --mesh_mode "
            f"{mode}: {json.dumps(rec)}")
        if (rec["backend"] != "nccl"
                or not rec["first_loss_vs_4d"] <= MESH_LOSS_RTOL
                or rec["launches"]["blend_bwd"] < it * k
                or rec["launches"]["blend_fwd"] < it * k + FLAGSHIP_VIEWS[1]
                or rendered != {"iteration": it,
                                "views": sum(FLAGSHIP_VIEWS)}
                or not math.isfinite(rec["best_psnr"])):
            raise AssertionError(f"4l-b {mode}: {rec} (4d's first loss "
                                 f"{first_loss})")
    return out


def _map_state(st, fn):
    """A GaussianState (or a DeformState) with `fn` applied to every
    tensor: moves one between the card and the host."""
    import dataclasses
    from d3gs_tpu_torch.models import gaussians as G
    if not isinstance(st, G.GaussianState):
        return dataclasses.replace(st, m=[fn(x) for x in st.m],
                                   v=[fn(x) for x in st.v])
    gp = lambda p: G.GaussianParams(*(fn(x) for x in p))  # noqa: E731
    return dataclasses.replace(
        st, params=gp(st.params), alive=fn(st.alive),
        grad_accum=fn(st.grad_accum), denom=fn(st.denom),
        max_radii2d=fn(st.max_radii2d),
        opt=G.AdamState(gp(st.opt.m), gp(st.opt.v), st.opt.count))


def _mesh_field(payload, dev):
    """-> (model config, opt config, the payload's deform field on dev)."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.models.deform.fields import create_deform_field
    from d3gs_tpu_torch.train.flagship import pick_field_spec
    model = C.ModelParams(**payload["model"])
    opt = C.OptimizationParams(**payload["opt"])
    field = create_deform_field(pick_field_spec(model, opt), seed=11,
                                device=dev, opt_cfg=opt)
    if payload.get("weights"):
        field.net.load_state_dict({k: v.to(dev) for k, v in
                                   payload["weights"].items()})
    return model, opt, field


def _step_result(st, field) -> dict:
    return {"xyz": st.params.xyz.cpu(), "opacity": st.params.opacity.cpu(),
            "max_radii2d": st.max_radii2d.cpu(),
            "deform": [p.detach().cpu() for p in field.net.parameters()]}


def _gloo_rank(rank, world, folder, shape, tasks):
    """One rank of phase 4l-c: gloo over a FileStore, on the payload's
    device (cuda:0) with the others. Runs `tasks` in order; writes
    rank<r>.pt."""
    import dataclasses
    import torch.distributed as dist
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.ops.sh import eval_sh_upto
    from d3gs_tpu_torch.parallel import comm
    from d3gs_tpu_torch.parallel import mesh as M
    from d3gs_tpu_torch.parallel import sharded as S
    payload = torch.load(os.path.join(folder, "payload.pt"),
                         weights_only=False)
    dev = torch.device(payload["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(folder, "store"), world), rank=rank, world_size=world)
    try:
        mesh = M.make_mesh_2d(*shape, dev) if shape else M.make_mesh(dev)
        cams = [dataclasses.replace(c, **{
            f: getattr(c, f).to(dev) for f in ("viewmatrix", "projmatrix",
                                               "campos", "image")})
                for c in payload["cams"]]
        bg = torch.zeros(3, device=dev)
        out = {"tile_y0": S.strip_grid(WIDTH, HEIGHT, mesh).tile_y0}
        for task in tasks:
            reset_counts()
            state = _map_state(payload["state"], lambda t: t.to(dev))
            if task == "render":
                st = M.shard_gaussian_state(state, mesh)
                cam = cams[0]
                dirs = st.params.xyz - cam.campos
                dirs = dirs / dirs.norm(dim=-1, keepdim=True).clamp_min(1e-8)
                colors = (eval_sh_upto(st.max_sh_degree, st.active_sh_degree,
                                       st.get_features, dirs)
                          + 0.5).clamp_min(0.0)
                fn = S.make_sharded_render(mesh, width=WIDTH, height=HEIGHT,
                                           pipe_cfg=C.PipelineParams())
                with torch.no_grad():
                    img = fn(st.params.xyz, st.get_scaling, st.get_rotation,
                             colors, st.get_opacity[:, 0], st.alive, cam, bg,
                             torch.zeros((st.capacity, 2), device=dev))[0]
                res = {"image": img.cpu()}
            else:
                model, opt, field = _mesh_field(payload, dev)
                kw = dict(opt_cfg=opt, pipe_cfg=C.PipelineParams(),
                          model_cfg=model, field=field)
                if task == "camera":
                    step = S.make_flagship_camera_parallel_step(mesh, **kw)
                else:
                    step = S.make_flagship_gauss_tile_step(
                        mesh, width=WIDTH, height=HEIGHT, **kw)
                    state = M.shard_gaussian_state(state, mesh)
                dstate = _map_state(payload["deform_state"],
                                    lambda t: t.to(dev))
                t0 = time.perf_counter()
                st, _, aux = step(state, dstate, cams,
                                  payload["iteration"], bg)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                nbytes = comm.bytes_moved()
                if task != "camera":
                    st = M.gather_gaussian_state(st, mesh)
                res = {"loss": float(aux.loss), **_step_result(st, field),
                       "bytes": nbytes, "seconds": seconds}
            res["launches"] = B.launch_counts()
            out[task] = res
        torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def gloo_ranks(dev, state, cams, root) -> dict:
    """Phase 4l-c: ranks that share the card over gloo (spawned by
    torch.multiprocessing around a FileStore, all on cuda:0; gloo's
    collectives take CUDA tensors through the host, `parallel/comm.py`),
    from 4d's checkpoint with a fresh 8x256 Blender deform MLP and the
    first GLOO_K of 4d's cameras by fid. One single-device step first sets
    the Adam moments (a first step from zero moments moves each parameter
    by ±lr whatever its gradient, so a gradient at rounding level would
    flip it); from there the sharded render at D = 4 against the
    single-device render, one camera-parallel flagship step at D = 2, one
    gauss+tile step at D = 4 and one on the 2 x 2 mesh, each against the
    single-device step on the card (GLOO_TOL). Also reads each layout's
    collective bytes per step and every rank's blend launches beside its
    strip's tile_y0."""
    import dataclasses
    import torch.multiprocessing as mp
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.models.renderer import render
    from d3gs_tpu_torch.train.flagship import make_batched_step
    bg = torch.zeros(3, device=dev)
    cams = sorted(cams, key=lambda c: c.fid)[:GLOO_K]
    payload = {"model": dict(is_blender=True, D=8, W=256, sh_degree=3),
               "opt": dict(num_cams_per_iter=GLOO_K), "iteration": 50,
               "device": str(dev)}
    mcfg, ocfg, fld = _mesh_field(payload, dev)

    def single_step(st, dstate):
        step = make_batched_step(opt_cfg=ocfg, pipe_cfg=C.PipelineParams(),
                                 model_cfg=mcfg, field=fld,
                                 update_gaussians=True, update_deform=True,
                                 use_deform=True)
        return step(st, dstate, cams, payload["iteration"], bg)

    st1, d1, _ = single_step(state, fld.init_state())
    payload.update(
        state=_map_state(st1, lambda t: t.cpu()),
        deform_state=_map_state(d1, lambda t: t.cpu()),
        weights={k: v.detach().cpu() for k, v in fld.net.state_dict()
                 .items()},
        cams=[dataclasses.replace(c, **{
            f: getattr(c, f).cpu() for f in ("viewmatrix", "projmatrix",
                                             "campos", "image")})
              for c in cams])
    runs = {"d4": (4, None, ["render", "gauss_tile"]),
            "d2": (2, None, ["camera"]), "2x2": (4, (2, 2), ["gauss_tile"])}
    results = {}
    for name, (world, shape, tasks) in runs.items():
        folder = os.path.join(root, f"gloo_{name}")
        os.makedirs(folder)
        torch.save(payload, os.path.join(folder, "payload.pt"))
        t0 = time.perf_counter()
        mp.spawn(_gloo_rank, args=(world, folder, shape, tasks),
                 nprocs=world)
        results[name] = [torch.load(os.path.join(folder, f"rank{r}.pt"),
                                    weights_only=False)
                         for r in range(world)]
        log(f"[4l-c] {world} gloo ranks on {dev} "
            f"({'x'.join(map(str, shape)) if shape else '1D'}): {tasks} in "
            f"{time.perf_counter() - t0:.1f} s; per rank tile_y0 and blend "
            f"launches: " + json.dumps([
                {"tile_y0": r["tile_y0"], **{t: r[t]["launches"]
                                             for t in tasks}}
                for r in results[name]]))

    # the single-device references on the card, from the same payload
    with torch.no_grad():
        ref_img = render(st1, cams[0], bg=bg).image.cpu()
    mcfg, ocfg, fld = _mesh_field(payload, dev)
    ref_st, _, ref_aux = single_step(
        st1, _map_state(payload["deform_state"], lambda t: t.to(dev)))
    ref = {"loss": float(ref_aux.loss), **_step_result(ref_st, fld)}
    out = {"render_d4": max(float((r["render"]["image"] - ref_img).abs()
                                  .max()) for r in results["d4"])}
    log(f"[4l-c] sharded render at D = 4 vs the single-device render: max "
        f"{out['render_d4']:.3e} (tol {ATOL})")
    if out["render_d4"] > ATOL:
        raise AssertionError(f"4l-c: the D = 4 render differs from the "
                             f"single-device one by {out['render_d4']}")
    for name, task in (("d2", "camera"), ("d4", "gauss_tile"),
                       ("2x2", "gauss_tile")):
        errs = {}
        for r in results[name]:
            got = r[task]
            e = {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                 "deform": max(float((a - b).abs().max()) for a, b in
                               zip(got["deform"], ref["deform"]))}
            for f in ("xyz", "opacity", "max_radii2d"):
                e[f] = float((got[f] - ref[f]).abs().max())
            errs = {f: max(v, errs.get(f, 0.0)) for f, v in e.items()}
        r0 = results[name][0][task]
        out[f"{task}_{name}"] = {"errors": errs, "bytes": r0["bytes"],
                                 "step_seconds": r0["seconds"]}
        log(f"[4l-c] {task} step on {name}: largest error over the ranks "
            f"{json.dumps(errs)} (tol {json.dumps(GLOO_TOL)}); rank 0's "
            f"collective bytes {json.dumps(r0['bytes'])}; "
            f"{r0['seconds']:.2f} s a step")
        bad = {f: v for f, v in errs.items() if not v <= GLOO_TOL[f]}
        if bad:
            raise AssertionError(f"4l-c {task} on {name}: {bad}")
    out["launches"] = {name: [{"tile_y0": r["tile_y0"],
                               **{t: r[t]["launches"] for t in tasks}}
                              for r in results[name]]
                       for name, (_, _, tasks) in runs.items()}
    if not any(r["tile_y0"] > 0 and r["gauss_tile"]["launches"]["blend_bwd"]
               for r in results["d4"]):
        raise AssertionError("4l-c: no strip kernel launched at tile_y0 > 0")
    out["comms_model"] = comms_model(state, payload["weights"], GLOO_K)
    log(f"[4l-c] per-step byte model: {json.dumps(out['comms_model'])}")
    return out


def comms_model(state, weights, k) -> dict:
    """d3gs_tpu_torch/parallel/__init__.py's per-step bytes for `state`'s
    capacity N, the deform net and k cameras at 400 x 400: the camera
    layout's all-reduce (the 59 parameter floats and the tap's 2 per
    Gaussian, the net) and max-reduce (radii), the gauss+tile layout's
    all-gather and reduce-scatter (64 B per Gaussian and camera each)."""
    n = state.capacity
    floats = sum(p[:1].numel() for p in state.params)
    mlp = sum(v.numel() for v in weights.values())
    return {"N": n, "param_floats": floats, "mlp_params": mlp,
            "camera_all_reduce": 4 * ((floats + 2) * n + mlp),
            "camera_pmax": 4 * (n + 1),
            "gauss_tile_all_gather": 64 * n * k,
            "gauss_tile_reduce_scatter": 64 * n * k,
            "gauss_tile_deform_all_reduce": 4 * mlp}


def mesh_step_timings(dev, state, bg, root) -> dict:
    """Phase 4l-d: one flagship step at k = FLAGSHIP_K (the 8x256 Blender
    MLP kind, 4d-style cameras) on the card, single-device and through the
    camera-parallel and gauss+tile steps on a world of 1 over NCCL (this
    process joins a group of one around a FileStore), CUDA events, read
    single, camera, gauss+tile, gauss+tile, camera, single: the sharded
    code's overhead with no traffic."""
    import dataclasses
    import torch.distributed as dist
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.models.deform.fields import create_deform_field
    from d3gs_tpu_torch.parallel import mesh as M
    from d3gs_tpu_torch.parallel import sharded as S
    from d3gs_tpu_torch.train.flagship import (make_batched_step,
                                               pick_field_spec)
    k = FLAGSHIP_K
    gen = torch.Generator(device=dev).manual_seed(3)
    cams = [dataclasses.replace(
        look_from_z(4.0, WIDTH, dev, fid=i / (k - 1)),
        image=torch.rand((HEIGHT, WIDTH, 3), device=dev, generator=gen))
        for i in range(k)]
    model = C.ModelParams(is_blender=True, D=8, W=256, sh_degree=3)
    opt, pipe = C.OptimizationParams(num_cams_per_iter=k), C.PipelineParams()
    field = create_deform_field(pick_field_spec(model, opt), seed=4,
                                device=dev, opt_cfg=opt)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(root, "nccl_store"), 1), rank=0, world_size=1)
    try:
        mesh = M.make_mesh(dev)
        kw = dict(opt_cfg=opt, pipe_cfg=pipe, model_cfg=model, field=field,
                  update_gaussians=True, update_deform=True, use_deform=True)
        shard = M.shard_gaussian_state(state, mesh)
        steps = {"single": (make_batched_step(**kw), state),
                 "camera": (S.make_flagship_camera_parallel_step(mesh, **kw),
                            state),
                 "gauss_tile": (S.make_flagship_gauss_tile_step(
                     mesh, width=WIDTH, height=HEIGHT, **kw), shard)}
        dstate = field.init_state()
        ms = {name: [] for name in steps}
        for name in ("single", "camera", "gauss_tile", "gauss_tile",
                     "camera", "single"):
            fn, st = steps[name]
            ms[name].append(cuda_ms(lambda fn=fn, st=st: fn(
                st, dstate, cams, 5000, bg), MESH_TIME_REPS, warmup=1))
        out = {"backend": dist.get_backend(), "k": k, "ms": ms}
    finally:
        dist.destroy_process_group()
    log(f"[4l-d] flagship MLP step, k = {k}, world size 1: {json.dumps(out)}")
    return out


def mesh_path(dev, data_f, flagship_mp, first_loss, bench_state, field,
              cam, root) -> dict:
    """Phase 4l: multi-GPU on the one card (a-d above)."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.data.scene import Scene
    t0 = time.perf_counter()
    bg = torch.zeros(3, device=dev)
    out = {"strips": strip_kernels(dev, bench_state, cam, field, bg)}
    out["cli"] = mesh_cli(dev, data_f, root, first_loss)
    scene = Scene(C.ModelParams(**C.load_cfg_args(flagship_mp)),
                  load_iteration=-1, shuffle=False, device=dev)
    out["gloo"] = gloo_ranks(dev, scene.gaussians,
                             scene.get_train_cameras(), root)
    out["timings"] = mesh_step_timings(dev, bench_state, bg, root)
    out["seconds"] = time.perf_counter() - t0
    log(f"[4l] took {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# 4m: the JPEG decoder, a JPEG COLMAP set, PTv3 at full width
# --------------------------------------------------------------------------
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "torch_port_jpeg")
JPEG_REPS = 3                    # 4m-a: decodes of each fixture (best kept)
COLMAP_ITERATIONS = 50           # 4m-b: baseline steps (losses logged at
COLMAP_WARM_UP = 25              # 1 and 50), deform steps from 25
PTV3_REPS = 3                    # 4m-c: calls in each timed reading
PTV3_CHECK_POINTS = 8192         # 4m-c: card vs CPU on a subsample
PTV3_CHECK_DEAD = 0.05           # with this share of dead rows
PTV3_CHECK_TOL = 1e-4            # of the largest |output|


def jpeg_fixtures() -> dict:
    """Phase 4m-a: every JPEG of tests/torch_port_jpeg/ decoded on the
    host by `data/jpeg.py` through `tools/exp_jpeg_decode`, bit-equal to
    the committed PNG of Pillow's decode; the best of JPEG_REPS decodes
    per fixture, in ms and ms per megapixel. Where Pillow imports on the
    host, its version and whether its decode agrees are logged too (a
    Pillow on another libjpeg may differ from the fixtures' own)."""
    import glob
    from d3gs_tpu_torch.tools.exp_jpeg_decode import decode_times
    paths = sorted(glob.glob(os.path.join(JPEG_FIXTURES, "*.jpg")))
    if not paths:
        raise AssertionError(f"4m-a: no JPEG fixture in {JPEG_FIXTURES}")
    out = decode_times(paths, JPEG_REPS)
    largest = max(out.values(), key=lambda r: r["shape"][0] * r["shape"][1])
    try:
        import PIL
        from PIL import Image
        from d3gs_tpu_torch.data.jpeg import read_jpeg
        pillow = {"version": PIL.__version__, "equal": all(
            np.array_equal(read_jpeg(p), np.asarray(Image.open(p)))
            for p in paths)}
    except ImportError:
        pillow = None
    log(f"[4m-a] {len(out)} JPEG fixtures decoded on the host: "
        f"{json.dumps(out)}; Pillow on the host: {pillow}")
    bad = [k for k, r in out.items() if r["equal_to_png"] is not True]
    if bad or largest["shape"][0] * largest["shape"][1] < 250_000:
        raise AssertionError(f"4m-a: {bad} differ from Pillow's decode, or "
                             f"no fixture of 0.25 MP ({largest})")
    return {"fixtures": out, "ms_per_mp": largest["ms_per_mp"],
            "pillow": pillow}


def colmap_jpeg_path(root) -> dict:
    """Phase 4m-b: tests/torch_port_jpeg/colmap/ (six 161x121 JPEG views
    of bench.py's scene, a COLMAP model of the port's writers) loaded by
    `load_scene_data` (timed), then `python -m d3gs_tpu_torch.train`
    (baseline) for COLMAP_ITERATIONS on it with the blend launches counted;
    the last logged loss must be below the first."""
    import shutil
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.data.scene import load_scene_data
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.train.__main__ import main as train_main
    data = os.path.join(root, "colmap_jpeg")
    shutil.copytree(os.path.join(JPEG_FIXTURES, "colmap"), data)
    t0 = time.perf_counter()
    scene = load_scene_data(C.ModelParams(source_path=data, eval=True))
    load_s = time.perf_counter() - t0
    shapes = sorted({c.image.shape for c in scene.train_cameras
                     + scene.test_cameras})
    it = COLMAP_ITERATIONS
    reset_counts()
    t0 = time.perf_counter()
    result = train_main([
        "-s", data, "-m", os.path.join(root, "colmap_model"), "--eval",
        "--quiet", "--iterations", str(it), "--warm_up",
        str(COLMAP_WARM_UP), "--test_iterations", str(it),
        "--save_iterations", str(it)])
    torch.cuda.synchronize()
    launches = B.launch_counts()
    out = {"scene_load_s": load_s, "image_shapes": [list(s) for s in shapes],
           "views": [len(scene.train_cameras), len(scene.test_cameras)],
           "train_s": time.perf_counter() - t0, "launches": launches,
           "losses": result.losses, "psnr": result.test_psnrs}
    log(f"[4m-b] COLMAP JPEG set: {json.dumps(out)}")
    losses = [v for _, v in result.losses]
    if not (shapes == [(121, 161, 3)] and len(losses) >= 2
            and all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0] and launches["blend_bwd"] >= it
            and launches["blend_fwd"] >= it + 1):
        raise AssertionError(f"4m-b: {out}")
    return out


def ptv3_inputs(ply_path: str):
    """4b's checkpoint as PTv3's cloud: xyz normalised to the box and the
    SH-DC colour (6 features), the grid floor((xyz - min) / (extent /
    1023))."""
    from d3gs_tpu_torch.data.ply import read_ply_columns
    from d3gs_tpu_torch.ops.sh import sh2rgb
    v, _ = read_ply_columns(ply_path)
    xyz = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], -1).astype(np.float32)
    lo = xyz.min(0)
    extent = float((xyz.max(0) - lo).max())
    feats = np.concatenate([(xyz - lo) / extent, sh2rgb(dc)], -1)
    grid = np.clip(np.floor((xyz - lo) / (extent / 1023)), 0, 1023)
    return feats.astype(np.float32), grid.astype(np.int32)


def ptv3_path(dev, ply_path: str) -> dict:
    """Phase 4m-c: PointTransformerV3 at the reference defaults (14.2 M
    parameters, seeded weights) on 4b's checkpoint: the deterministic
    forward and a training-mode forward + backward (seeded generator) by
    CUDA events, peak memory, every output and gradient finite; then the
    card against the port on the CPU on a PTV3_CHECK_POINTS subsample with
    PTV3_CHECK_DEAD of its rows dead."""
    import copy
    from d3gs_tpu_torch.models.ptv3 import PointTransformerV3
    feats, grid = ptv3_inputs(ply_path)
    n = len(feats)
    model = PointTransformerV3(device=dev)
    f = torch.from_numpy(feats).to(dev)
    g = torch.from_numpy(grid).to(dev)
    m = torch.ones(n, device=dev)
    gen = torch.Generator().manual_seed(0)

    @torch.no_grad()
    def forward():
        return model(f, g, m)

    def train_step():
        model.zero_grad(set_to_none=True)
        out = model(f, g, m, deterministic=False, generator=gen)
        out.square().mean().backward()
        return out

    out = forward()
    torch.cuda.synchronize()
    fwd_ms = cuda_ms(forward, PTV3_REPS, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    train_out = train_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(train_out)
                  .all() and all(torch.isfinite(p.grad).all()
                                 for p in model.parameters()))
    step_ms = cuda_ms(train_step, PTV3_REPS, warmup=1)
    # the card against the CPU at full width on a subsample
    rng = np.random.default_rng(0)
    sub = np.sort(rng.choice(n, min(PTV3_CHECK_POINTS, n), replace=False))
    mask = (rng.random(len(sub)) >= PTV3_CHECK_DEAD).astype(np.float32)
    cpu_model = copy.deepcopy(model).cpu()
    args = (torch.from_numpy(feats[sub]), torch.from_numpy(grid[sub]),
            torch.from_numpy(mask))
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu_model(*args)
        got = model(*(a.to(dev) for a in args)).cpu()
    err = float((got - want).abs().max() / want.abs().max())
    res = {"points": n, "parameters": sum(p.numel()
                                          for p in model.parameters()),
           "forward_ms": fwd_ms, "train_fwd_bwd_ms": step_ms,
           "peak_memory_gb": peak / 1e9, "finite": finite,
           "card_vs_cpu": {"points": len(sub), "dead": int((mask == 0).sum()),
                           "max_rel_err": err, "tol": PTV3_CHECK_TOL,
                           "seconds": time.perf_counter() - t0},
           "output_shape": list(out.shape), "card": nvidia_smi()}
    log(f"[4m-c] PTv3 (defaults) on 4b's checkpoint: {json.dumps(res)}")
    if not (finite and err <= PTV3_CHECK_TOL and out.shape == (n, 64)
            and got.shape == (len(sub), 64)):
        raise AssertionError(f"4m-c: {res}")
    return res


def jpeg_ptv3_path(dev, root, ply_path) -> dict:
    """Phase 4m: a-c above."""
    t0 = time.perf_counter()
    out = {"decode": jpeg_fixtures(), "colmap": colmap_jpeg_path(root),
           "ptv3": ptv3_path(dev, ply_path)}
    out["seconds"] = time.perf_counter() - t0
    log(f"[4m] took {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# 4n: the JPEG encoder, convert --resize, 16-bit and interlaced PNG frames
# --------------------------------------------------------------------------
ENCODE_REPS = 3                  # 4n-a: encodes of the fixture (best kept)
PNG16_ITERATIONS = 50            # 4n-c: baseline steps (losses logged at
PNG16_WARM_UP = 25               # 1 and 50), deform steps from 25
PYRAMID = (2, 4, 8)


def _tests_module(name: str):
    """A helper module of tests/ loaded from its file: the card's Python
    has another package named `tests` on its path."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"smoke_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pillow_or_none():
    try:
        import PIL
        from PIL import Image
        return PIL.__version__, Image
    except ImportError:
        return None, None


def jpeg_encode_check() -> dict:
    """Phase 4n-a: the pixels of tests/torch_port_jpeg/render_420.png
    (0.256 MP) encoded on the host by `data/jpeg_encode.py` at Pillow's
    defaults, byte-equal to the committed Pillow-written
    encode/render_420_q75.jpg; the best of ENCODE_REPS encodes in ms and ms
    per megapixel. Where Pillow imports on the host, its version and
    whether its own encode gives the same bytes are logged (only the
    fixture decides)."""
    import io
    from d3gs_tpu_torch.data.image_io import read_image
    from d3gs_tpu_torch.data.jpeg_encode import encode_jpeg
    img = read_image(os.path.join(JPEG_FIXTURES, "render_420.png"))
    with open(os.path.join(JPEG_FIXTURES, "encode", "render_420_q75.jpg"),
              "rb") as f:
        want = f.read()
    times = []
    for _ in range(ENCODE_REPS):
        t0 = time.perf_counter()
        got = encode_jpeg(img)
        times.append(time.perf_counter() - t0)
    version, Image = _pillow_or_none()
    pillow = None
    if Image is not None:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG")
        pillow = {"version": version, "equal": buf.getvalue() == got}
    ms = 1e3 * min(times)
    mp = img.shape[0] * img.shape[1] / 1e6
    out = {"shape": list(img.shape), "bytes": len(got),
           "equal_to_fixture": got == want, "ms": ms, "ms_per_mp": ms / mp,
           "pillow": pillow}
    if not (out["equal_to_fixture"] and mp >= 0.25):
        raise AssertionError(f"4n-a: {out}")
    return out


def convert_resize_path(root) -> dict:
    """Phase 4n-b: `d3gs_tpu_torch.convert.main(["-s", ...,
    "--skip_matching", "--resize"])` on a copy of tests/torch_port_jpeg/
    colmap/ (its six 161x121 JPEG views in input/, its model in
    distorted/sparse/0) and on the committed RGBA PNG set, with
    tests/torch_port_fake_colmap.py standing in for the `colmap` binary,
    which the card's machine lacks (its image_undistorter copies the
    images and the model). Every images_{2,4,8}/*.jpg must equal the
    committed Pillow-written file byte for byte (colmap_pyramid/), every
    RGBA PNG the committed Pillow output's pixels (rgba/images_*), and
    sparse/0 must hold the model. Where Pillow imports on the host, whether
    its own pyramid gives the same JPEG bytes is logged."""
    import io
    import shutil
    from d3gs_tpu_torch import convert
    from d3gs_tpu_torch.data.image_io import read_image
    fake = _tests_module("torch_port_fake_colmap").write_fake_colmap(
        os.path.join(root, "fake_colmap"))
    model = os.path.join(JPEG_FIXTURES, "colmap", "sparse", "0")
    out = {}
    for kind, images, ref in (("jpeg", "colmap/images", "colmap_pyramid"),
                              ("rgba_png", "rgba/input", "rgba")):
        src = os.path.join(root, f"convert_{kind}")
        shutil.copytree(os.path.join(JPEG_FIXTURES, images),
                        os.path.join(src, "input"))
        shutil.copytree(model, os.path.join(src, "distorted", "sparse", "0"))
        t0 = time.perf_counter()
        convert.main(["-s", src, "--skip_matching", "--resize",
                      "--colmap_executable", fake])
        seconds = time.perf_counter() - t0
        names = sorted(os.listdir(os.path.join(src, "images")))
        equal = 0
        for div in PYRAMID:
            for name in names:
                got = os.path.join(src, f"images_{div}", name)
                want = os.path.join(JPEG_FIXTURES, ref, f"images_{div}", name)
                if kind == "jpeg":
                    with open(got, "rb") as a, open(want, "rb") as b:
                        equal += a.read() == b.read()
                else:
                    equal += bool(np.array_equal(read_image(got),
                                                 read_image(want)))
        out[kind] = {"images": len(names), "files": len(PYRAMID) * len(names),
                     "equal": equal, "seconds": seconds,
                     "model": sorted(os.listdir(os.path.join(src, "sparse",
                                                             "0")))}
    version, Image = _pillow_or_none()
    if Image is not None:
        src = os.path.join(root, "convert_jpeg")
        same = 0
        for div in PYRAMID:
            for name in sorted(os.listdir(os.path.join(src, "images"))):
                im = Image.open(os.path.join(src, "images", name))
                buf = io.BytesIO()
                im.resize((im.width // div, im.height // div)).save(buf,
                                                                    "JPEG")
                with open(os.path.join(src, f"images_{div}", name),
                          "rb") as f:
                    same += buf.getvalue() == f.read()
        out["pillow"] = {"version": version, "jpeg_equal": same}
    else:
        out["pillow"] = None
    model_files = ["cameras.bin", "images.bin", "points3D.bin"]
    if not (out["jpeg"]["files"] == out["jpeg"]["equal"] == 18
            and out["rgba_png"]["files"] == out["rgba_png"]["equal"] == 9
            and out["jpeg"]["model"] == out["rgba_png"]["model"]
            == model_files):
        raise AssertionError(f"4n-b: {out}")
    return out


def png16_frames_path(dev, data, root) -> dict:
    """Phase 4n-c: 4b's D-NeRF set (400x400 RGBA frames) copied with every
    frame rewritten as 16-bit RGBA (each sample v -> v · 257), every other
    one Adam7-interlaced, by tests/torch_port_png_writer.py; both sets
    loaded by `load_scene_data` (timed), whose images must be equal
    exactly; then `python -m d3gs_tpu_torch.train` (baseline) for
    PNG16_ITERATIONS on the 16-bit set with the blend launches counted:
    at least PNG16_ITERATIONS + 1 forward and PNG16_ITERATIONS backward,
    and the last logged loss below the first."""
    import shutil
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.data.image_io import read_png
    from d3gs_tpu_torch.data.scene import load_scene_data
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.train.__main__ import main as train_main
    write_png16_rgba = _tests_module("torch_port_png_writer").write_png16_rgba
    data16 = os.path.join(root, "data_png16")
    shutil.copytree(data, data16)
    frames = interlaced = 0
    for split in ("train", "test"):
        for name in sorted(n for n in os.listdir(os.path.join(data16, split))
                           if n.endswith(".png")):
            path = os.path.join(data16, split, name)
            write_png16_rgba(path, read_png(path), interlace=bool(frames % 2))
            interlaced += frames % 2
            frames += 1
    loads = {}
    scenes = {}
    for key, src in (("8bit", data), ("16bit", data16)):
        t0 = time.perf_counter()
        scenes[key] = load_scene_data(C.ModelParams(source_path=src,
                                                    eval=True))
        loads[key] = time.perf_counter() - t0
    cams = {k: v.train_cameras + v.test_cameras for k, v in scenes.items()}
    equal = len(cams["8bit"]) == len(cams["16bit"]) == frames and all(
        np.array_equal(np.asarray(a.image), np.asarray(b.image))
        for a, b in zip(cams["8bit"], cams["16bit"]))
    it = PNG16_ITERATIONS
    reset_counts()
    t0 = time.perf_counter()
    result = train_main([
        "-s", data16, "-m", os.path.join(root, "png16_model"), "--eval",
        "--is_blender", "--quiet", "--iterations", str(it), "--warm_up",
        str(PNG16_WARM_UP), "--test_iterations", str(it),
        "--save_iterations", str(it)])
    torch.cuda.synchronize()
    launches = B.launch_counts()
    out = {"frames": frames, "interlaced": interlaced,
           "images_equal_to_8bit": equal, "load_s": loads,
           "train_s": time.perf_counter() - t0, "launches": launches,
           "losses": result.losses, "psnr": result.test_psnrs}
    losses = [v for _, v in result.losses]
    if not (equal and interlaced and len(losses) >= 2
            and all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0] and launches["blend_bwd"] >= it
            and launches["blend_fwd"] >= it + 1):
        raise AssertionError(f"4n-c: {out}")
    return out


def encode_convert_png16_path(dev, data, root) -> dict:
    """Phase 4n: a-c above, one [4n] line with their numbers."""
    t0 = time.perf_counter()
    out = {"encode": jpeg_encode_check(), "convert": convert_resize_path(
        root), "png16": png16_frames_path(dev, data, root)}
    out["seconds"] = time.perf_counter() - t0
    log(f"[4n] {json.dumps(out)}; {nvidia_smi()}")
    log(f"[4n] took {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# 4o: d3gs_tpu_torch/bench.py; 4p: tight_cull
# --------------------------------------------------------------------------
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "train_step_ms",
              "render_only_mrays", "render_only_fps", "render_vs_baseline",
              "flagship_ms_per_cam_k10")   # bench.py:203-219
NEAR_ALPHA = 1e-5                # 4p: relative distance of a tile-max alpha
#                                  from 1/255 that could flip a pixel
FLIPS_ALLOWED = 0                # 4p: pixels the cull may change
CULL_ITERATIONS = 50             # 4p-d: the baseline CLI with --tight_cull
CULL_WARM_UP = 25


def bench_launches(bench) -> dict:
    """The blend launches `bench.main` makes: a warm-up and two timed runs
    of each loop length, the train step one forward and one backward, a
    frame one forward, a flagship step k of each, and the budget check's
    k + 1 frames."""
    runs = {name: 3 * sum(n) for name, n in bench.LOOPS.items()}
    return {"blend_fwd": runs["train"] + runs["render"]
            + bench.K * runs["flagship"] + bench.K + 1,
            "blend_bwd": runs["train"] + bench.K * runs["flagship"]}


BENCH_CARRIED_STEPS = 6          # 4o: train steps of the carried loop
BENCH_UNCAPPED = 10 ** 7         # 4o: a budget the carried loop may reach


def bench_frames(dev) -> dict:
    """Phase 4o, before the bench: M of the bench frame and of the ten
    flagship frames at the initial state (the numbers its budget rests on),
    and M along BENCH_CARRIED_STEPS train steps that carry their state, as
    bench.py's loop does, under a budget of BENCH_UNCAPPED."""
    from d3gs_tpu_torch import bench
    b = bench.build(dev, dup_capacity=BENCH_UNCAPPED)
    out = {"bench_frame": bench.frame_dups(b, b.field, b.cam),
           "flagship_frames": [bench.frame_dups(b, b.ffield, c)
                               for c in b.cams]}
    bg = torch.zeros(3, device=dev)
    st, dst, carried = b.state, b.field.init_state(), []
    for i in range(BENCH_CARRIED_STEPS):
        st, dst, aux = b.step(st, dst, b.cam, bench.ITERATION0 + i, None,
                              bg)
        carried.append(int(aux.dup_total))
    out["carried_train_steps"] = carried
    log(f"[4o] M at the initial state and along a carried train loop: "
        f"{json.dumps(out)} (budget {bench.budget(bench.DUP_CAPACITY)})")
    return out


def bench_path(dev) -> dict:
    """Phase 4o: `bench_frames`, then `d3gs_tpu_torch.bench.main([])`
    in-process at bench.py's configuration, the blend launches counted
    around it; its one JSON line must carry every key of bench.py's line,
    positive, plus device, power_limit and a dup_total under the budget."""
    import contextlib
    import io
    from d3gs_tpu_torch import bench
    from d3gs_tpu_torch.ops import blend as B
    frames = bench_frames(dev)
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench.main([])
    torch.cuda.synchronize()
    launches = B.launch_counts()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    log(f"[4o] bench.main -> {rc} in {seconds:.1f} s, blend launches "
        f"{launches} (expected {bench_launches(bench)}); its line:")
    for line in lines:
        print(line, flush=True)
    out = json.loads(lines[-1]) if lines else {}
    numbers = [out.get(k) for k in BENCH_KEYS if k not in ("metric", "unit")]
    if not (rc == 0 and len(lines) == 1 and "error" not in out
            and all(k in out for k in BENCH_KEYS + ("device", "power_limit",
                                                    "dup_total"))
            and all(isinstance(v, (int, float)) and v > 0 for v in numbers)
            and 0 < out["dup_total"] < bench.budget(bench.DUP_CAPACITY)
            and launches == bench_launches(bench)):
        raise AssertionError(f"4o: rc {rc}, {lines}, launches {launches}")
    return {"line": out, "launches": launches, "seconds": seconds,
            "frames": frames}


def near_threshold_tiles(splats, bins, tiles_x: int) -> torch.Tensor:
    """(T,) bool: the tiles of `bins` (unculled) holding a duplicate whose
    largest alpha over the tile lies within NEAR_ALPHA (relative) of
    1/255, the only duplicates whose cull could flip a pixel."""
    from d3gs_tpu_torch.ops.binning import tile_max_power
    starts = bins.starts.long()
    num_tiles = starts.shape[0] - 1
    gid = bins.order.long()[bins.rank_sorted.long()][:int(starts[-1])]
    tile = torch.repeat_interleave(
        torch.arange(num_tiles, device=gid.device), starts[1:] - starts[:-1])
    mu, con = splats.means2d[gid], splats.conics[gid]
    pmax = tile_max_power(mu[:, 0], mu[:, 1], con[:, 0], con[:, 1],
                          con[:, 2], (tile % tiles_x).float(),
                          (tile // tiles_x).float())
    alpha = splats.opacities[gid] * torch.exp(pmax)
    near = torch.zeros(num_tiles, dtype=torch.bool, device=gid.device)
    near[tile[(alpha * 255.0 - 1.0).abs() <= NEAR_ALPHA]] = True
    return near


def cull_render_pair(tag, state, cam, field, bg) -> dict:
    """Phase 4p-a: `render` (models/renderer.py) of `state` at `cam` (the
    MLP field's deformation at cam.fid) with and without tight_cull, and
    the gradients of sum (image - 0.5)² + 0.01 sum depth + 0.02 sum alpha
    with respect to the six parameters: M each way, the images, depths and
    alphas at ATOL / RTOL, the gradients within BWD_TOL['bench'] of the
    largest; pixels outside the bounds are counted (those in a tile with a
    duplicate at the threshold apart), at most FLIPS_ALLOWED. Then both
    kernels alone on the culled bins against their plain versions
    (phase 3's bounds) and timed beside the unculled bins."""
    import dataclasses
    from d3gs_tpu_torch.models import gaussians as G
    from d3gs_tpu_torch.models.renderer import project_splats, render
    from d3gs_tpu_torch.ops.binning import bin_splats_records
    from d3gs_tpu_torch.ops.rasterize import pack_records
    with torch.no_grad():
        dx, dr, ds = field.step(state.params.xyz, cam.fid)
    outs, grads = {}, {}
    for cull in (False, True):
        params = G.GaussianParams(*(p.detach().requires_grad_()
                                    for p in state.params))
        st = dataclasses.replace(state, params=params)
        out = render(st, cam, d_xyz=dx, d_rotation=dr, d_scaling=ds, bg=bg,
                     tight_cull=cull)
        loss = ((out.image - 0.5) ** 2).sum() + 0.01 * out.depth.sum() \
            + 0.02 * out.alpha.sum()
        grads[cull] = torch.autograd.grad(loss, list(params),
                                          allow_unused=True,
                                          materialize_grads=True)
        outs[cull] = out
    on, off = outs[True], outs[False]
    bad = torch.zeros((cam.height, cam.width), dtype=torch.bool,
                      device=bg.device)
    field_err = {}
    for name in ("image", "depth", "alpha"):
        a, b = getattr(on, name).detach(), getattr(off, name).detach()
        if not torch.isfinite(a).all():
            raise AssertionError(f"4p {tag}: non-finite culled {name}")
        far = (a - b).abs() > ATOL + RTOL * b.abs()
        bad |= far.any(-1) if far.ndim == 3 else far
        field_err[name] = float((a - b).abs().max())
    tiles_x = (cam.width + 15) // 16
    tiles_y = (cam.height + 15) // 16
    with torch.no_grad():
        splats = project_splats(state, cam, d_xyz=dx, d_rotation=dr,
                                d_scaling=ds)
        bins = {c: bin_splats_records(splats, tiles_x=tiles_x,
                                      tiles_y=tiles_y, tight_cull=c)
                for c in (False, True)}
        records = pack_records(splats)
    near = near_threshold_tiles(splats, bins[False], tiles_x).reshape(
        tiles_y, tiles_x).repeat_interleave(16, 0).repeat_interleave(
        16, 1)[:cam.height, :cam.width]
    flips = {"outside_bounds": int(bad.sum()),
             "near_threshold": int((bad & near).sum())}
    grad_err = {}
    for name, a, b in zip(G.GaussianParams._fields, grads[True],
                          grads[False]):
        scale = float(b.abs().max())
        grad_err[name] = float((a - b).abs().max()) / scale if scale else \
            float(a.abs().max())
    m = {c: int(bins[c].starts[-1]) for c in (False, True)}
    grid = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=cam.width,
                height=cam.height)
    name = f"4p {tag} culled bins"
    errs = (compare_blend(name, records, bins[True], bg, grid),
            compare_blend_bwd(name, records, bins[True], bg, grid,
                              BWD_TOL["bench"]))
    times = {("culled" if c else "uncut"): blend_kernel_times(
        records, bins[c], bg, grid) for c in (False, True)}
    out = {"M_uncut": m[False], "M_culled": m[True],
           "M_culled_share": m[True] / m[False], "max_abs_on_vs_off":
           field_err, "grads_of_largest": grad_err, "flips": flips,
           "kernels_vs_plain_on_culled_bins": errs, "kernels": times}
    log(f"[4p-a] {tag}: {json.dumps(out)}")
    if (flips["outside_bounds"] > FLIPS_ALLOWED
            or max(grad_err.values()) > BWD_TOL["bench"]
            or not m[True] < m[False] or int(on.counts.sum()) != m[True]):
        raise AssertionError(f"4p {tag}: culled and uncut renders differ: "
                             f"{out}")
    return out


def cull_strips(state, cam, field, bg) -> dict:
    """Phase 4p-b: the bench frame cut into 2 and 4 strips of tile rows,
    each binned with tight_cull and blended by
    `parallel/sharded.py::blend_strip` at its tile_y0 (the kernels, as the
    sharded steps run them), the strips' images against the whole uncut
    frame's (ATOL) and the record gradients of the loss of
    `blend_loss_grads` summed over the strips against the whole frame's
    (BWD_TOL['bench'] of the largest)."""
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.ops.binning import bin_splats_records
    from d3gs_tpu_torch.ops.rasterize import pack_records_full
    from d3gs_tpu_torch.parallel.sharded import StripGrid, blend_strip
    splats = stage_splats(state, cam, field)
    records = pack_records_full(splats)
    tiles = (WIDTH + 15) // 16
    grid = dict(tiles_x=tiles, tiles_y=tiles, width=WIDTH, height=HEIGHT)
    bins = bin_splats_records(splats, tiles_x=tiles, tiles_y=tiles)
    rec = records.clone().requires_grad_()
    img, dep, alp = B.blend_records(rec, bins, bg, **grid)
    loss = lambda i, d, a: ((i - 0.5) ** 2).sum() + 0.01 * d.sum() \
        + 0.02 * a.sum()  # noqa: E731
    (g_full,) = torch.autograd.grad(loss(img, dep, alp), [rec])
    out = {}
    for d in STRIP_MESHES:
        rows = -(-tiles // d)
        rec = records.clone().requires_grad_()
        parts, m = [], 0
        for s in range(d):
            g = StripGrid(tiles_x=tiles, tiles_y=rows, strip_h=rows * 16,
                          tile_y0=s * rows)
            i, dp, a, counts = blend_strip(rec, bg, g, width=WIDTH,
                                           depth_grad=True, tight_cull=True)
            parts.append((i, dp, a))
            m += int(counts.sum())
        si, sd, sa = (torch.cat(x)[:HEIGHT] for x in zip(*parts))
        (g_strips,) = torch.autograd.grad(loss(si, sd, sa), [rec])
        err = lambda a, b: float((a - b).detach().abs().max())  # noqa: E731
        errs = {"image": err(si, img), "depth": err(sd, dep),
                "alpha": err(sa, alp),
                "grads_of_largest": float((g_strips - g_full).abs().max()
                                          / g_full.abs().max())}
        out[d] = {"M_culled": m, "M_uncut_frame": int(bins.starts[-1]),
                  **errs}
        log(f"[4p-b] {d} culled strips vs the uncut frame: {out[d]}")
        if not (errs["image"] <= ATOL and errs["alpha"] <= ATOL
                and errs["grads_of_largest"] <= BWD_TOL["bench"]
                and m < int(bins.starts[-1])):
            raise AssertionError(f"4p-b: culled strips differ: {out[d]}")
    return out


def cull_cli_path(data, root) -> dict:
    """Phase 4p-c: `python -m d3gs_tpu_torch.train ... --tight_cull` (the
    baseline trainer) for CULL_ITERATIONS on 4b's set, the blend launches
    counted and the renderer's binnings watched: every one must cull, at
    least CULL_ITERATIONS + 1 forward launches and CULL_ITERATIONS
    backward, the last logged loss below the first."""
    from d3gs_tpu_torch.models import renderer
    from d3gs_tpu_torch.ops import blend as B
    from d3gs_tpu_torch.train.__main__ import main as train_main
    binned = {True: 0, False: 0}
    real = renderer.bin_splats_records

    def watch(*args, tight_cull=False, **kw):
        binned[tight_cull] += 1
        return real(*args, tight_cull=tight_cull, **kw)
    it = CULL_ITERATIONS
    renderer.bin_splats_records = watch
    reset_counts()
    t0 = time.perf_counter()
    try:
        result = train_main([
            "-s", data, "-m", os.path.join(root, "cull_model"), "--eval",
            "--is_blender", "--quiet", "--tight_cull", "--iterations",
            str(it), "--warm_up", str(CULL_WARM_UP), "--test_iterations",
            str(it), "--save_iterations", str(it)])
        torch.cuda.synchronize()
    finally:
        renderer.bin_splats_records = real
    launches = B.launch_counts()
    losses = [v for _, v in result.losses]
    out = {"launches": launches, "binnings_culled": binned[True],
           "binnings_uncut": binned[False], "losses": result.losses,
           "psnr": result.test_psnrs, "train_s": time.perf_counter() - t0}
    log(f"[4p-c] train --tight_cull: {json.dumps(out)}")
    if not (len(losses) >= 2 and all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0] and launches["blend_bwd"] >= it
            and launches["blend_fwd"] >= it + 1 and binned[True] >= it + 1
            and binned[False] == 0):
        raise AssertionError(f"4p-c: {out}")
    return out


def tight_cull_path(dev, state, cam, field, data, trained) -> dict:
    """Phase 4p: a-c above on the bench frame and 4b's checkpoint."""
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch.data.scene import Scene
    from d3gs_tpu_torch.models.deform.fields import (create_deform_field,
                                                     load_deform_weights)
    from d3gs_tpu_torch.train.flagship import pick_field_spec
    t0 = time.perf_counter()
    bg = torch.zeros(3, device=dev)
    out = {"bench_frame": cull_render_pair("bench frame", state, cam, field,
                                           bg)}
    cfg = C.ModelParams(**C.load_cfg_args(trained))
    scene = Scene(cfg, load_iteration=-1, shuffle=False, device=dev)
    fld = load_deform_weights(trained, create_deform_field(
        pick_field_spec(cfg, C.OptimizationParams()), device=dev))
    out["checkpoint"] = cull_render_pair(
        "4b checkpoint, test view 0", scene.gaussians,
        scene.get_test_cameras()[0], fld, bg)
    out["strips"] = cull_strips(state, cam, field, bg)
    out["cli"] = cull_cli_path(data, os.path.dirname(trained))
    out["seconds"] = time.perf_counter() - t0
    log(f"[4p] took {out['seconds']:.1f} s; {nvidia_smi()}")
    return out


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

    def device_ms(fn, tries=5):
        # the profiler now and then records no kernel of a call (it read
        # index_select's device time as 0 in one run): trace again
        for _ in range(tries):
            ms = profile(fn, calls=50, top=2)["device_ms_per_call"]
            if ms > 0:
                return ms
        raise AssertionError(f"torch.profiler read no device time in "
                             f"{tries} traces")

    def timed(kernel, library, plain, plain_reps=20):
        return {"ms": device_ms(kernel), "event_ms": cuda_ms(kernel, 200),
                "library_ms": device_ms(library),
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
    out, runs, fields = {}, {}, {}
    for kind in ("mlp", "adaptive", "ode"):
        model = C.ModelParams(is_blender=True, is_ode=kind != "mlp", D=8,
                              W=256, sh_degree=3,
                              ode_solver="adaptive" if kind == "adaptive"
                              else "rk4")
        field = create_deform_field(pick_field_spec(model, opt), seed=4,
                                    device=dev, opt_cfg=opt)
        dstate = field.init_state()
        step = make_batched_step(opt_cfg=opt, pipe_cfg=pipe,
                                 model_cfg=model, field=field,
                                 update_gaussians=True, update_deform=True,
                                 use_deform=True)
        run = (lambda step=step, dstate=dstate:  # noqa: E731
               step(state, dstate, cams, 5000, bg))
        runs[kind], fields[kind] = run, field
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(run, 3, warmup=1)
        out[f"{kind}_step_ms"] = ms
        out[f"{kind}_step_ms_per_camera"] = ms / k
        out[f"{kind}_peak_memory_gb"] = torch.cuda.max_memory_allocated(
            dev) / 1e9
    out.update(adaptive_step_layers(fields["adaptive"], runs["adaptive"],
                                    state, cams, bg))
    # the ODE step's layers (field, step, run: the RK4 ODE kind's, last
    # above)
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
    out["ode_step_device_ms"] = prof["device_ms_per_call"]
    return out, prof


def adaptive_step_layers(field, run, state, cams, bg) -> dict:
    """Phase 5: the adaptive ODE flagship step (`run`, k = 10, rtol 1e-3 /
    atol 1e-4): the solver's counts over one step, the integral forward
    and forward + backward (CUDA events), torch.profiler's device time of
    the step and of the integral, and the integral's share. The adjoint's
    steps depend on the cotangent, so the integral's backward takes the
    step's own: d loss / d positions of the k renders' (1-λ)·L1 +
    λ·(1-SSIM)."""
    from d3gs_tpu_torch.models.renderer import render
    from d3gs_tpu_torch.ops.losses import l1_loss, ssim
    params = list(field.net.parameters())
    xyz = state.params.xyz
    fids = [c.fid for c in cams]
    with torch.no_grad():
        means = field.step_multi(xyz, fids, y0=xyz)[0]
    means.requires_grad_()
    loss = sum(0.8 * l1_loss(out, c.image) + 0.2 * (1 - ssim(out, c.image))
               for out, c in ((render(state, c, d_xyz=means[i],
                                      direct_compute=True, bg=bg,
                                      depth_grad=False).image, c)
                              for i, c in enumerate(cams))) / len(cams)
    (cot,) = torch.autograd.grad(loss, means)

    def ode_fwd():
        with torch.no_grad():
            return field.step_multi(xyz, fids, y0=xyz)

    def ode_fwd_bwd():
        ys = field.step_multi(xyz, fids, y0=xyz)[0]
        return torch.autograd.grad(ys, params, cot)

    reset_counts()
    run()
    torch.cuda.synchronize()
    counts = ode_counts()
    reset_counts()
    ode_fwd_bwd()
    torch.cuda.synchronize()
    integral_counts = ode_counts()
    prof = profile(run, calls=1, cpu=False)
    ode_prof = profile(ode_fwd_bwd, calls=1, top=4, cpu=False)
    return {
        "adaptive_counts_per_step": counts,
        "adaptive_integral_counts": integral_counts,
        "adaptive_integral_fwd_ms": cuda_ms(ode_fwd, 3, warmup=1),
        "adaptive_integral_fwd_bwd_ms": cuda_ms(ode_fwd_bwd, 3, warmup=1),
        "adaptive_step_device_ms": prof["device_ms_per_call"],
        "adaptive_step_profile": prof,
        "adaptive_integral_device_ms": ode_prof["device_ms_per_call"],
        "adaptive_ode_share_of_device_time": (
            ode_prof["device_ms_per_call"] / prof["device_ms_per_call"]
            if prof["device_ms_per_call"] > 0 else float("nan")),
        "rk4_forward_evaluations_per_step": 16 * (len(fids) - 1),
    }


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
    contracted_build = start_contracted_build()
    logs = _build.build()
    contracted_fn = finish_contracted_build(*contracted_build)
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
    flips = edge_flips(dev, contracted_fn)
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
    # ---- 3d. the fused RK4 step vs plain at trex's size ------------------
    ode_errs = ode_rk4_check(dev)
    # ---- 3e. the fused deformation MLP vs plain at the real scene's size --
    mlp_errs = mlp_field_check(dev)

    with tempfile.TemporaryDirectory(prefix="d3gs_smoke_") as tmp:
        # ---- 4. main path: render ---------------------------------------
        data = os.path.join(tmp, "data")
        write_dnerf_dataset(data, dev, size=WIDTH)
        render_result = render_main_path(dev, data, os.path.join(tmp,
                                                                 "model"))
        # ---- 4b. main path: train ---------------------------------------
        train_launches = train_main_path(dev, data,
                                         os.path.join(tmp, "trained"))
        # ---- 4c. the three tool paths -----------------------------------
        tool_launches = tool_paths()
        # ---- 4d. main path: the flagship ODE trainer --------------------
        data_f = os.path.join(tmp, "data_flagship")
        write_dnerf_dataset(data_f, dev, *FLAGSHIP_VIEWS, size=WIDTH)
        launches, flagship_first_loss = flagship_main_path(
            dev, data_f, os.path.join(tmp, "flagship"))
        # ---- 4e / 4f. the adaptive solver in the flagship trainer -------
        adaptive = adaptive_flagship_path(
            dev, data_f, os.path.join(tmp, "adaptive"), kind_flag="--is_ode",
            iterations=ADAPTIVE_ITERATIONS, warm_up=3, tag="4e")
        simple_start = adaptive_flagship_path(
            dev, data_f, os.path.join(tmp, "simple_start"),
            kind_flag="--use_torch_ode", iterations=SIMPLE_START_ITERATIONS,
            warm_up=2, tag="4f")
        # ---- 4g. distillation from 4b's checkpoint ----------------------
        distill = distill_path(dev, data, os.path.join(tmp, "trained"),
                               os.path.join(tmp, "distill"))
        # ---- 4h. the synthetic-ODE harness, per-sample grids ------------
        synth = synth_paths(dev, os.path.join(tmp, "synth"))
        # ---- 4i. the bf16 deform MLP ------------------------------------
        bf16 = bf16_path(dev, data, os.path.join(tmp, "bf16"))
        # ---- 4j. evaluation on 4b's checkpoint --------------------------
        eval_ = eval_path(dev, data, os.path.join(tmp, "trained"),
                          os.path.join(tmp, "eval"))
        # ---- 4k. the SAM trainer, forecaster, ode_demo, viewer, sweep ----
        t4k = time.perf_counter()
        side = {"sam": sam_path(dev, data, tmp)}
        side["forecast"] = forecast_path(dev, os.path.join(
            tmp, "trained", "trajectories.npy"), tmp)
        side["ode_demo"] = ode_demo_path(tmp)
        side["viewer"] = viewer_path(dev, data, os.path.join(tmp, "trained"),
                                     tmp)
        side["sweep"] = sweep_path(dev, data_f, tmp)
        seconds_4k = {"sam": side["sam"]["phase_seconds"],
                      "forecast": side["forecast"]["phase_seconds"],
                      "ode_demo": sum(v["seconds"] for v in
                                      side["ode_demo"].values()),
                      "viewer": side["viewer"]["phase_seconds"],
                      "sweep": side["sweep"]["seconds"]}
        log(f"[4k] took {time.perf_counter() - t4k:.1f} s: "
            f"{json.dumps(seconds_4k)}")
        # ---- 4l. multi-GPU on the one card ------------------------------
        mesh = mesh_path(dev, data_f, os.path.join(tmp, "flagship"),
                         flagship_first_loss, state, field, cam, tmp)
        # ---- 4m. JPEG decoding, a JPEG COLMAP set, PTv3 -----------------
        jpeg_ptv3 = jpeg_ptv3_path(dev, tmp, os.path.join(
            tmp, "trained", "point_cloud", f"iteration_{TRAIN_ITERATIONS}",
            "point_cloud.ply"))
        # ---- 4n. JPEG encoding, convert --resize, 16-bit PNG frames -----
        png16 = encode_convert_png16_path(dev, data, tmp)
        # ---- 4o. d3gs_tpu_torch/bench.py --------------------------------
        bench_run = bench_path(dev)
        # ---- 4p. tight_cull ---------------------------------------------
        cull = tight_cull_path(dev, state, cam, field, data,
                               os.path.join(tmp, "trained"))
    log(f"[4] kernel launches by path: render {render_result['launches']}, "
        f"train {train_launches}, tools {tool_launches}, flagship "
        f"{launches}, adaptive flagship {adaptive['launches']}, "
        f"simple_start {simple_start['launches']}, distill "
        f"{distill['launches']}, bf16 {bf16['launches']}, eval "
        f"{json.dumps(eval_['launches'])}, sam {side['sam']['launches']}, "
        f"sam hooks {side['sam']['hooks']['launches']}, gui test_step "
        f"{side['viewer']['gui_launches']}, sweep "
        f"{side['sweep']['launches']}, mesh (ranks) "
        f"{json.dumps(mesh['gloo']['launches'])}, mesh CLI "
        f"{json.dumps({m: r['launches'] for m, r in mesh['cli'].items()})}, "
        f"COLMAP JPEG set {jpeg_ptv3['colmap']['launches']}, 16-bit PNG "
        f"set {png16['png16']['launches']}, bench {bench_run['launches']}, "
        f"--tight_cull CLI {cull['cli']['launches']}")

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
    ot = ode_rk4_timings(dev)
    mt = mlp_field_timings(dev)
    ft, fprof = flagship_timings(dev, state, bg)
    ft["card"] = smi
    log("[5] flagship steps: " + json.dumps(ft))
    log("[5] profile of one flagship ODE step: " + json.dumps(fprof))
    c = ft["adaptive_counts_per_step"]
    log(f"[5] adaptive vs RK4 flagship step, k = {FLAGSHIP_K}: step "
        f"{ft['adaptive_step_ms']:.1f} vs {ft['ode_step_ms']:.1f} ms, device "
        f"{ft['adaptive_step_device_ms']:.1f} vs "
        f"{ft['ode_step_device_ms']:.1f} ms, integral share "
        f"{ft['adaptive_ode_share_of_device_time']:.3f} vs "
        f"{ft['ode_share_of_device_time']:.3f}; forward {c['forward']} vs "
        f"RK4's {ft['rk4_forward_evaluations_per_step']} evaluations, "
        f"backward {c['backward']} vs RK4's "
        f"{ft['rk4_forward_evaluations_per_step']} recomputed + "
        f"{ft['rk4_forward_evaluations_per_step']} backward; bf16 / f32 MLP "
        f"fwd+bwd {bf16['mlp']['bf16_over_f32_fwd_bwd']:.3f} "
        f"({json.dumps(bf16['mlp']['ms'])}); {smi}")

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
                              "tools/exp_vmem_scatter.py:31"))] + [{
        "name": "ode_rk4", "route": "cuda",
        "source": "d3gs_tpu_torch/csrc/ode_rk4.cu", "replaces": None,
        "launches": launches["ode_rk4"],
        "max_abs_err": ode_errs["integral_vs_plain"], "ms": ot["ms"],
        "plain_ms": ot["plain_ms"], "bound_ms": ot["bound_ms"],
        "bound_by": "ops", "library_ms": None,
    }, {
        "name": "ode_rk4_bwd", "route": "cuda",
        "source": "d3gs_tpu_torch/csrc/ode_rk4_bwd.cu", "replaces": None,
        "launches": launches["ode_rk4_bwd"],
        "max_rel_l2_err": ode_errs["vjp_l2_params"], "ms": ot["bwd"]["ms"],
        "plain_ms": ot["bwd"]["plain_ms"], "bound_ms": ot["bwd"]["bound_ms"],
        "bound_by": "ops", "library_ms": ot["bwd"]["library_ms"],
    }, {
        "name": "mlp_field", "route": "cuda",
        "source": "d3gs_tpu_torch/csrc/mlp_field.cu", "replaces": None,
        "launches": train_launches["mlp_field"],
        "max_rel_err": mlp_errs[MLP_N]["fwd_gap"], "ms": mt["fwd_ms"],
        "plain_ms": mt["fwd_plain_ms"], "bound_ms": mt["fwd_bound_ms"],
        "bound_by": "ops", "library_ms": mt["fwd_library_ms"],
    }, {
        "name": "mlp_field_bwd", "route": "cuda",
        "source": "d3gs_tpu_torch/csrc/mlp_field.cu", "replaces": None,
        "launches": train_launches["mlp_field_bwd"],
        "max_rel_l2_err": mlp_errs[MLP_N]["vjp_l2_params"],
        "ms": mt["vjp_ms"], "plain_ms": mt["vjp_plain_ms"],
        "bound_ms": mt["vjp_bound_ms"], "bound_by": "ops",
        "library_ms": mt["library_fwd_bwd_ms"] - mt["fwd_library_ms"],
    }]
    log(f"[6] done in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
