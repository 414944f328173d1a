"""On-card smoke test of the PyTorch/CUDA port (`d3gs_tpu_torch`).

    python3 chip_smoke.py          # one CUDA card; builds into build/

Phases (any failure exits non-zero):
  1. device: card name and power limit;
  2. build: every CUDA kernel of the port, compiled from csrc/ with nvcc;
  3. each kernel against its plain PyTorch version on the card: the bench
     scene (bench.py's recipe: 43,132 Gaussians, 400x400, SH degree 3, the
     8x256 Blender deform MLP at t=0.5) and the small blend scenes of
     tests/test_pallas_blend.py, at atol 5e-5 / rtol 1e-4;
  4. the main path: a D-NeRF-format dataset and a model directory at the
     bench scale, written by the port's own writers, rendered through
     `d3gs_tpu_torch.render.main([... "--mode", "render", "--benchmark"])`,
     with the kernels' launch counts read around that call;
  5. timings of the render stages at the bench shape (CUDA events);
  6. one JSON line per the kernels, the card, and the final status line.
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
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores
# transcendentals (exp, log): 16 SFU results / clock / SM (CUDA C programming
# guide, arithmetic instruction throughput, compute capability 9.0), 132 SMs
# at the 1.98 GHz boost clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9
BLEND_FLOPS_PER_EVAL = 15        # alpha quadratic, clamps, T update, accum
BLEND_SFU_PER_EVAL = 2           # exp(power) and log1p/exp of the T update


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

def knn_log_scales(points: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """create_from_pcd's scale init: log sqrt of the mean squared distance to
    the 3 nearest other points (chunked cdist on the card)."""
    d2_mean = []
    for s in range(0, points.shape[0], chunk):
        d = torch.cdist(points[s:s + chunk], points,
                        compute_mode="donot_use_mm_for_euclid_dist") ** 2
        rows = torch.arange(d.shape[0], device=points.device)
        d[rows, rows + s] = float("inf")
        d2_mean.append(d.topk(3, dim=1, largest=False).values.mean(dim=1))
    d2 = torch.cat(d2_mean).clamp_min(1e-7)
    return torch.log(torch.sqrt(d2))[:, None].expand(-1, 3).contiguous()


def bench_params(dev, *, f_rest_std: float = 0.0, seed: int = 0) -> dict:
    """bench.py:45-54 as numpy arrays of the padded state: 43,132 points
    uniform in [-1.3, 1.3]^3 (numpy seed 0), DC colour from uniform RGB,
    kNN log-scales, identity rotations, opacity logit 0.5 (bench.py:54),
    SH degree 3; f_rest ~ N(0, f_rest_std) from torch.Generator(seed)."""
    from d3gs_tpu_torch.models.gaussians import round_capacity
    from d3gs_tpu_torch.ops.sh import rgb2sh
    rng = np.random.default_rng(0)
    pts = (rng.random((N_BENCH, 3)) * 2.6 - 1.3).astype(np.float32)
    cols = rng.uniform(0, 1, (N_BENCH, 3)).astype(np.float32)
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


def stages(state, cam, field, bg, dup=0):
    """The render path of models/renderer.py, stage by stage:
    -> (records, bins, grid kwargs)."""
    from d3gs_tpu_torch.ops.binning import bin_splats_records
    from d3gs_tpu_torch.ops.projection import project_gaussians
    from d3gs_tpu_torch.ops.rasterize import pack_records
    from d3gs_tpu_torch.ops.sh import eval_sh_upto
    xyz, d_rot, d_sc = state.params.xyz, 0.0, 0.0
    if field is not None:
        dx, d_rot, d_sc = field.step(state.params.xyz, cam.fid)
        xyz = xyz + dx
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


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def profile_frames(frame, frames: int = 10, top: int = 12) -> dict:
    """torch.profiler over `frames` frames: wall time, device kernel time and
    the device's busy share per frame, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    kernels = [(e.key, e.self_device_time_total / 1e3 / frames,
                e.count / frames) for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.device_type.name == "CUDA"]
    kernels.sort(key=lambda k: -k[1])
    dev_ms = sum(k[1] for k in kernels)
    return {"wall_ms_per_frame": wall_ms, "device_ms_per_frame": dev_ms,
            "device_busy_share": dev_ms / wall_ms,
            "device_kernels_per_frame": sum(k[2] for k in kernels),
            "top_kernels_ms_per_frame": [
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
    log(f"[3] {name}: M={int(bins.starts[-1])} max|kernel-plain| "
        + ", ".join(msgs) + f" (tol {ATOL} + {RTOL}|ref|); "
        f"records walked equal at {100 * same_walk:.3f}% of pixels")
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
    from d3gs_tpu_torch import config as C
    from d3gs_tpu_torch import render as R
    from d3gs_tpu_torch.data.scene import save_gaussians_ply
    from d3gs_tpu_torch.models.deform.fields import (DeformFieldSpec,
                                                     create_deform_field,
                                                     save_deform_weights)
    from d3gs_tpu_torch.models.gaussians import gaussians_from_numpy
    from d3gs_tpu_torch.ops import _build
    from d3gs_tpu_torch.ops import blend as B

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[2] built {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.strip().splitlines():
            log(f"[2] {name}: {line}")

    # ---- 3. kernel vs plain ----------------------------------------------
    params, alive = bench_params(dev)
    state = gaussians_from_numpy(params, alive, 3, 3, dev)
    cam = look_from_z(4.0, WIDTH, dev)
    field = create_deform_field(DeformFieldSpec(kind="baseline",
                                                is_blender=True), device=dev)
    bg = torch.zeros(3, device=dev)
    records, bins, grid = stages(state, cam, field, bg)
    bench_err = compare_blend(f"bench scene {N_BENCH} @ {WIDTH}x{HEIGHT}", records, bins,
                              bg, grid)
    for name, st, z, dup, bgs in small_scenes(dev):
        compare_blend(name, *stages(st, look_from_z(z, 64, dev), None, bgs,
                                    dup)[:2], bgs,
                      dict(tiles_x=4, tiles_y=4, width=64, height=64))

    # ---- 4. main path ---------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="d3gs_smoke_") as tmp:
        data, mp = os.path.join(tmp, "data"), os.path.join(tmp, "model")
        write_dnerf_dataset(data)
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
        log(f"[4] render.main: {result} in {time.perf_counter() - t0:.1f} s; "
            f"kernel launches {launches}")
        frames = result["views"] + result["benchmark"]["frames"]
        if launches["blend_fwd"] < frames:
            raise AssertionError(f"blend_fwd launched {launches['blend_fwd']}"
                                 f" times for {frames} frames")

        from d3gs_tpu_torch.data.image_io import read_png
        from d3gs_tpu_torch.data.scene import Scene
        from d3gs_tpu_torch.models.deform.fields import load_deform_weights
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
        scene = Scene(cfg, shuffle=False, device=dev)
        fld = load_deform_weights(mp, create_deform_field(
            R.pick_field_spec(cfg), device=dev))
        view = scene.get_test_cameras()[0]
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

    # ---- 5. timings at the bench shape ------------------------------------
    from d3gs_tpu_torch.ops.binning import bin_splats_records
    from d3gs_tpu_torch.ops.projection import project_gaussians
    from d3gs_tpu_torch.ops.sh import eval_sh_upto
    from d3gs_tpu_torch.render_eval.render_modes import make_render_fn
    m = int(bins.starts[-1])
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
            # the kernel alone: launches into preallocated outputs, so the
            # wrapper's host work (checks, allocation) is not in the time
            "blend_kernel_ms": cuda_ms(lambda: B.launch(
                records, bins, bg, out, tiles_x=25, tiles_y=25), 200),
            "blend_wrapper_ms": cuda_ms(lambda: B.blend_forward_cuda(
                records, bins, bg, **grid), 50),
            "blend_plain_ms": cuda_ms(lambda: B.blend_forward_torch(
                records, bins, bg, **grid), 5, warmup=1),
            "frame_ms": cuda_ms(lambda: render_at(st, field, cam, bg), 20),
        }
        evals = int(out.n_walked.long().sum())
        prof = profile_frames(lambda: render_at(st, field, cam, bg))
    t["fps"] = 1000.0 / t["frame_ms"]
    t.update(M=m, pixel_record_evals=evals, gaussians=N_BENCH,
             size=f"{WIDTH}x{HEIGHT}", card=smi,
             cli_benchmark_fps=result["benchmark"]["fps"])
    log("[5] " + json.dumps(t))
    log("[5] profile of one frame: " + json.dumps(prof))

    n_rows = records.shape[0]
    bytes_moved = (n_rows * (10 * 4 + 4) + m * 4 + (grid["tiles_x"]
                   * grid["tiles_y"] + 1) * 4 + WIDTH * HEIGHT * 8 * 4)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(evals * BLEND_FLOPS_PER_EVAL / F32_FLOPS,
                evals * BLEND_SFU_PER_EVAL / SFU_OPS_PER_S) * 1e3
    kernels = [{
        "name": "blend_fwd", "route": "cuda",
        "source": "d3gs_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "d3gs_tpu/ops/pallas_blend.py:188",
        "launches": launches["blend_fwd"], "max_abs_err": bench_err,
        "ms": t["blend_kernel_ms"], "plain_ms": t["blend_plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
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
