"""One run of one cell of BENCHMARK.json:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository root. Set-up (the port's CUDA libraries loaded from
`build/`, or built there on a checkout's first run; the scene, weights and
targets made on the card from the seed; the first steps or frames) counts
from process start to the first timed step. The window then runs for
`--seconds`. With `--trace 1` its last `profile_seconds` run under
`torch.profiler` and the per-layer metrics are reported, else the
end-to-end ones. After the window: the peak of device memory, the traced
run's extra readings, the program's state freed, then the plain reference's
comparison, each number printed beside its limit on stderr and, under
"checks", last in the result line: one JSON object, the last line of
stdout.

Exits 3 without a result where there is no CUDA card or fewer than the
cell asks for, and 4 where jax, jaxlib, flax or the JAX package is loaded
once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "d3gs_tpu")
WATCHDOG_S = 900


def spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(bench: dict, workload: str):
    """(cell, configuration, mix, limits) of `workload`, each read from
    its file by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[cell["config"]]
    return (cell, *files(cfg_file, cell["traffic"], workload))


def files(cfg_file: str, traffic: str, workload: str):
    """(configuration, mix, limits) from their files."""
    load = lambda p: json.loads((ROOT / p).read_text())  # noqa: E731
    return (load(cfg_file), load(f"benchmark/mixes/{traffic}.json"),
            load(f"benchmark/limits/{workload}.json"))


def reader(name: str):
    """`read` of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, traced: bool) -> list[dict]:
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in BANNED})


def _watchdog():
    print(f"benchmark: no result within {WATCHDOG_S} s", file=sys.stderr,
          flush=True)
    os._exit(3)


def one_core() -> None:
    """Run on one CPU core, the last the process may use, with one thread
    for PyTorch's CPU operators: the host's share of a step swings with the
    other work on a shared host, and of the placements tried one core held
    a run's rate steadiest (PERF.md)."""
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-1:])
    os.environ["OMP_NUM_THREADS"] = "1"


def run(workload: str, seed: int, seconds: float, traced: bool) -> int:
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    bench = spec()
    cell, cfg, mix, limits = cell_files(bench, workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out, r, numbers = run_cell(bench, cell, cfg, mix, limits, seed, seconds,
                               traced, "cuda")
    found = banned_modules()
    if found:
        print(f"benchmark: modules loaded that the port must not load: "
              f"{found}", file=sys.stderr)
        return 4
    info = {k: v for k, v in r.items()
            if k not in ("trace", "deform_ms", "render_ms")}
    print("benchmark readings: " + json.dumps(info), file=sys.stderr)
    print("benchmark numbers: " + json.dumps(numbers), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def run_cell(bench: dict, cell: dict, cfg: dict, mix: dict, limits: dict,
             seed: int, seconds: float, traced: bool, device) -> tuple:
    """Set-up, window, readings and the comparison of one run on `device`
    -> (the result line's object, the readings, the numbers compared)."""
    import torch
    cuda = torch.device(device).type == "cuda"
    loop_mod = importlib.import_module(f"benchmark.loops.{mix['loop']}")
    loop = loop_mod.Loop(cfg, mix, seed, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    loop.setup()
    if cuda:
        torch.cuda.synchronize()
    r = {"setup_s": time.perf_counter() - T0}
    r.update(loop.window(seconds, traced))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    r.update(loop.finish(traced))
    loop.release()
    numbers = loop.check()

    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items() if lim is not None}
    checks["failed"] = {"value": r["failed"], "limit": 0}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = {}
    for m in metrics_of(bench, cell["name"], traced):
        value = reader(m["name"])(r)
        if value is None and not traced:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": r["attempted"],
           "failed": r["failed"], "metrics": metrics, "device": device_info}
    if traced:
        device_info.update(busy_s=r["trace"]["busy_s"],
                           window_s=r["trace"]["window_s"])
        out["breakdown"] = r["trace"]["breakdown"]
    out["checks"] = checks
    return out, r, numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    one_core()
    timer = threading.Timer(WATCHDOG_S, _watchdog)
    timer.daemon = True
    timer.start()
    try:
        return run(args.workload, args.seed, args.seconds, bool(args.trace))
    finally:
        timer.cancel()


if __name__ == "__main__":
    sys.exit(main())
