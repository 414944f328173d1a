"""What the harness and the reference load: no module whose top-level
name (the part before the first dot, compared whole) is jax, jaxlib,
flax or d3gs_tpu; and the reference loads nothing of d3gs_tpu_torch."""
import json
import subprocess
import sys

from benchmark import run as harness

HARNESS = ["benchmark.run", "benchmark.program", "benchmark.replay",
           "benchmark.trace", "benchmark.calibrate", "benchmark.loops.train",
           "benchmark.loops.view"]
REFERENCE = ["benchmark.reference", "benchmark.reference.train",
             "benchmark.reference.render", "benchmark.reference.fields",
             "benchmark.scene", "benchmark.counts"]


def tops_after_import(modules):
    code = ("import json, sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "from benchmark import run\n"
            + "[run.reader(m['name']) for m in run.spec()['end_to_end'] "
            + "+ run.spec()['per_layer']]\n"
            + "print(json.dumps(sorted({m.split('.')[0] "
            + "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(harness.ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = tops_after_import(HARNESS)
    assert "d3gs_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "d3gs_tpu"}, tops


def test_reference_loads_nothing_of_the_program():
    tops = tops_after_import(REFERENCE)
    assert not tops & {"jax", "jaxlib", "flax", "d3gs_tpu",
                       "d3gs_tpu_torch"}, tops


def test_banned_names_are_whole():
    assert "d3gs_tpu_torch" not in harness.BANNED
    assert "d3gs_tpu" in harness.BANNED
