"""BENCHMARK.json against the rules the harness is built to: every
file is found by name, every per-layer metric moves an end-to-end metric
its cells report, names and units use the characters the checker takes."""
import json
import re
from pathlib import Path

import pytest

from benchmark import run as harness

ROOT = Path(harness.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.spec()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert cfg["file"].startswith("benchmark/configs/")
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    _, cfg, mix, limits = harness.cell_files(BENCH, cell["name"])
    assert (ROOT / "benchmark" / "loops" / f"{mix['loop']}.py").exists()
    assert all(isinstance(v, (int, float)) for v in limits.values())
    e2e = {m["name"] for m in harness.metrics_of(BENCH, cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(BENCH, cell["name"], True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert harness.reader(metric["name"])({}) is None
    cells = metric.get("workloads", [w["name"] for w in BENCH["workloads"]])
    if "moves" in metric:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        for c in cells:
            reported = {m["name"] for m in harness.metrics_of(BENCH, c,
                                                              False)}
            assert metric["moves"] in reported, (metric["name"], c)
    else:
        assert metric["source"] in ("device_trace", "host_clock")
        assert 0.01 <= metric["bound"] <= 0.25


def test_names():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(0 < len(x) <= 200 for x in layers)
