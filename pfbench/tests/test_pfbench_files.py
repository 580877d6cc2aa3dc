"""BENCHMARK.json against the contract's shape, every cell's files, and a
new cell and metric found as files without an edit."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from pfbench.harness import registry

ROOT = registry.ROOT
BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["pfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("pfbench/") and not c["reduced"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m.name for m in registry.metrics_for(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_for(w["name"], "per_layer")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_file_loads(name):
    cell = registry.load_cell(name)
    assert cell.config["name"] == name.split(".")[0]
    assert registry.driver_module(cell.driver).Driver
    release = json.loads((ROOT / cell.config["release"] / (
        "meta.json")).read_text())
    assert release["config"] == cell.config["config"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(registry.reader(metric).read)


def test_new_cell_and_metric_are_found_as_files(tmp_path):
    """A cell and a per-layer metric added as files and entries, with no
    other file changed, are loaded and read."""
    shutil.copytree(ROOT / "pfbench" / "configs", tmp_path / "pfbench" /
                    "configs")
    shutil.copytree(ROOT / "pfbench" / "workloads", tmp_path / "pfbench" /
                    "workloads")
    shutil.copytree(ROOT / "pfbench" / "metrics", tmp_path / "pfbench" /
                    "metrics")
    bench = json.loads(json.dumps(BENCH))
    spec = json.loads((ROOT / "pfbench" / "workloads" /
                       "npe_r7.sample.json").read_text())
    spec["traffic"] = "closed_4x1024"
    spec["params"]["events_per_request"] = 4
    (tmp_path / "pfbench" / "workloads" / "npe_r7.small.json").write_text(
        json.dumps(spec))
    bench["workloads"].append({"name": "npe_r7.small", "config": "npe_r7",
                               "traffic": "closed_4x1024", "chips": 1,
                               "why": "a test cell"})
    (tmp_path / "pfbench" / "metrics" / "units_seen.small.py").write_text(
        "def read(run):\n    return run.units\n")
    bench["per_layer"].append({"name": "units_seen.small", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "Entry", "moves": "draws_per_s",
                               "workloads": ["npe_r7.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.load_cell("npe_r7.small", root=tmp_path)
    assert cell.params["events_per_request"] == 4
    names = [m.name for m in registry.metrics_for("npe_r7.small",
                                                  "per_layer", tmp_path)]
    assert names == ["units_seen.small"]
    run = type("Run", (), {"units": 7})()
    assert registry.reader("units_seen.small", tmp_path).read(run) == 7
