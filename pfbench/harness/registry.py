"""Find a cell's pieces by name: BENCHMARK.json, the cell's own file, its
configuration, its driver and the readers of its metrics.

    pfbench/workloads/<cell>.json    config, traffic, driver, params,
                                     chips, why
    pfbench/configs/<config>.json    the configuration as it is run
    pfbench/drivers/<driver>.py      the entry that a window drives
    pfbench/metrics/<metric>.py      read(ctx) -> number or None

A later cell, configuration or metric is a new file beside these and an
entry in BENCHMARK.json; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: str
    driver: str
    chips: int
    params: dict
    why: str


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name`: its file under pfbench/workloads, checked against
    its BENCHMARK.json entry, with its configuration file loaded."""
    bench = load_benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = json.loads((root / "pfbench" / "workloads" / f"{name}.json")
                      .read_text())
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {spec[key]!r} in its file "
                             f"and {entry[key]!r} in BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[spec["config"]]["file"]).read_text())
    return Cell(name=name, config=config, traffic=spec["traffic"],
                driver=spec["driver"], chips=int(spec["chips"]),
                params=dict(spec["params"]), why=spec["why"])


def metrics_for(cell: str, kind: str, root: Path = ROOT) -> List[Metric]:
    """The `kind` metrics ("end_to_end" or "per_layer") that cell reports,
    in BENCHMARK.json's order."""
    out = []
    for m in load_benchmark(root)[kind]:
        cells = m.get("workloads")
        if cells is None or cell in cells:
            out.append(Metric(m["name"], m["unit"]))
    return out


def driver_module(name: str) -> ModuleType:
    return importlib.import_module(f"pfbench.drivers.{name}")


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """pfbench/metrics/<metric>.py as a module (its name may hold dots)."""
    path = root / "pfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "pfbench.metrics._" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
