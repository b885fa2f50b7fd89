"""Find a cell's parts by name: its configuration, its traffic mix, its
per-layer metric readers, and the benchmark's own ``BENCHMARK.json``.

Nothing here is specific to one cell: a cell, a configuration, a traffic
mix or a per-layer metric is added by adding its file and its entry in
``BENCHMARK.json``.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<mix>.json
    rate: float           # offered requests per second (cells/<cell>.json)
    check: dict           # the limits of the output check
    chips: int
    end_to_end: list      # BENCHMARK.json entries reported with --trace 0
    per_layer: list       # ... with --trace 1


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load(ROOT / "BENCHMARK.json")


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None,
              base: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with the files it names
    under ``base`` (``servebench/`` by default)."""
    bench = bench if bench is not None else benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = _load(base / "cells" / f"{name}.json")
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise ValueError(f"cells/{name}.json names {cell['config']} x "
                         f"{cell['traffic']}, BENCHMARK.json "
                         f"{entry['config']} x {entry['traffic']}")
    return Cell(
        name=name,
        config=_load(base / "configs" / f"{entry['config']}.json"),
        traffic=_load(base / "traffic" / f"{entry['traffic']}.json"),
        rate=float(cell["rate"]),
        check=dict(cell["check"]),
        chips=int(entry["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)])


def metric_reader(name: str, base: Path = HERE):
    """``metrics/<name>.py``'s ``read(record)``: the metric's value, or
    None where the run gave it nothing to read."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "servebench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
