"""The smoke cell of the tests: phi3's smoke form under a small mix
(``tests/data``), run on the CPU through the benchmark's own path."""
from __future__ import annotations

import argparse
import io
import json
import time
from contextlib import redirect_stdout
from pathlib import Path

from servebench import spec

DATA = Path(__file__).resolve().parent / "data"
CELL = "phi3-smoke.smoke"


def bench() -> dict:
    real = spec.benchmark()
    return {"workloads": [{"name": CELL, "config": "phi3-smoke",
                           "traffic": "smoke", "chips": 1}],
            "end_to_end": [dict(m, workloads=[CELL]) if "workloads" in m
                           else m for m in real["end_to_end"]],
            "per_layer": [dict(m, workloads=[CELL])
                          for m in real["per_layer"]]}


def cell(load: float = 1.0):
    """The smoke cell, its rate times ``load``."""
    c = spec.load_cell(CELL, bench=bench(), base=DATA)
    c.rate *= load
    return c


def run(seed: int, seconds: float = 1.5, trace: int = 0,
        load: float = 1.0) -> dict:
    """One CPU run of the smoke cell -> its result line."""
    from servebench import run_cell
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=trace)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run_cell.run(cell(load), args, time.perf_counter(),
                          device="cpu")
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
