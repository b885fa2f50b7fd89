"""Shared helpers of the port's benchmarks: CSV emission + artifact dir.

Copy of ``benchmarks/common.py`` for the PyTorch/CUDA port: the CSVs go
to ``artifacts/bench_torch/``, beside the reference's
``artifacts/bench/``.
"""
from __future__ import annotations

import os
import time

ART = os.path.join(os.path.dirname(__file__), "..", "..", "artifacts",
                   "bench_torch")


def emit(name: str, rows: list[dict], t0: float, derived: str = "") -> None:
    """Print the run.py contract line + write the full CSV artifact."""
    os.makedirs(ART, exist_ok=True)
    path = os.path.join(ART, name + ".csv")
    if rows:
        cols = list(rows[0])
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
            for r in rows:
                f.write(",".join(str(r[c]) for c in cols) + "\n")
    us = (time.time() - t0) * 1e6
    print(f"{name},{us:.0f},{derived}")
