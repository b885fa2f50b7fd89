"""Benchmark-record plumbing of the port.

Copy of ``benchmarks/_record.py``: a FULL run writes the committed
record at the repo root (``BENCH_<name>_torch.json``), a ``--smoke``
run a gitignored sibling (``BENCH_<name>_torch.smoke.json``), so a
small run never clobbers the full-scale record.  The reference's
``BENCH_<name>.json`` records are never written from here.
"""
from __future__ import annotations

import json
import os

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def record_paths(name: str) -> tuple[str, str]:
    """-> (committed full-run path, gitignored smoke path)."""
    return (os.path.join(REPO, f"BENCH_{name}_torch.json"),
            os.path.join(REPO, f"BENCH_{name}_torch.smoke.json"))


def write_record(name: str, payload: dict, smoke: bool,
                 indent: int = 1) -> str:
    """Write the record to the path the run class owns; -> the path."""
    full, smoke_path = record_paths(name)
    path = smoke_path if smoke else full
    with open(path, "w") as f:
        json.dump(payload, f, indent=indent)
        f.write("\n")
    print(f"wrote {path}")
    return path
