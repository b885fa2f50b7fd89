"""Declarative experiment sweeps — the TailBench++ grid layer, on the
card.

Port of ``repro.sweep``.  The paper's whole methodology is grids: every
figure sweeps app x QPS x server-count x policy over 13 seeded
repetitions.  This package makes that a declarative object:

* ``repro_torch.sweep.spec`` — the ``Sweep`` dataclass: axes over
  ``Experiment``/``Scenario`` parameters (grid, zip, and explicit
  list-of-points forms), repetition counts, metric selection, and
  per-(point, rep) deterministic seed derivation via a
  SeedSequence-style spawn;
* ``repro_torch.sweep.executor`` — serial and ``ProcessPoolExecutor``
  backends behind one ``run_sweep()`` interface, bit-identical results
  regardless of worker count or scheduling order, with per-point
  failure capture; every ``runtime="vector"`` task of a sweep runs as
  ONE grid on the card (``repro_torch.vector.run_cells``);
* ``repro_torch.sweep.results`` — the ``ResultFrame`` artifact: typed
  rows, exact ``to_json``/``from_json`` round-trip, CSV emission, and
  Welch-t-test compare helpers.

The same declaration gives the same frame as the reference's:
bit-identical on ``sim`` and ``engine``, and on ``vector`` within the
vector runtime's parity with the JAX package.  Where the port's
defaults differ: the vector grid runs on the card unless
``vector_config`` asks for the CPU, and the CLI's ``--runtime`` defaults
to ``vector`` (the reference's to ``sim``).  A ``mode="optimize"``
sweep runs the gradient planner (``repro_torch.plan``).  ``cache=``
takes the port's result cache (``repro_torch.cache``).

    PYTHONPATH=src python -m repro_torch.sweep --list
    PYTHONPATH=src python -m repro_torch.sweep steady --axis qps=300,600,900 \
        --axis n_servers=1,2 --reps 13
    PYTHONPATH=src python -m repro_torch.sweep --smoke --device cpu
"""
from __future__ import annotations

from repro_torch.sweep.executor import run_sweep
from repro_torch.sweep.results import ResultFrame, SweepRow, series_window
from repro_torch.sweep.spec import (SEEDERS, Axis, PointCtx, Sweep,
                                    experiment_factory, scenario_factory,
                                    spawn_seed)

__all__ = [
    "Axis", "PointCtx", "ResultFrame", "SEEDERS", "Sweep", "SweepRow",
    "experiment_factory", "run_sweep", "scenario_factory", "series_window",
    "spawn_seed",
]
