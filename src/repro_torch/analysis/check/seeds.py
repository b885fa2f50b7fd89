"""Seed-collision detection across sweep axes.

Copy of ``repro.analysis.check.seeds``, over the port's ``Sweep``
(``repro_torch.sweep.spec``): its ``tasks()`` and ``seed_for`` are the
reference's, seed for seed.

Enumerates the exact ``(seed, rng_stream)`` pair every (point, rep)
task of a ``Sweep`` would receive — the same ``seed_for`` the executor
calls — and reports collisions.  This is how ad-hoc seeders go wrong:
``base + 1000*(rep+1)`` makes point-0/rep-1 replay point-1/rep-0, so
supposedly independent repetitions are correlated and every CI is
quietly too narrow ("Tell-Tale Tail Latencies").

The ``"fixed"`` seeder is exempt by contract: it hands every task the
same seed on purpose and the factory owns per-rep variation.  For the
``"spawn"`` seeder the spawn keys ``(point, rep)`` are unique by
construction, so the derived 32-bit seeds are additionally checked for
the (astronomically unlikely, but cheap to verify) hash collision.
"""
from __future__ import annotations

from repro_torch.analysis.check.findings import CheckFinding

#: refuse to enumerate grids beyond this many tasks
MAX_TASKS = 200_000


def check_sweep_seeds(sweep, target: str = "") -> list:
    """-> [CheckFinding] for duplicate (seed, stream) pairs."""
    target = target or getattr(sweep, "name", "sweep")
    findings = []
    if isinstance(sweep.seeder, str) and sweep.seeder == "fixed":
        return findings
    tasks = sweep.tasks()
    if len(tasks) > MAX_TASKS:
        findings.append(CheckFinding(
            rule="seed-collision", severity="warning", target=target,
            message=(f"grid has {len(tasks)} tasks; seed enumeration "
                     f"skipped beyond {MAX_TASKS}")))
        tasks = tasks[:MAX_TASKS]
    seen: dict = {}
    for index, _params, rep in tasks:
        key = sweep.seed_for(index, rep)
        prior = seen.get(key)
        if prior is not None:
            pi, pr = prior
            seeder = sweep.seeder if isinstance(sweep.seeder, str) \
                else getattr(sweep.seeder, "__name__", "custom")
            findings.append(CheckFinding(
                rule="seed-collision", severity="error", target=target,
                message=(f"seeder {seeder!r}: point {index} rep {rep} "
                         f"and point {pi} rep {pr} derive the same "
                         f"(seed, stream)={key} — repetitions are "
                         f"correlated, not independent (use the "
                         f"'spawn' seeder)")))
        else:
            seen[key] = (index, rep)
    return findings
