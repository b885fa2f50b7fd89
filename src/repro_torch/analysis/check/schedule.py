"""Schedule sanity: offered load, horizon coverage, dead intervals.

Copy of ``repro.analysis.check.schedule`` on the port's compiler,
``repro_torch.vector.compile.compile_experiment``: host NumPy, so a
check touches no card.

Reuses the vector compiler's static lowering (``compile_experiment``)
as a load model — per-slot offered request rates, per-slot capacity
after joins/drains/failures/speed changes — WITHOUT running anything.
From that it derives the per-slot utilization ρ and warns when the
declared schedule saturates (ρ≥1 sustained: the queue grows without
bound, so tail percentiles measure the horizon, not the system),
when clients or injections start after the horizon ends, and when
long stretches of the horizon carry zero offered load.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.analysis.check.findings import CheckFinding

#: sustained-overload threshold: consecutive seconds at rho >= 1
OVERLOAD_SECONDS = 2.0
#: fraction of the horizon with zero offered load that draws a warning
ZERO_RATE_FRAC = 0.5


def _longest_run(mask: np.ndarray) -> int:
    """Length (slots) of the longest consecutive True run."""
    best = cur = 0
    for v in mask:
        cur = cur + 1 if v else 0
        best = max(best, cur)
    return best


def offered_rho(prog) -> tuple:
    """-> (rho[T], offered[T] work-seconds/s, capacity[T]) from a
    ``VectorProgram``."""
    if prog.batched:
        per_req = prog.prefill_mean
        if prog.max_batch > 0 and prog.service is not None:
            per_req = per_req + prog.new_mean * \
                prog.service.step_time(prog.max_batch) / prog.max_batch
        offered = (prog.rate_conn.sum(axis=1) + prog.rate_free) * per_req
        capacity = (prog.speed * prog.active).sum(axis=1)
    else:
        offered = (prog.rate_conn * prog.work_mean[None, :]).sum(axis=1)
        if prog.rate_free.any():
            offered = offered + prog.rate_free * \
                float(prog.work_mean.mean())
        capacity = (prog.workers[None, :] * prog.speed *
                    prog.active).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = np.where(capacity > 0.0, offered / np.maximum(capacity,
                                                            1e-300),
                       np.where(offered > 0.0, np.inf, 0.0))
    return rho, offered, capacity


def check_schedule(exp, target: str, dt: float = 0.05) -> list:
    """-> [CheckFinding] for one compiled ``Experiment``."""
    findings = []
    dur = float(exp.duration)
    if dur <= 0.0 or not math.isfinite(dur):
        findings.append(CheckFinding(
            rule="schedule", severity="error", target=target,
            message=(f"duration={dur:g} leaves no finite measurement "
                     f"horizon")))
        return findings
    for c in exp.clients:
        if c.start_time >= dur:
            findings.append(CheckFinding(
                rule="schedule", severity="warning", target=target,
                message=(f"client {c.client_id!r} starts at "
                         f"{c.start_time:g}s, at/after the {dur:g}s "
                         f"horizon — it never sends")))
    for inj in exp.injections:
        if inj.at >= dur:
            findings.append(CheckFinding(
                rule="schedule", severity="warning", target=target,
                message=(f"injection {inj.kind}@{inj.at:g}s fires "
                         f"at/after the {dur:g}s horizon — it never "
                         f"happens")))

    from repro_torch.vector.compile import VectorCompileError, \
        compile_experiment
    try:
        prog = compile_experiment(exp, dt=min(dt, dur / 4.0))
    except VectorCompileError:
        # legacy-mode experiments have no static load model; the
        # horizon checks above still ran
        return findings
    rho, offered, capacity = offered_rho(prog)

    if not np.any(offered > 0.0):
        findings.append(CheckFinding(
            rule="schedule", severity="error", target=target,
            message="no client offers any load inside the horizon"))
        return findings

    # overload is only unbounded when nothing manages it: client
    # timeouts bound queue residence, admission control sheds the
    # excess, and a closed-loop controller reacts to it — a scenario
    # carrying any of those is *supposed* to offer rho>=1
    managed = (getattr(exp, "retry", None) is not None
               or getattr(exp, "control", None) is not None
               or any(inj.kind == "set_admission"
                      for inj in exp.injections))
    over = rho >= 1.0
    run_s = _longest_run(over) * prog.dt
    if not managed and run_s >= min(OVERLOAD_SECONDS, 0.5 * dur):
        frac = float(over.mean())
        peak = float(np.max(rho[np.isfinite(rho)], initial=0.0))
        peak_s = "inf" if np.isinf(rho).any() else f"{peak:.2f}"
        findings.append(CheckFinding(
            rule="schedule", severity="warning", target=target,
            message=(f"offered load sustains rho>=1 for {run_s:.1f}s "
                     f"({frac:.0%} of the horizon, peak rho="
                     f"{peak_s}) — queues grow without bound, tail "
                     f"percentiles measure the horizon length")))

    zero_frac = float((offered <= 0.0).mean())
    if zero_frac >= ZERO_RATE_FRAC:
        findings.append(CheckFinding(
            rule="schedule", severity="warning", target=target,
            message=(f"{zero_frac:.0%} of the horizon carries zero "
                     f"offered load — shrink the horizon or the "
                     f"gaps dominate every mean")))

    warmup = getattr(exp, "interval", 0.0) or 0.0
    if warmup >= dur:
        findings.append(CheckFinding(
            rule="schedule", severity="warning", target=target,
            message=(f"reporting interval {warmup:g}s >= horizon "
                     f"{dur:g}s — at most one interval sample")))
    return findings
