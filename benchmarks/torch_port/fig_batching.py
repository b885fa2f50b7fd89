"""Batching validation sweep: does the simulator predict the engine's knee?

Twin of ``benchmarks/fig_batching.py`` on the PyTorch/CUDA port: the same
grid, run through ``repro_torch.sweep``; the figure CSV goes to
``artifacts/bench_torch/``.

For several ``max_batch`` settings, sweep offered QPS over the
``batched-serving`` scenario on both runtimes, the virtual-time event
simulator and the wall-clock ``EngineRuntime`` driving
``BatchedStubEngine`` replicas in virtual time (the same
``BatchedService`` + ``BatchScheduler`` dynamics the real engine's
scheduler follows), and compare the p99-vs-QPS curves and their knees.
Both runtimes are host code, so the whole benchmark runs on the host;
it touches no card.

Declared as one ``repro_torch.sweep`` grid with the runtime as an axis
(``runtime=sim,engine``): the executor builds the right runtime per
point, so the sim-vs-engine A/B is just another swept dimension.

The knee is the offered QPS at which p99 crosses ``KNEE_FACTOR`` x the
low-load p99 (log-interpolated between sweep points).  The gate: the
simulator's knee within 15% of the engine runtime's at every max_batch.

Usage:
    PYTHONPATH=src:. python benchmarks/torch_port/fig_batching.py
    PYTHONPATH=src:. python benchmarks/torch_port/fig_batching.py --quick
"""
from __future__ import annotations

import math
import sys
import time

from benchmarks.torch_port.common import emit
from repro_torch.core.profiles import TokenLengths
from repro_torch.scenarios import get
from repro_torch.scenarios.canonical import default_batched_service
from repro_torch.sweep import Axis, PointCtx, Sweep, run_sweep

KNEE_FACTOR = 3.0          # p99 crossing vs the lowest swept load
MAX_BATCHES = (2, 4, 8)
N_SERVERS = 1
N_CLIENTS = 3
SEED = 13


def capacity_estimate(service, lengths, max_batch: int) -> float:
    """Requests/sec the fleet sustains at full occupancy.  Decode steps
    amortize across the batch (mean output tokens x step cost / slots),
    but prefills do not: the scheduler runs one op at a time, so every
    request serializes its full prefill on the server."""
    mean_new = lengths.mean_new_tokens
    decode_s = mean_new * service.step_time(max_batch) / max_batch
    prefill_s = service.prefill_time(int(lengths.prompt_median))
    return N_SERVERS / (decode_s + prefill_s)


def point_qps(max_batch: int, frac: float) -> float:
    service, lengths = default_batched_service(), TokenLengths()
    return round(frac * capacity_estimate(service, lengths, max_batch), 1)


def _point(ctx: PointCtx):
    service, lengths = default_batched_service(), TokenLengths()
    return get("batched-serving", seed=ctx.seed,
               duration=ctx.params["duration"],
               qps=point_qps(ctx.params["max_batch"], ctx.params["frac"]),
               n_clients=N_CLIENTS, n_servers=N_SERVERS,
               max_batch=ctx.params["max_batch"],
               service=service, lengths=lengths)


def knee_qps(points: list[tuple]) -> float:
    """Offered QPS where p99 crosses KNEE_FACTOR x the low-load p99,
    log-interpolated between the bracketing sweep points (inf if the
    sweep never saturates)."""
    base = points[0][1]
    thresh = KNEE_FACTOR * base
    for (q0, p0), (q1, p1) in zip(points, points[1:]):
        if p0 <= thresh < p1:
            f = (math.log(thresh) - math.log(p0)) \
                / (math.log(p1) - math.log(p0))
            return q0 + f * (q1 - q0)
    return float("inf")


def build_sweep(quick: bool) -> Sweep:
    duration = 8.0 if quick else 20.0
    fracs = ([0.4, 0.8, 1.0, 1.2] if quick
             else [0.3, 0.5, 0.7, 0.85, 0.95, 1.05, 1.15, 1.3])
    return Sweep(name="fig_batching", factory=_point,
                 axes=(Axis("max_batch", MAX_BATCHES),
                       Axis("frac", tuple(fracs)),
                       Axis("runtime", ("sim", "engine"))),
                 fixed={"duration": duration}, reps=1,
                 base_seed=SEED, seeder="fixed",
                 metrics=("n", "p50", "p95", "p99"))


def main() -> str:
    quick = "--quick" in sys.argv[1:]
    sweep = build_sweep(quick)
    t0 = time.time()
    frame = run_sweep(sweep, progress=None).raise_errors()
    rows, pts = [], {}
    for r in frame.rows:
        mb, backend = r.params["max_batch"], r.params["runtime"]
        qps, m = point_qps(mb, r.params["frac"]), r.metrics
        pts.setdefault((mb, backend), []).append((qps, m["p99"]))
        rows.append({"max_batch": mb, "backend": backend,
                     "offered_qps": qps, "n": m["n"],
                     "p50_ms": m["p50"] * 1e3, "p95_ms": m["p95"] * 1e3,
                     "p99_ms": m["p99"] * 1e3})
    ratios = {}
    for mb in MAX_BATCHES:
        cap = capacity_estimate(default_batched_service(), TokenLengths(), mb)
        k_sim, k_eng = knee_qps(pts[(mb, "sim")]), knee_qps(pts[(mb, "engine")])
        ratios[mb] = k_sim / k_eng if k_eng not in (0.0, float("inf")) \
            else float("nan")
        print(f"max_batch={mb}: capacity~{cap:.0f} qps, "
              f"knee sim={k_sim:.1f} engine={k_eng:.1f} "
              f"ratio={ratios[mb]:.3f}", file=sys.stderr)
    # a non-finite ratio means a max_batch setting was never validated
    # (no knee on one runtime): a failure, not a pass
    worst = max((abs(r - 1.0) if math.isfinite(r) else float("inf"))
                for r in ratios.values())
    ok = worst <= 0.15
    derived = (f"knee_ratio_max_err={worst:.3f},within_15pct={ok},"
               + ",".join(f"mb{m}={r:.3f}" for m, r in ratios.items()))
    emit("fig_batching", rows, t0, derived)
    if not ok:
        print(f"FAIL: sim-vs-engine knee disagreement {worst:.1%} > 15%",
              file=sys.stderr)
    return derived


if __name__ == "__main__":
    out = main()
    sys.exit(0 if "within_15pct=True" in out else 1)
