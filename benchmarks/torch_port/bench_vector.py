"""Vector-runtime benchmark of the port: grid throughput on the card and
the statistical-equivalence gate.

Twin of ``benchmarks/bench_vector.py`` on the PyTorch/CUDA port.  Two
measurements, one record (``BENCH_vector_torch.json``; ``--smoke`` runs
write ``BENCH_vector_torch.smoke.json``):

1. **Points/sec on the fig1 grid shape** — the paper's Fig. 1 sweep (9
   offered-QPS points, 3 clients, one 6-worker xapian server, 15s
   horizon) at the paper's 13 repetitions = 117 (point, rep) cells.
   The serial event engine (``sim``, on the host) replays them one run
   at a time; the vector backend runs the whole grid as ONE program
   through ``run_vector_tasks``: ``vector_cuda`` (the CUDA kernels on
   the card: one ``scalar_scan`` and one ``fused_quantiles`` launch for
   the grid) and ``vector_cpu`` (the kernels' plain PyTorch versions on
   the host).  Each row reports a cold wall clock (the first call in
   the process: for ``vector_cuda`` the kernels' build and load
   included) and a warm one; the speedup headline is the warm figure.

2. **The fig4-style equivalence gate** — the vector backend is the
   statistically-equivalent fast lane, not a bit-identical one, so the
   record carries the evidence: for every canonical scenario, 13
   seeded repetitions per backend and a per-metric (p50/p95/p99) gate:
   95% CI overlap (with a small relative slack) OR Welch's H0
   retained.  The vector side runs on ``--device``.

The record names where it ran: the card's name, count and power limit
(``nvidia-smi``) or the CPU.  Without a card the default run fails
rather than carrying on on the host; ``--device cpu`` runs the plain
versions on purpose.  Every grid runs with ``fail_fast``: an error row
fails the run.

Usage (from the repository root):
    python benchmarks/torch_port/bench_vector.py          # full, on the card
    python benchmarks/torch_port/bench_vector.py --smoke --check 3.0
    python benchmarks/torch_port/bench_vector.py --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(REPO, "src"))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from benchmarks.torch_port._record import write_record  # noqa: E402
from repro_torch.core.client import ClientConfig, ConstantQPS  # noqa: E402
from repro_torch.core.harness import Experiment, ServerSpec  # noqa: E402
from repro_torch.core.runtime import SimulatorRuntime  # noqa: E402
from repro_torch.core.stats import confidence95, welch_ttest  # noqa: E402
from repro_torch.scenarios import get  # noqa: E402
from repro_torch.sweep import Axis, PointCtx, Sweep, run_sweep  # noqa: E402
from repro_torch.sweep.executor import run_vector_tasks  # noqa: E402
from repro_torch.sweep.spec import spawn_seed  # noqa: E402
from repro_torch.vector import VectorConfig, VectorRuntime  # noqa: E402

FULL_QPS = (100, 250, 500, 1000, 2000, 3000, 4000, 4600, 5200)
SMOKE_QPS = (200, 500, 1000, 2000)
METRICS = ("p50", "p95", "p99")
#: relative slack on the CI-overlap test (razor-thin CI pairs must not
#: turn realization noise into a gate failure)
REL_SLACK = 0.10


def _fig1_point(ctx: PointCtx) -> Experiment:
    qps = ctx.params["qps"]
    clients = [ClientConfig(i, ConstantQPS(qps / 3), seed=1)
               for i in range(3)]
    return Experiment(clients=clients, servers=(ServerSpec(0, workers=6),),
                      duration=ctx.params["duration"], app="xapian",
                      seed=ctx.seed)


def build_grid(smoke: bool, runtime: str) -> Sweep:
    qps = SMOKE_QPS if smoke else FULL_QPS
    return Sweep(name="bench_vector_fig1", factory=_fig1_point,
                 axes=(Axis("qps", qps),),
                 fixed={"duration": 6.0 if smoke else 15.0},
                 reps=3 if smoke else 13, base_seed=1, seeder="spawn",
                 runtime=runtime,
                 metrics=("n", "mean", "p50", "p95", "p99"))


def time_grid(sweep: Sweep, config=None) -> tuple:
    """(rows, wall seconds) of one run of the grid: ``sim`` through
    ``run_sweep`` (``config`` None), else the vector grid on
    ``config.device``.  Any failing task raises (``fail_fast``)."""
    t0 = time.perf_counter()
    if config is None:
        rows = run_sweep(sweep, executor="serial", progress=None,
                         fail_fast=True).rows
    else:
        tasks = [(k, i, params, rep)
                 for k, (i, params, rep) in enumerate(sweep.tasks())]
        rows = list(run_vector_tasks(sweep, tasks, fail_fast=True,
                                     config=config).values())
    wall = time.perf_counter() - t0
    return rows, wall


def grid_programs(sweep: Sweep) -> tuple:
    """(programs, (seed, stream) pairs): every task of a vector sweep,
    compiled from the declaration's own factory as ``run_vector_tasks``
    compiles it — what ``run_cells`` takes for the same grid."""
    from repro_torch.vector import compile_experiment
    progs, seeds = [], []
    for i, params, rep in sweep.tasks():
        seed, stream = sweep.seed_for(i, rep)
        ctx = PointCtx(params=params, index=i, rep=rep, seed=seed,
                       stream=stream)
        obj = sweep.factory(ctx)
        exp = obj.compile() if hasattr(obj, "compile") else obj
        progs.append(compile_experiment(exp, dt=VectorConfig().dt))
        seeds.append((exp.seed, stream))
    return progs, seeds


def bucket_histogram(sweep: Sweep) -> dict:
    """Cells per (family, padded (T, S) bucket) — the shapes the scan
    kernels launch at, one launch per bucket."""
    from repro_torch.vector.runtime import _plan_groups
    return {f"{'batched' if batched else 'scalar'}:{T}x{S}": len(idxs)
            for batched, (T, S), idxs in
            _plan_groups(grid_programs(sweep)[0])}


def _launch_counters() -> tuple:
    from repro_torch.kernels import vector_quantiles, vector_step
    return (vector_step.scalar_scan, vector_step.batched_scan,
            vector_quantiles.fused_quantiles)


def _vector_row(label: str, cfg: VectorConfig, sweep: Sweep, n_tasks: int,
                sim_wall: float) -> dict:
    print(f"  vector backend ({label}) ...", file=sys.stderr, flush=True)
    _, cold = time_grid(sweep, config=cfg)
    for k in _launch_counters():
        k.launches = 0
    rows, warm = time_grid(sweep, config=cfg)
    launches = {k.__name__: k.launches for k in _launch_counters()}
    warm = min(cold, warm)
    print(f"    cold {cold:.3f}s warm {warm:.3f}s", file=sys.stderr)
    row = {
        "device": cfg.device,
        "cold_wall_s": cold,            # includes the kernels' build/load
        "warm_wall_s": warm,
        "points_per_sec": n_tasks / warm,
        "speedup_vs_sim": sim_wall / warm,
        "cold_speedup_vs_sim": sim_wall / cold,
        "errors": sum(1 for r in rows if not r.ok),
        "bucket_hist": bucket_histogram(sweep)}
    if cfg.device == "cuda":
        row["launches"] = launches      # the warm run's kernel launches
    return row


def grid_rows(smoke: bool, device: str) -> dict:
    n_tasks = len(build_grid(smoke, "sim").tasks())
    print(f"  serial event engine ({n_tasks} cells) ...", file=sys.stderr,
          flush=True)
    sim_rows, sim_wall = time_grid(build_grid(smoke, "sim"))
    print(f"    {sim_wall:.3f}s", file=sys.stderr)
    out = {"tasks": n_tasks,
           "sim": {"wall_s": sim_wall,
                   "points_per_sec": n_tasks / sim_wall,
                   "errors": sum(1 for r in sim_rows if not r.ok)}}
    sweep = build_grid(smoke, "vector")
    devices = ("cuda", "cpu") if device == "cuda" else ("cpu",)
    for dev in devices:
        out[f"vector_{dev}"] = _vector_row(dev, VectorConfig(device=dev),
                                           sweep, n_tasks, sim_wall)
    return out


# ---------------------------------------------------------------------------
# Equivalence gate (fig4 methodology: repeated seeded runs per backend)
# ---------------------------------------------------------------------------
def _run_reps(name: str, backend: str, reps: int, duration=None,
              device: str = "cuda") -> dict:
    vals: dict[str, list] = {m: [] for m in METRICS}
    kw = {} if duration is None else {"duration": duration}
    cfg = VectorConfig(device=device)
    for rep in range(reps):
        exp = get(name, seed=spawn_seed(0x6A7E, 0, rep), **kw).compile()
        rt = SimulatorRuntime(exp, rep=rep) if backend == "sim" \
            else VectorRuntime(exp, rep=rep, config=cfg)
        rt.run()
        s = rt.telemetry.overall()
        for m in METRICS:
            vals[m].append(getattr(s, m))
    return vals


#: the gate's scenarios: the seven canonical ones, as in the reference's
#: record (the chaos scenarios' retries and breakers run on ``sim`` only)
CANONICAL = ("batched-serving", "churn-storm", "diurnal-fleet",
             "elastic-autoscale", "flash-crowd", "server-failure", "steady")


def equivalence_gate(smoke: bool, device: str) -> dict:
    reps = 5 if smoke else 13
    rows = []
    all_pass = True
    for name in CANONICAL:
        # smoke shortens the horizon — except batched-serving, whose
        # occupancy ramp needs its full default horizon to compare
        duration = None if (not smoke or name == "batched-serving") \
            else 12.0
        print(f"  equivalence: {name} ({reps} reps x 2 backends) ...",
              file=sys.stderr, flush=True)
        sim_vals = _run_reps(name, "sim", reps, duration)
        vec_vals = _run_reps(name, "vector", reps, duration, device)
        for m in METRICS:
            ms, cs = confidence95(sim_vals[m])
            mv, cv = confidence95(vec_vals[m])
            gap = abs(ms - mv)
            slack = (0.0 if np.isnan(cs) else cs) + \
                (0.0 if np.isnan(cv) else cv) + REL_SLACK * ms
            w = welch_ttest(sim_vals[m], vec_vals[m])
            retained = bool(abs(w.t_stat) < 2 and w.p_value > 0.05) \
                if not np.isnan(w.t_stat) else False
            ok = bool(gap <= slack or retained)
            all_pass &= ok
            rows.append({"scenario": name, "metric": m,
                         "sim_mean": ms, "sim_ci95": cs,
                         "vector_mean": mv, "vector_ci95": cv,
                         "ci_overlap": bool(gap <= slack),
                         "welch_t": w.t_stat,
                         "welch_p": w.p_value,
                         "welch_retained": retained,
                         "passed": ok})
            if not ok:
                print(f"    GATE FAIL {name}/{m}: sim {ms:.6g}+-{cs:.2g} "
                      f"vs vector {mv:.6g}+-{cv:.2g}", file=sys.stderr)
    return {"reps": reps, "rel_slack": REL_SLACK, "device": device,
            "rows": rows, "all_passed": bool(all_pass)}


def device_record(device: str) -> dict:
    """Where the vector rows ran: the card's name, count and power limit
    (``nvidia-smi``), or the host's CPU."""
    import torch
    if device == "cpu":
        return {"platform": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "name_power_limit": smi.stdout.strip().splitlines()[0]
            if smi.stdout.strip() else "unknown",
            "torch": torch.__version__, "cuda": torch.version.cuda}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--check", type=float, default=None, metavar="MIN_X",
                    help="exit non-zero unless the best vector row's warm "
                         "speedup over sim reaches MIN_X and the "
                         "equivalence gate passes")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default: the kernels on the card, plus the "
                         "vector_cpu row; fails without a card) or cpu "
                         "(the plain PyTorch versions on the host only)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench_vector: {e}", file=sys.stderr)
        return 2
    device = device_record(args.device)
    print(f"bench_vector: fig1 grid shape "
          f"({'smoke' if args.smoke else 'full'}), device {device}",
          file=sys.stderr)
    grid = grid_rows(args.smoke, args.device)
    print("bench_vector: equivalence gate ...", file=sys.stderr)
    equiv = equivalence_gate(args.smoke, args.device)

    vec_keys = [k for k in grid if k.startswith("vector_")]
    best = max((grid[k] for k in vec_keys),
               key=lambda r: r["speedup_vs_sim"])
    out = {
        "benchmark": "bench_vector_torch",
        "device": device,
        "grid_shape": {"qps_points": list(SMOKE_QPS if args.smoke
                                          else FULL_QPS),
                       "reps": 3 if args.smoke else 13,
                       "duration_s": 6.0 if args.smoke else 15.0},
        "grid": grid,
        "equivalence": equiv,
        "acceptance": {
            "best_vector_row": best["device"],
            "speedup_vs_serial_event_engine": best["speedup_vs_sim"],
            "meets_20x": bool(best["speedup_vs_sim"] >= 20.0),
            "cpu_speedup_vs_sim": grid["vector_cpu"]["speedup_vs_sim"],
            "error_rows": sum(v.get("errors", 0) for v in grid.values()
                              if isinstance(v, dict)),
            "equivalence_all_passed": equiv["all_passed"],
            "note": ("speedups are warm-path (the cold row includes the "
                     "kernels' build and load); the equivalence gate is "
                     "CI-overlap OR Welch-retained per scenario x metric "
                     "vs the exact event engine"),
        },
    }
    if "vector_cuda" in grid:
        out["acceptance"]["cuda_warm_points_per_sec"] = \
            grid["vector_cuda"]["points_per_sec"]
    write_record("vector", out, args.smoke)
    print(json.dumps(out["acceptance"], indent=1))

    if args.check is not None:
        ok = True
        if out["acceptance"]["error_rows"]:
            print(f"CHECK FAILED: {out['acceptance']['error_rows']} error "
                  f"rows", file=sys.stderr)
            ok = False
        if best["speedup_vs_sim"] < args.check:
            print(f"CHECK FAILED: vector speedup "
                  f"{best['speedup_vs_sim']:.2f}x < required {args.check}x",
                  file=sys.stderr)
            ok = False
        if not equiv["all_passed"]:
            print("CHECK FAILED: equivalence gate", file=sys.stderr)
            ok = False
        if not ok:
            return 1
        print(f"check passed: speedup={best['speedup_vs_sim']:.2f}x >= "
              f"{args.check}x, equivalence gate green "
              f"({len(equiv['rows'])} scenario-metric pairs)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
