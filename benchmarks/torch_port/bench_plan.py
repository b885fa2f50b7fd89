"""Planner benchmark of the port: gradient-based capacity planning vs the
dense provisioning grid it replaces, on the card.

Twin of ``benchmarks/bench_plan.py`` on the PyTorch/CUDA port.  One
provisioning question — the smallest steady/jsq fleet whose exact p99
meets the SLO — answered two ways on the SAME exact vector runtime and
the SAME SeedSequence spawn tree:

1. **Dense grid**: every integer fleet in the box at full repetition
   count, as ONE ``run_cells`` call (24 x 13 = 312 cells at full size),
   with one ``scalar_scan`` and one ``fused_quantiles`` launch per shape
   bucket on the card (20 at full size).
2. **Gradient planner** (``repro_torch.plan``): Adam through the
   smoothed surrogate (``torch.autograd``, on the card), then the
   integer probe ladder re-verified on the exact runtime.
   ``PlanResult.cell_evals`` counts every exact cell it consumed.

The record (``BENCH_plan_torch.json``; ``--smoke`` writes the
gitignored ``BENCH_plan_torch.smoke.json``) carries the reference's
gates: the planner's answer inside the grid optimum's 95% CI at >= 10x
fewer cell evaluations (full size), the f64 finite-difference gradient
checks, a descending loss history, and the continuous optimum within
tolerance of the hard-twin bisection oracle (``analytic_capacity``).
Beside them: the surrogate's ms per optimizer step (value and gradient,
host clock to a synchronised result), a ``torch.profiler`` count of one
such step (ATen ops, device kernels and their summed time, host-to-device
copies, stream syncs), the walls, the kernel launches and where it ran
(the card's name and power limit, ``nvidia-smi``).
Without a card the default run exits 2; ``--device cpu`` runs the plain
PyTorch versions on the host.

Usage (from the repository root):
    python benchmarks/torch_port/bench_plan.py              # full, card
    python benchmarks/torch_port/bench_plan.py --smoke --check
    python benchmarks/torch_port/bench_plan.py --smoke --device cpu

``benchmarks/torch_port/run.py`` runs it at full size, as its last line
``bench_plan,<planner wall in us>,<cells, cell speedup, n*>``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(REPO, "src"))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_port._record import write_record  # noqa: E402
from benchmarks.torch_port.bench_vector import device_record  # noqa: E402
from repro_torch.plan import (PlanConfig, PlanSpec,  # noqa: E402
                              analytic_capacity, build_plan_data, plan_loss,
                              run_plan)
from repro_torch.plan.model import device_draws  # noqa: E402
from repro_torch.plan.planner import mean_ci95  # noqa: E402
from repro_torch.scenarios import get  # noqa: E402
from repro_torch.sweep.spec import spawn_seed  # noqa: E402
from repro_torch.vector import (VectorConfig, compile_experiment,  # noqa: E402
                                run_cells)

#: the provisioning question, at full and CI scale
FULL = {"qps": 2600.0, "duration": 12.0, "n_clients": 8, "policy": "jsq",
        "slo": 0.02, "n_grid": 24, "reps": 13,
        "steps": 150, "starts": 3, "samples": 16384, "probe_reps": 5}
SMOKE = {"qps": 2600.0, "duration": 5.0, "n_clients": 8, "policy": "jsq",
         "slo": 0.02, "n_grid": 8, "reps": 3,
         "steps": 50, "starts": 1, "samples": 2048, "probe_reps": 2}

SEED = 0
#: continuous-optimum tolerance vs the bisection oracle (servers)
ANALYTIC_TOL = 0.75
ANALYTIC_REL = 0.25
#: full-run headline requirement: grid cells / planner cells
MIN_CELL_SPEEDUP = 10.0
#: optimizer steps timed for the surrogate's ms per step (after warm-up)
TIMED_STEPS = 20


def _overrides(p: dict) -> dict:
    return {"qps": p["qps"], "duration": p["duration"],
            "n_clients": p["n_clients"], "policy": p["policy"]}


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _launch_counters() -> tuple:
    from repro_torch.kernels import vector_quantiles, vector_step
    return (vector_step.scalar_scan, vector_quantiles.fused_quantiles)


def _launches() -> dict:
    return {k.__name__: k.launches for k in _launch_counters()}


def _zero_launches() -> None:
    for k in _launch_counters():
        k.launches = 0


def dense_grid(p: dict, device: str) -> dict:
    """Answer the question the sweep way: every fleet size, full reps,
    one batched exact run."""
    progs, seeds, labels = [], [], []
    for n in range(1, p["n_grid"] + 1):
        sc = get("steady", seed=SEED, slo=p["slo"], n_servers=n,
                 **_overrides(p))
        prog = compile_experiment(sc.compile())
        for rep in range(p["reps"]):
            progs.append(prog)
            seeds.append((spawn_seed(SEED, n, rep), rep))
            labels.append(n)
    _zero_launches()
    _sync(device)
    t0 = time.perf_counter()
    results = run_cells(progs, seeds, VectorConfig(device=device))
    wall = time.perf_counter() - t0
    launches = _launches()
    rows = []
    for n in range(1, p["n_grid"] + 1):
        vals = [r.p99 for r, k in zip(results, labels) if k == n]
        mean, ci = mean_ci95(vals)
        rows.append({"n": n, "p99_mean": mean, "p99_ci95": ci,
                     "meets": bool(mean <= p["slo"])})
    feasible = [r for r in rows if r["meets"]]
    opt = feasible[0] if feasible else None
    return {"cells": len(progs), "wall_s": wall, "launches": launches,
            "n_opt": None if opt is None else opt["n"],
            "p99_mean": None if opt is None else opt["p99_mean"],
            "p99_ci95": None if opt is None else opt["p99_ci95"],
            "rows": rows}


def fd_checks(p: dict, device: str) -> dict:
    """End-to-end d(plan_loss)/d(capacity) vs central differences, in
    float64 on ``device`` — the reference bench's gate."""
    data = build_plan_data("steady", slo=p["slo"], objective="p99",
                           overrides=_overrides(p),
                           samples=min(p["samples"], 4096), seed=SEED)
    cfg = PlanConfig()

    def loss(x: float, grad: bool = False):
        c = torch.tensor(x, dtype=torch.float64, device=device,
                         requires_grad=grad)
        val = plan_loss({"capacity": c}, data, cfg)[0]
        if grad:
            return float(torch.autograd.grad(val, [c])[0])
        return float(val)

    rows = []
    eps = 1e-4
    for x0 in (2.5, 4.0, 6.0):
        g = loss(x0, grad=True)
        fd = (loss(x0 + eps) - loss(x0 - eps)) / (2 * eps)
        ok = abs(g - fd) <= 2e-2 * max(abs(fd), abs(g)) + 1e-8
        rows.append({"x": x0, "grad": g, "fd": fd, "ok": ok})
    return {"rows": rows, "passed": all(r["ok"] for r in rows)}


def _surrogate_step(p: dict, device: str):
    """One optimizer step's value and gradient of ``plan_loss`` as
    ``run_plan`` takes it (f32, the problem's draw batch on ``device``
    once, capacity 4), returning the loss read back to the host."""
    data = build_plan_data("steady", slo=p["slo"], objective="p99",
                           overrides=_overrides(p), samples=p["samples"],
                           seed=SEED)
    cfg = PlanConfig()
    draws = device_draws(data, torch.float32, device)
    cap = torch.tensor(4.0, dtype=torch.float32, device=device)

    def step() -> float:
        c = cap.detach().requires_grad_(True)
        val = plan_loss({"capacity": c}, data, cfg, draws)[0]
        torch.autograd.grad(val, [c])
        return float(val.detach())  # the planner reads the loss each step
    return step


def surrogate_step_ms(p: dict, device: str) -> dict:
    """ms of one surrogate step (``_surrogate_step``), host clock around
    ``TIMED_STEPS`` synchronised steps after two warm-ups."""
    step = _surrogate_step(p, device)
    for _ in range(2):
        step()
    _sync(device)
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        step()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": float(np.median(times)),
            "min_ms": float(np.min(times)), "steps": TIMED_STEPS}


def surrogate_profile(p: dict, device: str) -> dict:
    """``torch.profiler`` of one surrogate step after two warm-ups: the
    ATen ops it dispatches (nested ones included), the device kernels
    and memcpys with their summed device time, the CUDA runtime's
    launch, copy and sync calls, and the step's host wall.  The device
    fields are 0 on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    step = _surrogate_step(p, device)
    for _ in range(2):
        step()
    _sync(device)
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {"wall_ms": wall_ms, "aten_ops": 0, "kernels": 0,
           "kernel_ms": 0.0, "memcpy_h2d": 0, "memcpy_d2h": 0,
           "runtime_launches": 0, "runtime_memcpys": 0, "runtime_syncs": 0}
    top = []
    for e in prof.key_averages():
        name, n = e.key, int(e.count)
        dev_us = float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0)))
        on_device = str(e.device_type).endswith("CUDA")
        if on_device:
            if "Memcpy HtoD" in name:
                out["memcpy_h2d"] += n
            elif "Memcpy DtoH" in name:
                out["memcpy_d2h"] += n
            else:
                out["kernels"] += n
            out["kernel_ms"] += dev_us / 1e3
        elif name.startswith("aten::"):
            out["aten_ops"] += n
            top.append((float(e.self_cpu_time_total), name, n))
        elif name in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            out["runtime_launches"] += n
        elif name.startswith("cudaMemcpy"):
            out["runtime_memcpys"] += n
        elif "Synchronize" in name:
            out["runtime_syncs"] += n
    top.sort(reverse=True)
    out["top_self_cpu"] = [{"op": name, "count": n, "self_cpu_ms": us / 1e3}
                           for us, name, n in top[:8]]
    return out


def run_planner(p: dict, device: str) -> tuple:
    spec = PlanSpec(scenario="steady", objective="p99", slo=p["slo"],
                    overrides=_overrides(p), steps=p["steps"],
                    starts=p["starts"], samples=p["samples"],
                    probe_reps=p["probe_reps"], reps=p["reps"], seed=SEED)
    _zero_launches()
    _sync(device)
    t0 = time.perf_counter()
    res = run_plan(spec, vector_config=VectorConfig(device=device))
    wall = time.perf_counter() - t0
    return res, wall, _launches()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI scale; writes the gitignored smoke record")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero if any gate fails")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; fails without a card) or cpu "
                         "(the plain PyTorch versions on the host)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench_plan: {e}", file=sys.stderr)
        return 2
    p = SMOKE if args.smoke else FULL
    device = device_record(args.device)
    print(f"bench_plan: {'smoke' if args.smoke else 'full'}, device "
          f"{device}", file=sys.stderr)

    fd = fd_checks(p, args.device)
    print(f"fd gradient checks: {'PASS' if fd['passed'] else 'FAIL'}")

    grid = dense_grid(p, args.device)
    print(f"dense grid: {grid['cells']} cells in {grid['wall_s']:.3f}s -> "
          f"n_opt={grid['n_opt']} p99={grid['p99_mean']}")

    step = surrogate_step_ms(p, args.device)
    print(f"surrogate: {step['median_ms']:.3f} ms a step (median of "
          f"{step['steps']})")
    prof = surrogate_profile(p, args.device)
    print(f"surrogate profile: {prof['aten_ops']} ATen ops, "
          f"{prof['kernels']} kernels ({prof['kernel_ms']:.3f} ms of "
          f"device), {prof['memcpy_h2d']} H2D copies, "
          f"{prof['runtime_syncs']} syncs, {prof['wall_ms']:.3f} ms wall")

    res, plan_wall, plan_launches = run_planner(p, args.device)
    hist = res.starts[res.best_start]["history"]
    head = max(1, min(5, len(hist) // 4))
    loss_descends = bool(hist[-1] <= hist[0] and
                         np.mean(hist[-head:]) <= np.mean(hist[:head]))

    data = build_plan_data("steady", slo=p["slo"], objective="p99",
                           overrides=_overrides(p), samples=p["samples"],
                           seed=SEED)
    x_a = analytic_capacity(data)
    x = res.params["capacity"]
    analytic_ok = bool(abs(x - x_a) <= max(ANALYTIC_TOL,
                                           ANALYTIC_REL * x_a))

    v = res.verified or {}
    ci_overlap = None
    if grid["n_opt"] is not None and v:
        gap = abs(v["mean"] - grid["p99_mean"])
        allow = grid["p99_ci95"] + (0.0 if np.isnan(v["ci95"])
                                    else v["ci95"])
        ci_overlap = bool(gap <= allow)
    speedup = grid["cells"] / max(res.cell_evals, 1)
    same_fleet = bool(grid["n_opt"] == res.n_star)

    gates = {"fd_checks": fd["passed"],
             "loss_descends": loss_descends,
             "analytic_tolerance": analytic_ok,
             "ci_overlap_vs_grid": ci_overlap,
             "exact_verified_feasible": bool(res.feasible)}
    if not args.smoke:
        gates["cell_speedup_10x"] = bool(speedup >= MIN_CELL_SPEEDUP)

    payload = {
        "benchmark": "bench_plan_torch",
        "scale": "smoke" if args.smoke else "full",
        "device": device,
        "problem": {**p, "seed": SEED, "objective": "p99",
                    "scenario": "steady"},
        "fd": fd,
        "grid": grid,
        "surrogate_step": step,
        "surrogate_profile": prof,
        "planner": {
            "continuous_capacity": x,
            "analytic_capacity": round(x_a, 4),
            "best_start": res.best_start,
            "loss_first": hist[0], "loss_last": hist[-1],
            "n_star": res.n_star,
            "verified": v,
            "probes": res.probes,
            "cell_evals": res.cell_evals,
            "wall_s": plan_wall,
            "launches": plan_launches,
        },
        "headline": {
            "grid_cells": grid["cells"],
            "planner_cells": res.cell_evals,
            "cell_speedup": round(speedup, 2),
            "wall_speedup": grid["wall_s"] / max(plan_wall, 1e-9),
            "same_fleet_as_grid": same_fleet,
        },
        "gates": gates,
    }
    write_record("plan", payload, smoke=args.smoke)
    print(f"planner: {res.cell_evals} cells in {plan_wall:.3f}s -> "
          f"n_star={res.n_star} (grid n_opt={grid['n_opt']}); "
          f"cell speedup {round(speedup, 1)}x")
    for k, ok in gates.items():
        print(f"gate {k}: {'PASS' if ok else 'FAIL' if ok is False else 'n/a'}")
    print(f"bench_plan,{plan_wall * 1e6:.0f},cells={res.cell_evals};"
          f"cell_speedup={speedup:.2f}x;n_star={res.n_star}")
    if args.check:
        return 0 if all(v is not False for v in gates.values()) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
