"""Result-cache benchmark of the port: warm re-run speedup, bit-identity,
planner cell reuse and the pipelined chunk path, on the card.

Twin of ``benchmarks/bench_cache.py`` on the PyTorch/CUDA port.  Three
measurements, one record (``BENCH_cache_torch.json``; ``--smoke`` writes
the gitignored ``BENCH_cache_torch.smoke.json``):

1. **Warm fig1-grid re-run** — the paper's Fig. 1 sweep shape (the grid
   ``bench_vector`` times, 117 cells at full size) run three ways through
   ``repro_torch.sweep.run_sweep``: uncached, cold through a fresh cache
   directory (compute + store overhead), and warm (every row served from
   disk by a new ``ResultCache`` on the same directory).  The headline
   gate is the warm speedup over the cold run, with every row required
   bit-identical across all three; beside it, each run's kernel launches
   (the warm run must launch none) and the bytes the cold run stored.

2. **Planner cell reuse** — ``bench_plan``'s dense provisioning grid
   populates a cache through ``run_cells``; ``run_plan`` on the same
   question with that cache must then spend almost nothing:
   ``cell_evals`` counts only cells the cache could not serve (gate:
   <= 5).  Both sides share one SeedSequence spawn tree and one device,
   so key sharing is by construction, not coincidence.

3. **Pipelined chunk execution** — the fig1 grid through ``run_cells``
   with chunks double-buffered (the scan of chunk k+1 launched before
   the host finishes chunk k) against the strictly serial order, forced
   into 4 chunks through ``max_slot_elems``, timed in turns (serial,
   pipelined, pipelined, serial, serial, pipelined; the lowest wall of
   each order).  Gate: pipelining costs at most 1.10x the serial order
   and the rows are identical.  The timing gate reads "n/a" with
   ``--device cpu``: there the two orders run the same synchronous
   steps, with nothing on a device to overlap, and the ratio is host
   noise (both walls are still recorded).

The gates are the reference's thresholds.  Every number is this run's,
on ``--device``: the card by default (the record names it and its power
limit, ``nvidia-smi``), the CPU's plain PyTorch versions with ``--device
cpu``.  Without a card the default run exits 2.  No number is taken from
the reference's record (``BENCH_cache.json``).

Usage (from the repository root):
    python benchmarks/torch_port/bench_cache.py             # full, card
    python benchmarks/torch_port/bench_cache.py --smoke --check
    python benchmarks/torch_port/bench_cache.py --smoke --check --device cpu

``benchmarks/torch_port/run.py`` runs it at full size, as its line
``bench_cache,<warm wall in us>,<warm speedup, hit fraction, planner
cells>``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(REPO, "src"))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from benchmarks.torch_port._record import write_record  # noqa: E402
from benchmarks.torch_port.bench_vector import (build_grid,  # noqa: E402
                                                device_record,
                                                grid_programs)
from repro_torch.cache import ResultCache, scan  # noqa: E402
from repro_torch.plan import PlanSpec, run_plan  # noqa: E402
from repro_torch.scenarios import get  # noqa: E402
from repro_torch.sweep import run_sweep  # noqa: E402
from repro_torch.sweep.spec import spawn_seed  # noqa: E402
from repro_torch.vector import (VectorConfig, compile_experiment,  # noqa: E402
                                run_cells)

#: warm-over-cold floor: full scale pays real compute cold; smoke
#: grids are small enough that fixed costs compress the ratio
MIN_WARM_SPEEDUP = {"full": 10.0, "smoke": 3.0}
MIN_HIT_FRAC = 0.9
MAX_PLANNER_CELLS = 5
#: pipelining must never cost more than this over strict sync
MAX_PIPELINE_RATIO = 1.10

#: bench_plan's provisioning question, shared seed tree and all
PLAN_FULL = {"qps": 2600.0, "duration": 12.0, "n_clients": 8,
             "policy": "jsq", "slo": 0.02, "n_grid": 24, "reps": 13,
             "steps": 150, "starts": 3, "samples": 16384, "probe_reps": 5}
PLAN_SMOKE = {"qps": 2600.0, "duration": 5.0, "n_clients": 8,
              "policy": "jsq", "slo": 0.02, "n_grid": 8, "reps": 3,
              "steps": 50, "starts": 1, "samples": 2048, "probe_reps": 2}
SEED = 0
#: chunks the pipeline section forces the fig1 grid into, and the order
#: of its timed runs (False = serial, True = pipelined; the lowest wall
#: of each order is kept)
PIPELINE_CHUNKS = 4
PIPELINE_ORDER = (False, True, True, False, False, True)


def _row_bits(frame) -> list:
    """The frame's rows as an exact comparable (declaration order)."""
    return [(r.index, r.rep, r.params, r.seed, r.stream,
             {k: repr(v) for k, v in r.metrics.items()})
            for r in frame.rows]


def _cell_bits(results) -> list:
    return [(r.n, repr(r.mean), repr(r.p50), repr(r.p95), repr(r.p99),
             r.dropped, r.samples.tobytes(), r.sample_ivl.tobytes())
            for r in results]


def _kernels() -> tuple:
    from repro_torch.kernels import vector_quantiles, vector_step
    return (vector_step.scalar_scan, vector_step.batched_scan,
            vector_quantiles.fused_quantiles)


def _timed(device: str, fn):
    """-> (fn's result, host wall seconds, vector-kernel launches)."""
    for k in _kernels():
        k.launches = 0
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k.__name__: k.launches for k in _kernels()}


# ---------------------------------------------------------------------------
# 1. Warm fig1-grid re-run
# ---------------------------------------------------------------------------
def sweep_section(smoke: bool, cache_root: str, device: str) -> dict:
    sweep = build_grid(smoke, "vector")
    cfg = VectorConfig(device=device)
    n_tasks = len(sweep.tasks())
    cache_dir = os.path.join(cache_root, "sweep")

    def run(cache=None):
        return run_sweep(sweep, vector_config=cfg, progress=None,
                         cache=cache)

    print(f"  fig1 grid ({n_tasks} cells), uncached ...", file=sys.stderr,
          flush=True)
    run()                           # pays the kernels' build and load once
    plain, uncached_wall, uncached_n = _timed(device, run)

    print("  cold through a fresh cache ...", file=sys.stderr, flush=True)
    cold_cache = ResultCache(cache_dir=cache_dir)
    cold, cold_wall, cold_n = _timed(device, lambda: run(cold_cache))
    stored = scan(cache_dir)["salts"][cold_cache.salt]

    print("  warm re-run ...", file=sys.stderr, flush=True)
    warm_cache = ResultCache(cache_dir=cache_dir)
    warm, warm_wall, warm_n = _timed(device, lambda: run(warm_cache))

    hit_frac = warm_cache.stats.hits / max(n_tasks, 1)
    identical = (_row_bits(plain) == _row_bits(cold) == _row_bits(warm))
    speedup = cold_wall / max(warm_wall, 1e-9)
    print(f"    uncached {uncached_wall:.3f}s cold {cold_wall:.3f}s "
          f"warm {warm_wall:.4f}s -> {speedup:.1f}x, "
          f"hits {warm_cache.stats.hits}/{n_tasks}", file=sys.stderr)
    return {
        "tasks": n_tasks,
        "uncached_wall_s": uncached_wall,
        "cold_wall_s": cold_wall,
        "warm_wall_s": warm_wall,
        "store_overhead_frac": cold_wall / max(uncached_wall, 1e-9) - 1.0,
        "warm_speedup_vs_cold": speedup,
        "warm_hits": warm_cache.stats.hits,
        "warm_misses": warm_cache.stats.misses,
        "hit_frac": hit_frac,
        "cold_stats": cold_cache.stats.as_dict(),
        "stored_rows": stored["rows"],
        "stored_cells": stored["cells"],
        "stored_bytes": stored["bytes"],
        "launches": {"uncached": uncached_n, "cold": cold_n,
                     "warm": warm_n},
        "rows_bit_identical": bool(identical),
        "errors": len(plain.errors) + len(cold.errors) + len(warm.errors),
    }


# ---------------------------------------------------------------------------
# 2. Planner cell reuse after a dense sweep
# ---------------------------------------------------------------------------
def planner_section(smoke: bool, cache_root: str, device: str) -> dict:
    p = PLAN_SMOKE if smoke else PLAN_FULL
    overrides = {"qps": p["qps"], "duration": p["duration"],
                 "n_clients": p["n_clients"], "policy": p["policy"]}
    cache_dir = os.path.join(cache_root, "plan")
    cfg = VectorConfig(device=device)

    progs, seeds = [], []
    for n in range(1, p["n_grid"] + 1):
        sc = get("steady", seed=SEED, slo=p["slo"], n_servers=n,
                 **overrides)
        prog = compile_experiment(sc.compile())
        for rep in range(p["reps"]):
            progs.append(prog)
            seeds.append((spawn_seed(SEED, n, rep), rep))
    print(f"  dense grid ({len(progs)} cells) into the cache ...",
          file=sys.stderr, flush=True)
    grid_cache = ResultCache(cache_dir=cache_dir)
    _, grid_wall, grid_n = _timed(
        device, lambda: run_cells(progs, seeds, cfg, cache=grid_cache))

    spec = PlanSpec(scenario="steady", objective="p99", slo=p["slo"],
                    overrides=overrides, steps=p["steps"],
                    starts=p["starts"], samples=p["samples"],
                    probe_reps=p["probe_reps"], reps=p["reps"], seed=SEED)
    print("  planner with the shared cache ...", file=sys.stderr,
          flush=True)
    plan_cache = ResultCache(cache_dir=cache_dir)
    res, plan_wall, plan_n = _timed(
        device, lambda: run_plan(spec, vector_config=cfg, cache=plan_cache))
    print(f"    n_star={res.n_star} cell_evals={res.cell_evals} "
          f"(cache hits {plan_cache.stats.hits})", file=sys.stderr)
    return {
        "grid_cells": len(progs),
        "grid_wall_s": grid_wall,
        "grid_launches": grid_n,
        "plan_wall_s": plan_wall,
        "plan_launches": plan_n,
        "n_star": res.n_star,
        "feasible": bool(res.feasible),
        "probes": [(q["n"], q["meets"]) for q in res.probes],
        "cell_evals_with_cache": res.cell_evals,
        "cache_hits": plan_cache.stats.hits,
        "cache_misses": plan_cache.stats.misses,
    }


# ---------------------------------------------------------------------------
# 3. Pipelined vs serial chunk execution
# ---------------------------------------------------------------------------
def pipeline_section(smoke: bool, device: str) -> dict:
    from repro_torch.vector.runtime import _plan_groups
    progs, seeds = grid_programs(build_grid(smoke, "vector"))
    # force the grid into PIPELINE_CHUNKS chunks so there is something to
    # overlap: max_slot_elems counts the padded (T, S) of its bucket
    (_, (T, S), idxs), = _plan_groups(progs)
    per_chunk = -(-len(idxs) // PIPELINE_CHUNKS)
    elems = T * S * per_chunk
    chunks = -(-len(idxs) // per_chunk)

    def run(pipeline: bool):
        return run_cells(progs, seeds, VectorConfig(
            device=device, max_slot_elems=elems, pipeline=pipeline))

    print(f"  pipeline: {len(progs)} cells in {chunks} chunks ...",
          file=sys.stderr, flush=True)
    run(True)                                  # warm-up
    walls = {False: [], True: []}
    out = {}
    for pipeline in PIPELINE_ORDER:
        out[pipeline], wall, launches = _timed(device,
                                               lambda: run(pipeline))
        walls[pipeline].append(wall)
    sync_wall, piped_wall = min(walls[False]), min(walls[True])
    ratio = piped_wall / max(sync_wall, 1e-9)
    print(f"    sync {sync_wall:.3f}s pipelined {piped_wall:.3f}s "
          f"(ratio {ratio:.3f})", file=sys.stderr)
    return {
        "cells": len(progs),
        "chunks": chunks,
        "max_slot_elems": elems,
        "sync_walls_s": walls[False],
        "pipelined_walls_s": walls[True],
        "sync_wall_s": sync_wall,
        "pipelined_wall_s": piped_wall,
        "pipelined_over_sync": ratio,
        "launches_per_run": launches,
        "bit_identical": bool(_cell_bits(out[False]) ==
                              _cell_bits(out[True])),
    }


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
        print(f"bench_cache: {e}", file=sys.stderr)
        return 2
    scale = "smoke" if args.smoke else "full"
    device = device_record(args.device)
    print(f"bench_cache ({scale}), device {device}", file=sys.stderr)

    cache_root = tempfile.mkdtemp(prefix="bench_cache_torch.")
    try:
        sweep = sweep_section(args.smoke, cache_root, args.device)
        planner = planner_section(args.smoke, cache_root, args.device)
        pipeline = pipeline_section(args.smoke, args.device)
    finally:
        shutil.rmtree(cache_root, ignore_errors=True)

    gates = {
        "warm_speedup": bool(sweep["warm_speedup_vs_cold"]
                             >= MIN_WARM_SPEEDUP[scale]),
        "hit_frac": bool(sweep["hit_frac"] >= MIN_HIT_FRAC),
        "rows_bit_identical": sweep["rows_bit_identical"],
        "no_errors": sweep["errors"] == 0,
        "planner_cells": bool(planner["cell_evals_with_cache"]
                              <= MAX_PLANNER_CELLS),
        # the overlap is of the card's scan with host work: on the CPU
        # both orders run the same synchronous steps, and the ratio is
        # host noise, recorded but not gated
        "pipeline_not_slower": bool(pipeline["pipelined_over_sync"]
                                    <= MAX_PIPELINE_RATIO)
        if args.device == "cuda" else None,
        "pipeline_bit_identical": pipeline["bit_identical"],
    }
    payload = {
        "benchmark": "bench_cache_torch",
        "scale": scale,
        "device": device,
        "sweep": sweep,
        "planner": planner,
        "pipeline": pipeline,
        "thresholds": {"min_warm_speedup": MIN_WARM_SPEEDUP[scale],
                       "min_hit_frac": MIN_HIT_FRAC,
                       "max_planner_cells": MAX_PLANNER_CELLS,
                       "max_pipeline_ratio": MAX_PIPELINE_RATIO},
        "gates": gates,
    }
    write_record("cache", payload, smoke=args.smoke)
    print(json.dumps({"gates": gates,
                      "warm_speedup": sweep["warm_speedup_vs_cold"],
                      "hit_frac": sweep["hit_frac"]}, indent=1))
    print(f"bench_cache,{sweep['warm_wall_s'] * 1e6:.0f},"
          f"warm_speedup={sweep['warm_speedup_vs_cold']:.2f}x;"
          f"hit_frac={sweep['hit_frac']:.4f};"
          f"planner_cells={planner['cell_evals_with_cache']}")
    for k, ok in gates.items():
        print(f"gate {k}: "
              f"{'PASS' if ok else 'FAIL' if ok is False else 'n/a'}")
    if args.check:
        return 0 if all(v is not False for v in gates.values()) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
