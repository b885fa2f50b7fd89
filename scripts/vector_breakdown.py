"""Where the time of the port's vector runtime goes, grid by grid.

    python3 scripts/vector_breakdown.py [--device cuda|cpu] [--reps N]
        [--grids all|main|chaos]

Runs the four main-path grids and the three chaos grids of
``chip_smoke.py`` (``--grids`` picks either set) through
``repro_torch.vector.run_cells`` (after one warm-up run each) and
reports, per grid:

* the wall time and cells/s (median of ``--reps`` runs);
* the host phases of one run, from ``cProfile`` (cumulative seconds of
  the runtime's own functions: draws, input assembly, scan launch,
  analytic terms, waiting for the device, sampling, quantiles,
  extraction);
* on the card, the device time of one run by kernel from
  ``torch.profiler``, and the device's busy share of the wall time;
* the quantile head's host seconds in one run (``_grid_quantiles``,
  matrix assembly, host->device copy, kernel and device->host copy,
  timed around each call with profiling off) and its share of that
  run's wall, and one replay of those four steps on the run's first
  chunk, each ended by a synchronize.

The record goes to ``chiprun_out/vector_breakdown.json``.  cProfile adds
a cost per Python call, so the phase times are shares, not absolutes:
the wall times are taken with profiling off.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

#: (file, function) of the runtime whose cumulative time is a phase
PHASES = {
    ("vector/runtime.py", "_draw_cell"): "draws",
    ("vector/runtime.py", "scan_inputs"): "scan_inputs",
    ("kernels/ops.py", "scalar_scan"): "scan",
    ("kernels/ops.py", "batched_scan"): "scan",
    ("vector/runtime.py", "_launch_family"): "launch_total",
    ("vector/runtime.py", "_fetch"): "fetch",
    ("vector/runtime.py", "_sample_cell"): "sampling",
    ("vector/runtime.py", "_grid_quantiles"): "quantiles",
    ("vector/runtime.py", "_finish_cell"): "rows",
}
LABELS = {
    "draws": "draws (NumPy Poisson/normal per cell)",
    "scan_inputs": "scan inputs: pad, stack, host->device",
    "scan": "scan (kernel launch; plain loop on the CPU)",
    "analytic": "analytic terms (Erlang-C, episode age, pooled law)",
    "fetch": "wait for the scan + device->host copy",
    "sampling": "request sampling and censoring",
    "quantiles": "quantile head (incl. copies)",
    "rows": "interval series and rows",
}


def host_phases(fn) -> dict:
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    out = dict.fromkeys(LABELS, 0.0)
    out["launch_total"] = 0.0
    for (path, _line, func), row in pstats.Stats(prof).stats.items():
        for (suffix, name), phase in PHASES.items():
            if func == name and path.endswith(suffix) \
                    and "repro_torch" in path:
                out[phase] += row[3]             # cumulative seconds
    out["analytic"] = out.pop("launch_total") - out["draws"] \
        - out["scan_inputs"] - out["scan"]
    return out


def device_time(fn) -> dict:
    """Device microseconds by kernel or copy name for one call, from
    torch.profiler (empty if the trace holds no device events).  Only
    events that ran on the device count: a host op such as
    ``aten::copy_`` also reports the device time of the copy it issued,
    and counting both would count that time twice."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us
    return out


def quantile_head(run) -> dict:
    """The quantile head of one ``run()``: its seconds and share of the
    wall, and a replay of its steps on the first chunk's latencies."""
    from repro_torch.kernels import ops
    from repro_torch.vector import runtime as R
    real, calls, first = R._grid_quantiles, [], []

    def timed(lats, device):
        if not first:
            first.append((lats, device))
        t0 = time.perf_counter()
        out = real(lats, device)
        calls.append(time.perf_counter() - t0)
        return out
    R._grid_quantiles = timed
    try:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    finally:
        R._grid_quantiles = real
    lats, device = first[0]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()
    steps, clock = {}, time.perf_counter
    t0 = clock()
    mat, counts = R._quantile_matrix(lats)
    steps["assembly_s"] = clock() - t0
    t0 = clock()
    L = torch.from_numpy(mat).to(device)
    N = torch.from_numpy(counts).to(device)
    sync()
    steps["h2d_s"] = clock() - t0
    t0 = clock()
    out = ops.fused_quantiles(L, N)
    sync()
    steps["kernel_s"] = clock() - t0
    t0 = clock()
    out.cpu()
    steps["d2h_s"] = clock() - t0
    return {"calls": len(calls), "head_s": sum(calls), "wall_s": wall,
            "share": sum(calls) / wall, "shape": list(mat.shape),
            "first_chunk_steps": steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--grids", default="all",
                    choices=["all", "main", "chaos"])
    args = ap.parse_args(argv)

    from chip_smoke import build_chaos_grids, build_grids
    from repro_torch.device import resolve_device
    from repro_torch.vector import VectorConfig, run_cells

    device = resolve_device(args.device)
    cfg = VectorConfig(device=args.device)
    record = {"device": (torch.cuda.get_device_name(0)
                         if device.type == "cuda" else "cpu"),
              "grids": {}}
    grids = ((build_grids() if args.grids != "chaos" else [])
             + (build_chaos_grids() if args.grids != "main" else []))
    for name, progs, seeds in grids:
        def run():
            run_cells(progs, seeds, cfg)
        run()                                    # warm-up (build, load)
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        rec = {"cells": len(progs), "wall_s": wall, "walls_s": walls,
               "cells_per_s": len(progs) / wall,
               "host_phases_s": host_phases(run),
               "quantile_head": quantile_head(run)}
        if device.type == "cuda":
            dev = device_time(run)
            busy = sum(dev.values()) / 1e6
            rec.update(device_s_by_kernel={k: v / 1e6
                                           for k, v in dev.items()},
                       device_s=busy,
                       device_busy_share=busy / wall if dev else None)
        record["grids"][name] = rec
        print(f"{name}: {len(progs)} cells, wall {wall:.4f} s "
              f"({len(progs) / wall:.1f} cells/s), device busy "
              f"{rec.get('device_busy_share')}", flush=True)
        for func, s in sorted(rec["host_phases_s"].items(),
                              key=lambda kv: -kv[1]):
            print(f"  {s:8.4f} s  {LABELS[func]}")
        head = rec["quantile_head"]
        print(f"  quantile head: {head['head_s']:.6f} s of a "
              f"{head['wall_s']:.4f} s wall ({100 * head['share']:.3f} %), "
              f"{head['calls']} "
              f"launch(es); first chunk {head['shape']}: "
              + ", ".join(f"{k[:-2]} {v * 1e3:.3f} ms"
                          for k, v in head["first_chunk_steps"].items()))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "vector_breakdown.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
