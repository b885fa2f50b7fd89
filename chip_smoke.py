"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the vector grid runtime, on the card:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. holds every kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it: every output bit-equal;
4. runs four grids end to end through ``repro_torch.vector.run_cells``
   (the paper's Fig. 1 grid, a 16-server jsq grid, server-failure and
   batched-serving), checks that every kernel was launched and every row
   is finite, and holds three cells of each grid against the same cells
   run on the CPU;
5. times each kernel, its plain version and, for the quantile head, the
   library sort, with CUDA events (median of repeated runs);
6. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
   ...}`` line.

Any failed phase exits non-zero.  Without a CUDA device, or without the
rest of the repository beside it, the script fails before printing any
result.  The full record is also written to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: H100 SXM published peaks (NVIDIA data sheet, 700 W): device memory
#: rate and f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: repeats of each timed call (the median is reported)
TIMED_RUNS = 10
#: grid rows on the card vs the same cells on the CPU (the tolerances of
#: tests/test_torch_vector_parity.py against the JAX reference)
ROW_RTOL = 1e-6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def spawn_seed(base_seed: int, point: int, rep: int) -> int:
    """Per-(point, rep) seed, as ``repro.sweep.spec.spawn_seed`` derives
    it (SeedSequence spawn tree)."""
    ss = np.random.SeedSequence(base_seed, spawn_key=(point, rep))
    return int(ss.generate_state(1, np.uint32)[0])


def build_grids() -> list:
    """(name, programs, seeds) of the four main-path grids."""
    from repro_torch.core.client import ClientConfig, ConstantQPS
    from repro_torch.core.harness import Experiment, ServerSpec
    from repro_torch.scenarios import get
    from repro_torch.vector import compile_experiment

    grids = []
    # the paper's Fig. 1 grid (benchmarks/bench_vector.py): 9 QPS points x
    # 13 reps, 15 s, three clients on one 6-worker xapian server
    progs, seeds = [], []
    for i, qps in enumerate((100, 250, 500, 1000, 2000, 3000, 4000, 4600,
                             5200)):
        for rep in range(13):
            exp = Experiment(
                clients=[ClientConfig(k, ConstantQPS(qps / 3))
                         for k in range(3)],
                servers=(ServerSpec(0, workers=6),), duration=15.0,
                app="xapian", seed=spawn_seed(1, i, rep))
            progs.append(compile_experiment(exp))
            seeds.append((exp.seed, rep))
    grids.append(("fig1", progs, seeds))

    def scenario_grid(name, points, **kw):
        progs, seeds = [], []
        for i, over in enumerate(points):
            for rep in range(13):
                sc = get(name, seed=spawn_seed(1, i, rep), **kw, **over)
                progs.append(compile_experiment(sc.compile()))
                seeds.append((sc.seed, rep))
        return name, progs, seeds

    # multi-server: 16 one-worker servers behind jsq (the water-fill over
    # servers), offered load up to ~0.94 of capacity
    grids.append(scenario_grid(
        "steady", [dict(qps=q) for q in (3000.0, 6000.0, 9000.0, 11000.0)],
        n_servers=16, policy="jsq", duration=15.0))
    grids.append(scenario_grid("server-failure", [{}]))
    grids.append(scenario_grid(
        "batched-serving", [dict(qps=q) for q in (300.0, 600.0)],
        n_servers=8))
    return grids


def scan_case(progs, seeds, device):
    """The first chunk's scan inputs exactly as ``run_cells`` builds them."""
    from repro_torch.vector import runtime as R
    batched, shape, idxs = R._plan_groups(progs)[0]
    group = [progs[i] for i in idxs]
    draws = [R._draw_cell(p, R._cell_rng(*seeds[i]))
             for p, i in zip(group, idxs)]
    return batched, group[0].n_slots, R.scan_inputs(group, draws, batched,
                                                     shape, device)


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median device time of ``fn()`` over ``runs`` calls, CUDA events,
    after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def scan_bound(consts, carry, xs, new_carry, ys, per_lane_ops) -> tuple:
    """(bound ms, 'bytes' | 'operations') of one scan launch: each input
    read once and each output written once over the memory rate, against
    the f32 operations of the step over the f32 rate."""
    moved = nbytes(list(consts.values()) + list(carry) + list(xs)
                   + list(new_carry) + list(ys))
    T, C, S = xs[1].shape
    ops = T * C * S * per_lane_ops(S)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_scan(name, batched, n_real, inputs) -> dict:
    """Kernel vs plain version of one scan on the card; returns the
    record (errors, times, bound)."""
    from repro_torch.kernels import ref, vector_step
    consts, carry, xs = inputs
    kern = vector_step.batched_scan if batched else vector_step.scalar_scan
    plain = ref.batched_scan if batched else ref.scalar_scan
    kc, ky = kern(consts, carry, xs)
    pc, py = plain(consts, carry, xs)
    torch.cuda.synchronize()
    # the kernel runs the plain version's f32 operations in the same
    # order (lane sums left to right, no FMA): every output bit-equal
    worst = 0.0
    for k, p in zip(list(ky) + list(kc), list(py) + list(pc)):
        diff = torch.where(k == p, 0.0, (k - p).abs())   # equal infs: 0
        worst = max(worst, diff.max().item())
        if not torch.equal(k, p):
            fail(f"{name}: kernel differs from the plain version "
                 f"(max abs {worst:.3e})")
    if not all(torch.isfinite(y[:n_real]).all() for y in ky):
        fail(f"{name}: kernel output not finite over the cells' slots")
    # per-slot entry point: a one-slot launch is the plain step's slot
    k1 = kern(consts, carry, tuple(x[:1] for x in xs))
    p1 = plain(consts, carry, tuple(x[:1] for x in xs))
    for k, p in zip(list(k1[0]) + list(k1[1]), list(p1[0]) + list(p1[1])):
        if not torch.equal(k, p):
            fail(f"{name}: one-slot launch differs from the plain step")
    per_lane = ((lambda S: 3 * S + 45) if batched
                else (lambda S: 3 * S + 30))
    bound_ms, bound_by = scan_bound(consts, carry, xs, kc, ky, per_lane)
    T, C, S = xs[1].shape
    return {"shape": {"T": T, "C": C, "S": S, "real_slots": n_real},
            "max_abs_err": worst,
            "ms": cuda_ms(lambda: kern(consts, carry, xs)),
            "plain_ms": cuda_ms(lambda: plain(consts, carry, xs)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_quantiles(device) -> dict:
    """Kernel vs plain version of the quantile head at the Fig. 1 grid's
    width (117 cells x 32768 samples), bit-equal; ragged counts, a
    count of 0, a count of 1 and ties included."""
    from repro_torch.kernels import ref, vector_quantiles
    C, K = 117, 32768
    g = np.random.default_rng(11)
    counts = np.concatenate([[0, 1, 2, K, K],
                             g.integers(1, K, C - 5)]).astype(np.int32)
    lat = np.full((C, K), np.inf, np.float32)
    for i, n in enumerate(counts):
        lat[i, :n] = g.gamma(2.0, 0.004, n)
    lat[4, :K // 2] = 0.0125                   # ties across the median
    L = torch.from_numpy(lat).to(device)
    N = torch.from_numpy(counts).to(device)
    k = vector_quantiles.fused_quantiles(L, N).cpu().numpy()
    p = ref.fused_quantiles(L, N).cpu().numpy()
    if not np.array_equal(k, p, equal_nan=True):
        fail("fused_quantiles is not bit-equal to its plain version")
    err = float(np.abs(k - p)[~np.isnan(p)].max())
    if not np.isnan(k[0]).all() or np.isnan(k[1:]).any():
        fail("fused_quantiles: NaN rows do not match the zero counts")
    idx = torch.stack([torch.clamp((float(q / 100.0) * (N - 1)).floor(), 0)
                       for q in (50.0, 95.0, 99.0)], -1).long()

    def library():
        torch.sort(L, dim=-1).values.gather(-1, idx)

    moved = L.numel() * 4 + N.numel() * 4 + C * 3 * 4
    # an exact selection compares each element with each of the 6 ranks
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, C * K * 6 / F32_OPS_PER_S
    return {"shape": {"C": C, "K": K}, "max_abs_err": err,
            "ms": cuda_ms(lambda: vector_quantiles.fused_quantiles(L, N)),
            "plain_ms": cuda_ms(lambda: ref.fused_quantiles(L, N)),
            "library_ms": cuda_ms(library),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rows_close(gpu, cpu) -> str:
    """'' when a card row matches its CPU row within the test
    tolerances, else what differs."""
    if gpu.dropped != cpu.dropped:
        return f"dropped {gpu.dropped} != {cpu.dropped}"
    if abs(gpu.n - cpu.n) > 1:
        return f"n {gpu.n} vs {cpu.n}"
    for m in ("mean", "p50", "p95", "p99"):
        a, b = getattr(gpu, m), getattr(cpu, m)
        if not math.isclose(a, b, rel_tol=ROW_RTOL):
            return f"{m} {a!r} vs {b!r}"
    for m in ("n_ivl", "util_ivl", "qdepth_ivl"):
        if not np.allclose(getattr(gpu, m), getattr(cpu, m),
                           rtol=ROW_RTOL, atol=1e-6):
            return f"{m} differs"
    return ""


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA GPU")
    from repro_torch.kernels import _build, vector_quantiles, vector_step
    from repro_torch.vector import VectorConfig, run_cells

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "unknown"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(logs) or 'cached'})", flush=True)
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"  {name}: {'; '.join(regs)}")

    device = torch.device("cuda")
    grids = build_grids()
    by_name = {name: (progs, seeds) for name, progs, seeds in grids}

    # ---- kernel checks at main-path shapes ---------------------------------
    record = {"card": card, "checks": {}}
    for key, grid in (("scalar_scan/fig1", "fig1"),
                      ("scalar_scan/steady16", "steady"),
                      ("batched_scan/batched8", "batched-serving")):
        batched, n_real, inputs = scan_case(*by_name[grid], device)
        rec = check_scan(key, batched, n_real, inputs)
        record["checks"][key] = rec
        print(f"check {key}: {json.dumps(rec)}", flush=True)
    rec = check_quantiles(device)
    record["checks"]["fused_quantiles"] = rec
    print(f"check fused_quantiles: {json.dumps(rec)}", flush=True)

    # ---- the main path, end to end -----------------------------------------
    kernels = (vector_step.scalar_scan, vector_step.batched_scan,
               vector_quantiles.fused_quantiles)
    for k in kernels:
        k.launches = 0
    results = {}
    record["e2e"] = {}
    torch.cuda.synchronize()
    for name, progs, seeds in grids:
        t0 = time.perf_counter()
        rows = run_cells(progs, seeds, VectorConfig(device="cuda"))
        wall = time.perf_counter() - t0
        results[name] = rows
        record["e2e"][name] = {"cells": len(rows), "wall_s": wall,
                               "cells_per_s": len(rows) / wall}
        print(f"e2e {name}: {len(rows)} cells in {wall:.3f} s "
              f"({len(rows) / wall:.1f} cells/s)", flush=True)
    launches = {k.__name__: k.launches for k in kernels}
    print(f"launches on the main path: {launches}", flush=True)
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the main path")
    for name, rows in results.items():
        for i, r in enumerate(rows):
            vals = (r.mean, r.p50, r.p95, r.p99)
            if r.n <= 0 or not all(math.isfinite(v) for v in vals):
                fail(f"{name} cell {i}: n={r.n} row {vals} not finite")

    # ---- three cells of each grid against the CPU --------------------------
    for name, progs, seeds in grids:
        pick = [0, len(progs) // 2, len(progs) - 1]
        cpu = run_cells([progs[i] for i in pick], [seeds[i] for i in pick],
                        VectorConfig(device="cpu"))
        same = 0
        for i, row in zip(pick, cpu):
            gpu = results[name][i]
            why = rows_close(gpu, row)
            if why:
                fail(f"{name} cell {i}: card vs CPU: {why}")
            same += (gpu.n, gpu.mean, gpu.p50, gpu.p95, gpu.p99) == \
                (row.n, row.mean, row.p50, row.p95, row.p99)
        print(f"cpu parity {name}: cells {pick} match "
              f"({same} of 3 bit-identical)", flush=True)

    # ---- the kernels line ---------------------------------------------------
    src = "src/repro_torch/kernels/csrc/"
    checks = record["checks"]
    entries = []
    for name, route_src, replaces, key, err_keys in (
            ("scalar_scan", src + "vector_step.cu",
             "src/repro/kernels/vector_step.py:98", "scalar_scan/fig1",
             ("scalar_scan/fig1", "scalar_scan/steady16")),
            ("batched_scan", src + "vector_step.cu",
             "src/repro/kernels/vector_step.py:132",
             "batched_scan/batched8", ("batched_scan/batched8",)),
            ("fused_quantiles", src + "vector_quantiles.cu",
             "src/repro/kernels/vector_quantiles.py:57", "fused_quantiles",
             ("fused_quantiles",))):
        c = checks[key]
        entries.append({
            "name": name, "route": "cuda", "source": route_src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(checks[k]["max_abs_err"] for k in err_keys),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c.get("library_ms")})
    record["kernels"] = entries
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
