"""Paper Fig. 7 + Table 5: one client varying QPS every 10s.

Twin of ``benchmarks/fig7_dynamic_qps.py`` on the PyTorch/CUDA port: the same
``SWEEP`` declaration (runtime included), run through
``repro_torch.sweep``; the figure CSV goes to ``artifacts/bench_torch/``.

100 -> 300 -> 500 -> 600 -> 800 -> 100 QPS; per-interval mean/p95/p99.
Expected: latency tracks load, burstiness near saturation (40-50s window),
and the first/last intervals match (same 100 QPS).

A one-point ``repro_torch.sweep`` declaration with telemetry capture; window
statistics come from the row's per-interval series (bit-identical to
the live ``MetricsPipeline.window`` values).
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks.torch_port.common import emit
from repro_torch.core.client import ClientConfig, PiecewiseQPS
from repro_torch.core.harness import Experiment, ServerSpec
from repro_torch.sweep import PointCtx, Sweep, run_sweep, series_window

TABLE5 = [(0, 100), (10, 300), (20, 500), (30, 600), (40, 800), (50, 100)]


def _point(ctx: PointCtx) -> Experiment:
    return Experiment(clients=[ClientConfig(0, PiecewiseQPS(TABLE5))],
                      servers=(ServerSpec(0, workers=1),),
                      app="xapian", duration=60.0, seed=ctx.seed)


SWEEP = Sweep(name="fig7_dynamic_qps", factory=_point, reps=1,
              base_seed=13, seeder="fixed", metrics=(), telemetry=True)


def main() -> str:
    t0 = time.time()
    frame = run_sweep(SWEEP, progress=None).raise_errors()
    series = frame.rows[0].series
    rows = [{"t": r["t"], "n": r["n"], "mean_ms": f"{r['mean']*1e3:.3f}",
             "p95_ms": f"{r['p95']*1e3:.3f}", "p99_ms": f"{r['p99']*1e3:.3f}"}
            for r in series if r["cid"] == -1]
    first = np.nanmean(series_window(series, "p99", 2, 9))
    last = np.nanmean(series_window(series, "p99", 52, 59))
    peak = np.nanmax(series_window(series, "p99", 41, 50))
    sym = last / first
    emit("fig7_dynamic_qps", rows, t0,
         f"first_vs_last_p99_ratio={sym:.2f};peak_p99_ms={peak*1e3:.1f}")
    return f"sym={sym:.2f}"


if __name__ == "__main__":
    main()
