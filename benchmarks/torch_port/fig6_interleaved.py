"""Paper Fig. 6: interleaved client arrival pattern (features 1+2+3).

Twin of ``benchmarks/fig6_interleaved.py`` on the PyTorch/CUDA port: the same
``SWEEP`` declaration (runtime included), run through
``repro_torch.sweep``; the figure CSV goes to ``artifacts/bench_torch/``.

xapian, 1 server; clients start at 0/15/35s with budgets 10000/7000/5000 at
200 QPS each.  Per-interval p99 per client; when clients 1+2 finish, client
3's latency drops back to client 1's solo level.

A one-point ``repro_torch.sweep`` declaration with per-client telemetry
capture — the per-interval series in the ``SweepRow`` carries exactly
what ``MetricsPipeline.series``/``window`` exposed on the live run, so
the figure CSV is bit-identical to the pre-sweep output.
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks.torch_port.common import emit
from repro_torch.core.client import ClientConfig, ConstantQPS
from repro_torch.core.harness import Experiment, ServerSpec
from repro_torch.sweep import PointCtx, Sweep, run_sweep, series_window


def _point(ctx: PointCtx) -> Experiment:
    clients = [
        ClientConfig(1, ConstantQPS(200), start_time=0.0, total_requests=10000),
        ClientConfig(2, ConstantQPS(200), start_time=15.0, total_requests=7000),
        ClientConfig(3, ConstantQPS(200), start_time=35.0, total_requests=5000),
    ]
    return Experiment(clients=clients, servers=(ServerSpec(0, workers=2),),
                      app="xapian", duration=70.0, seed=ctx.seed)


SWEEP = Sweep(name="fig6_interleaved", factory=_point, reps=1,
              base_seed=11, seeder="fixed", metrics=(),
              telemetry=True, per_client=True)


def main() -> str:
    t0 = time.time()
    frame = run_sweep(SWEEP, progress=None).raise_errors()
    series = frame.rows[0].series
    rows = []
    for cid in (1, 2, 3):
        for r in series:
            if r["cid"] == cid:
                rows.append({"client": cid, "t": r["t"], "n": r["n"],
                             "p99_ms": f"{r['p99'] * 1e3:.3f}"})
    # check the paper's observation: client 3 alone (~t>52) ≈ client 1 solo (~t<14)
    solo1 = series_window(series, "p99", 2, 13, cid=1)
    solo3 = series_window(series, "p99", 53, cid=3)
    ratio = np.nanmean(solo3) / np.nanmean(solo1) if solo1 and solo3 else float("nan")
    emit("fig6_interleaved", rows, t0, f"solo3_vs_solo1_p99_ratio={ratio:.2f}")
    return f"ratio={ratio:.2f}"


if __name__ == "__main__":
    main()
