"""Paper Fig. 1: QPS vs latency for the web-search app (xapian).

Twin of ``benchmarks/fig1_qps_latency.py`` on the PyTorch/CUDA port: the same
``SWEEP`` declaration (runtime included), run through
``repro_torch.sweep``; the figure CSV goes to ``artifacts/bench_torch/``.

Three clients, one server; sweep offered QPS; report mean/p95/p99.
Reproduces the shape: flat low-ms latency then a knee near saturation.

Declared as a ``repro_torch.sweep`` grid: one axis (offered QPS), one
repetition, fixed seed — bit-identical to the historical hand-rolled
loop (seeder ``"fixed"`` replays ``seed=1`` / rep-stream 0 per point).
"""
from __future__ import annotations

import time

from benchmarks.torch_port.common import emit
from repro_torch.core.client import ClientConfig, ConstantQPS
from repro_torch.core.harness import Experiment, ServerSpec
from repro_torch.sweep import Axis, PointCtx, Sweep, run_sweep

QPS_AXIS = (100, 250, 500, 1000, 2000, 3000, 4000, 4600, 5200)


def _point(ctx: PointCtx) -> Experiment:
    qps = ctx.params["qps"]
    clients = [ClientConfig(i, ConstantQPS(qps / 3), seed=1)
               for i in range(3)]
    # xapian server: 6 workers -> capacity ~4.4k QPS (paper: degrades >4000)
    return Experiment(clients=clients, servers=(ServerSpec(0, workers=6),),
                      duration=15.0, app="xapian", seed=ctx.seed)


SWEEP = Sweep(name="fig1_qps_latency", factory=_point,
              axes=(Axis("qps", QPS_AXIS),), reps=1,
              base_seed=1, seeder="fixed",
              metrics=("n", "mean", "p95", "p99"))


def main() -> str:
    t0 = time.time()
    frame = run_sweep(SWEEP, progress=None).raise_errors()
    rows = []
    knee = None
    prev_p99 = None
    for r in frame.rows:
        m = r.metrics
        rows.append({"qps": r.params["qps"], "n": m["n"],
                     "mean_ms": m["mean"] * 1e3, "p95_ms": m["p95"] * 1e3,
                     "p99_ms": m["p99"] * 1e3})
        if prev_p99 and m["p99"] > 3 * prev_p99 and knee is None:
            knee = r.params["qps"]
        prev_p99 = m["p99"]
    emit("fig1_qps_latency", rows, t0, f"knee_qps={knee}")
    return f"knee_qps={knee}"


if __name__ == "__main__":
    main()
