"""Beyond paper: hedged requests + request-level policies under server noise.

Twin of ``benchmarks/hedging.py`` on the PyTorch/CUDA port: the same
``SWEEP`` declaration (runtime included), run through
``repro_torch.sweep``; the figure CSV goes to ``artifacts/bench_torch/``.

Tail-at-scale scenario: 3 noisy servers (log-sigma 1.0); compare p99 with
and without hedging at several hedge delays, plus JSQ vs P2C vs RR.

Declared as a ``repro_torch.sweep`` grid over the hedge-delay axis at the
paper's 13 repetitions (the old script hand-picked ``reps=9``), using
the default collision-free ``"spawn"`` seeder.
"""
from __future__ import annotations

import time

from benchmarks.torch_port.common import emit
from repro_torch.core.client import ClientConfig, ConstantQPS
from repro_torch.core.harness import Experiment, ServerSpec
from repro_torch.sweep import Axis, PointCtx, Sweep, run_sweep

HEDGES = (("none", None), ("5ms", 0.005), ("10ms", 0.01), ("25ms", 0.025))
REPS = 13


def _point(ctx: PointCtx) -> Experiment:
    delay = dict(HEDGES)[ctx.params["hedge"]]
    clients = [ClientConfig(i, ConstantQPS(40), seed=4) for i in range(4)]
    servers = tuple(ServerSpec(i, service_noise=1.0) for i in range(3))
    return Experiment(clients=clients, servers=servers, app="xapian",
                      duration=20.0, policy="jsq", hedge_delay=delay,
                      seed=ctx.seed)


SWEEP = Sweep(name="hedging", factory=_point,
              axes=(Axis("hedge", tuple(label for label, _ in HEDGES)),),
              reps=REPS, base_seed=4, metrics=("p99",))


def main() -> str:
    t0 = time.time()
    frame = run_sweep(SWEEP, progress=None).raise_errors()
    rows = []
    base_p99 = None
    best = (None, 1.0)
    for agg in frame.aggregate("p99"):
        label, p99, ci = agg["params"]["hedge"], agg["mean"], agg["ci95"]
        rows.append({"hedge": label, "p99_ms": f"{p99*1e3:.3f}",
                     "ci95": f"{ci*1e3:.3f}"})
        if label == "none":
            base_p99 = p99
        elif p99 / base_p99 < best[1]:
            best = (label, p99 / base_p99)
    emit("hedging", rows, t0,
         f"best_hedge={best[0]};p99_cut={1-best[1]:.1%}")
    return f"cut={1-best[1]:.1%}"


if __name__ == "__main__":
    main()
