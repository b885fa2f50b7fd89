"""Paper Fig. 8: round-robin vs load-aware balancing, 2 servers, 3 clients

Twin of ``benchmarks/fig8_balancing.py`` on the PyTorch/CUDA port: the same
``SWEEP`` declaration (runtime included), run through
``repro_torch.sweep``; the figure CSV goes to ``artifacts/bench_torch/``.
(500/200/200 QPS).  Load-aware isolates the heavy client; round-robin can
co-locate it with another client, hurting its p99.

Declared as a ``repro_torch.sweep`` grid over the policy axis with 13
repetitions and per-client summary capture.  The ``"rep"`` seeder
replays the historical ``for seed in range(13)`` loop (the repetition
index IS the experiment seed and the clients derive their streams from
it), keeping the figure CSV bit-identical to the pre-sweep output.
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks.torch_port.common import emit
from repro_torch.core.client import ClientConfig, ConstantQPS
from repro_torch.core.harness import Experiment, ServerSpec
from repro_torch.sweep import Axis, PointCtx, Sweep, run_sweep

POLICIES = ("round_robin", "load_aware", "jsq", "p2c")


def _point(ctx: PointCtx) -> Experiment:
    seed = ctx.seed
    clients = [ClientConfig(1, ConstantQPS(500), seed=seed),
               ClientConfig(2, ConstantQPS(200), seed=seed + 99),
               ClientConfig(3, ConstantQPS(200), seed=seed + 198)]
    return Experiment(clients=clients,
                      servers=(ServerSpec(0), ServerSpec(1)),
                      app="xapian", duration=15.0,
                      policy=ctx.params["policy"], seed=seed)


SWEEP = Sweep(name="fig8_balancing", factory=_point,
              axes=(Axis("policy", POLICIES),), reps=13,
              base_seed=0, seeder="rep", metrics=(), per_client=True)


def main() -> str:
    t0 = time.time()
    frame = run_sweep(SWEEP, progress=None).raise_errors()
    rows = []
    worst = {}
    for policy in POLICIES:
        per_client = {c: [r.clients[str(c)]["p99"]
                          for r in frame.ok_rows
                          if r.params["policy"] == policy]
                      for c in (1, 2, 3)}
        for c in (1, 2, 3):
            rows.append({"policy": policy, "client": c,
                         "p99_ms": f"{np.mean(per_client[c])*1e3:.3f}"})
        worst[policy] = max(np.mean(per_client[c]) for c in (1, 2, 3))
    gain = worst["round_robin"] / worst["load_aware"]
    emit("fig8_balancing", rows, t0, f"rr_vs_load_aware_worst_p99={gain:.2f}x")
    return f"gain={gain:.2f}x"


if __name__ == "__main__":
    main()
