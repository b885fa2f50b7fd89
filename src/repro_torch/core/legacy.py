"""Original-TailBench baseline semantics (the paper's comparison target).

The four restrictions the paper lifts:
  1. server waits for a fixed number of clients before processing
  2. no new client connections once processing starts
  3. server terminates when all predefined clients disconnect
  4. per-client request totals are fixed server-side

``legacy_experiment`` builds an Experiment with these semantics enabled;
Fig. 4 / Table 4 compare it against the TailBench++ mode and verify the
latency distributions are statistically indistinguishable (Welch).
Copy of ``repro.core.legacy``; such an experiment runs on the ``sim``
backend only (the vector compiler refuses ``legacy_mode``).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence

from repro_torch.core.client import ClientConfig, ConstantQPS
from repro_torch.core.harness import Experiment, ServerSpec


def legacy_experiment(n_clients: int, qps_per_client: float, *,
                      requests_per_client: int, app: str = "xapian",
                      duration: float = 60.0, seed: int = 0,
                      workers: int = 1) -> Experiment:
    """All clients start at t=0 with identical server-assigned budgets."""
    clients = [ClientConfig(client_id=i, schedule=ConstantQPS(qps_per_client),
                            start_time=0.0, total_requests=requests_per_client,
                            seed=seed)
               for i in range(n_clients)]
    return Experiment(clients=clients, servers=(ServerSpec(0, workers=workers),),
                      app=app, duration=duration, seed=seed,
                      legacy_mode=True,
                      legacy_requests_per_client=requests_per_client)


def plusplus_equivalent(exp: Experiment) -> Experiment:
    """The same workload expressed with TailBench++ semantics (client-side
    budgets, dynamic admission) — the paper's equivalence claim is that this
    produces statistically identical latency distributions."""
    return replace(exp, legacy_mode=False, legacy_requests_per_client=None)
