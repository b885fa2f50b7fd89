"""Experiment description — the TailBench++ harness's data model.

Trimmed copy of ``repro.core.harness``: ``ServerSpec`` and
``Experiment`` with the resolution of its profile, service model and
token lengths.  The event-engine simulator builders are not part of
this package; an ``Experiment`` here runs on the vector runtime.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.client import ClientConfig
from repro_torch.core.profiles import (FixedProfile, TokenLengths,
                                       resolve_service_model,
                                       tailbench_profile)


@dataclass
class ServerSpec:
    server_id: int
    workers: int = 1
    speed: float = 1.0
    service_noise: float = 0.0     # log-sigma of per-execution server noise
    join_at: float = 0.0
    drain_at: Optional[float] = None
    max_batch: Optional[int] = None   # batch slots (batched ServiceModels)
    # standby pool for elastic scale (set_scale injections): the server
    # exists from t=0 but starts drained until a scale action activates it
    standby: bool = False


@dataclass
class Experiment:
    clients: Sequence[ClientConfig]
    servers: Sequence[ServerSpec] = (ServerSpec(0),)
    app: str = "xapian"
    policy: str = "round_robin"
    duration: float = 60.0
    interval: float = 1.0
    seed: int = 0
    hedge_delay: Optional[float] = None
    profile: Optional[object] = None          # overrides `app`
    slo: Optional[float] = None               # latency SLO (telemetry frames)
    injections: Sequence = ()                 # compiled Scenario injections
    # pluggable ServiceModel: None = scalar default (the app profile);
    # a BatchedService switches servers to the continuous-batching law
    service_model: Optional[object] = None
    lengths: Optional[object] = None          # default per-request TokenLengths
    # resilience + closed-loop control specs; the vector runtime records
    # retry/breaker as unsupported and does not lower control yet
    retry: Optional[object] = None
    breaker: Optional[object] = None
    control: Optional[object] = None

    def resolved_profile(self):
        if self.profile is not None:
            return self.profile
        if self.service_model is not None:
            if getattr(self.service_model, "kind", "scalar") == "batched":
                # batched servers cost requests by token counts, not by a
                # scalar demand
                return FixedProfile("tokens", 0.0)
            prof = getattr(self.service_model, "profile", None)
            if prof is not None:
                return prof
        return tailbench_profile(self.app)

    def resolved_service(self):
        """The effective ServiceModel (scalar wraps the profile)."""
        return resolve_service_model(self.service_model,
                                     self.resolved_profile())

    def resolved_lengths(self):
        """The effective per-request TokenLengths: a batched service
        model defaults to the stock distribution."""
        if self.lengths is not None:
            return self.lengths
        if (self.service_model is not None
                and getattr(self.service_model, "kind", "scalar") == "batched"):
            return TokenLengths()
        return None
