"""Control policies: observe windowed telemetry, emit actions.

A ``ControlPolicy`` is the reactive half of the harness: once per
control interval the owning runtime builds an ``Observation`` from its
telemetry (served QPS, windowed p99, utilization, queue depth,
SLO-violation fraction) and the policy answers with zero or more
actions — ``("set_scale", {"n": ...})`` / ``("set_admission",
{"admit": ...})`` tuples shaped exactly like injection records, so one
application path serves scripted injections and closed-loop control.

Policies are *declared* as ``ControlSpec`` — a frozen, hashable,
fingerprintable record — so they sweep as first-class axes through
``repro.sweep`` and key result-cache entries; ``spec.build()``
instantiates the mutable per-run policy object from the
``CONTROLLERS`` registry.

The two stock policies key on utilization and queue depth, which every
backend can observe (the vector runtime's fluid pre-pass included);
percentile-keyed policies run on the event backends only — the fluid
observation carries ``p99 = nan`` and a policy must treat NaN fields
as "unobserved", never act on them.

Copy of ``repro.control.policy``.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Observation:
    """One control-interval window of telemetry, backend-agnostic.
    Fields a backend cannot measure are NaN (fluid limit: p99,
    slo_frac) — policies must no-op on NaN, not compare against it."""
    t: float                     # window end (virtual seconds)
    n: int                       # requests served in the window
    qps: float                   # served throughput over the window
    p99: float                   # windowed p99 latency (NaN: unobserved)
    mean: float                  # windowed mean latency (NaN: unobserved)
    util: float                  # mean utilization across active servers
    qdepth: float                # total queued requests across the fleet
    slo_frac: float              # windowed SLO-violation fraction (NaN ok)
    n_active: int                # servers currently accepting work
    admit: float                 # current admission level in [0, 1]


class ControlPolicy:
    """Base class: ``update(obs) -> [(kind, params), ...]``."""

    def update(self, obs: Observation) -> list:
        raise NotImplementedError


class ThresholdAutoscaler(ControlPolicy):
    """Scale out when the keyed metric crosses ``high``, in below
    ``low`` — the classic reactive autoscaler whose actuation lag and
    cooldown (enforced by ``ControlLoop``) create the over/undershoot
    dynamics the paper's flash-crowd scenarios exercise."""

    def __init__(self, high: float = 0.85, low: float = 0.40,
                 metric: str = "util", step: int = 1,
                 min_servers: int = 1, max_servers: int = 1024):
        self.high = float(high)
        self.low = float(low)
        self.metric = metric
        self.step = int(step)
        self.min_servers = int(min_servers)
        self.max_servers = int(max_servers)

    def update(self, obs: Observation) -> list:
        x = getattr(obs, self.metric)
        if x != x:                          # NaN: metric unobserved here
            return []
        if x > self.high and obs.n_active < self.max_servers:
            n = min(obs.n_active + self.step, self.max_servers)
            return [("set_scale", {"n": n})]
        if x < self.low and obs.n_active > self.min_servers:
            n = max(obs.n_active - self.step, self.min_servers)
            return [("set_scale", {"n": n})]
        return []


class AdmissionShedder(ControlPolicy):
    """AIMD admission control: when per-server queue depth exceeds
    ``target_qdepth`` the admit level drops multiplicatively
    (``decrease``); while the fleet is healthy it recovers additively
    (``increase``) back to 1.0.  Floor keeps a trickle of traffic
    flowing so recovery is observable."""

    def __init__(self, target_qdepth: float = 8.0, decrease: float = 0.7,
                 increase: float = 0.1, floor: float = 0.05):
        self.target_qdepth = float(target_qdepth)
        self.decrease = float(decrease)
        self.increase = float(increase)
        self.floor = float(floor)

    def update(self, obs: Observation) -> list:
        if obs.qdepth != obs.qdepth or obs.n_active <= 0:
            return []
        per_server = obs.qdepth / obs.n_active
        if per_server > self.target_qdepth:
            admit = max(self.floor, obs.admit * self.decrease)
        elif obs.admit < 1.0:
            admit = min(1.0, obs.admit + self.increase)
        else:
            return []
        if admit == obs.admit:
            return []
        return [("set_admission", {"admit": admit})]


#: name -> policy class; ``ControlSpec.build`` resolves through this
CONTROLLERS = {
    "threshold_autoscaler": ThresholdAutoscaler,
    "admission_shedder": AdmissionShedder,
}


@dataclass(frozen=True)
class ControlSpec:
    """Declarative, hashable form of one closed-loop controller.

    ``params`` is a sorted tuple of ``(name, value)`` pairs so the spec
    hashes, pickles across sweep workers, and fingerprints for the
    result cache.  ``interval`` is the observation cadence, ``lag`` the
    actuation delay between a decision and its effect (provisioning
    time), ``cooldown`` the minimum time between consecutive actions.
    """
    name: str
    params: tuple = ()
    interval: float = 1.0
    lag: float = 0.0
    cooldown: float = 0.0

    @classmethod
    def make(cls, name: str, *, interval: float = 1.0, lag: float = 0.0,
             cooldown: float = 0.0, **params) -> "ControlSpec":
        if name not in CONTROLLERS:
            raise ValueError(f"unknown controller {name!r}; known: "
                             f"{', '.join(sorted(CONTROLLERS))}")
        return cls(name=name, params=tuple(sorted(params.items())),
                   interval=float(interval), lag=float(lag),
                   cooldown=float(cooldown))

    def build(self) -> ControlPolicy:
        cls = CONTROLLERS.get(self.name)
        if cls is None:
            raise ValueError(f"unknown controller {self.name!r}; known: "
                             f"{', '.join(sorted(CONTROLLERS))}")
        return cls(**dict(self.params))
