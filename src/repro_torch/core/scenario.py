"""Declarative dynamic scenarios — the TailBench++ scenario layer.

A ``Scenario`` is a timed, declarative description of everything dynamic
the paper's harness exists to reproduce: clients arriving and leaving
(churn processes, flash crowds), load shapes changing mid-run, servers
joining, draining, failing or slowing down, and mid-run policy or hedging
changes.  It *compiles down* to ``Experiment`` primitives — client
configs with start/end times and QPS schedules, server specs with
``join_at``/``drain_at``, plus a list of ``Injection`` records for the
behaviors those primitives cannot express (failure, slowdown,
policy/hedge swaps).  Copy of ``repro.core.scenario``; the compiled
experiment runs on the vector runtime, the simulator or engines (see
``repro_torch.core.runtime.run_scenario``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.client import ClientConfig, ConstantQPS, QPSSchedule
from repro_torch.core.harness import Experiment, ServerSpec


# ---------------------------------------------------------------------------
# Compiled injection record
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Injection:
    at: float
    kind: str           # server_fail | server_speed | server_join |
                        # server_drain | set_policy | set_hedge |
                        # set_admission | set_scale | set_retry | set_breaker
    params: dict
    # declaration-order tie-break: injections at identical timestamps
    # apply in ``(at, seq)`` order on EVERY backend, mirroring the
    # calendar queue's total order.  ``Scenario.compile`` stamps this;
    # runtime-synthesized injections (spec joins/drains) use negative
    # seqs because the simulator schedules them before the compiled
    # injection list at equal timestamps.
    seq: int = 0


# ---------------------------------------------------------------------------
# Declarative scenario events
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ClientArrival:
    """``count`` clients appear at ``at`` with the given load shape and
    optionally leave (``leave_at``) or stop after ``requests``."""
    at: float
    qps: Union[float, QPSSchedule]
    count: int = 1
    requests: Optional[int] = None
    leave_at: Optional[float] = None


@dataclass(frozen=True)
class FlashCrowd:
    """A burst of ``clients`` extra clients between ``at`` and
    ``at + duration``, together offering ``peak_qps``."""
    at: float
    duration: float
    peak_qps: float
    clients: int = 5


@dataclass(frozen=True)
class ClientChurn:
    """A Poisson churn process: short-lived clients arrive at
    ``arrival_rate`` per second over [start, stop), each holding a
    connection for ~Exp(hold_mean) seconds at ``qps``.  Expanded
    deterministically from the scenario seed at compile time."""
    start: float
    stop: float
    arrival_rate: float
    hold_mean: float
    qps: float
    salt: int = 0


@dataclass(frozen=True)
class ServerJoin:
    at: float
    server_id: int
    workers: int = 1
    speed: float = 1.0
    service_noise: float = 0.0
    max_batch: Optional[int] = None    # batch slots (batched ServiceModels)


@dataclass(frozen=True)
class ServerDrain:
    at: float
    server_id: int


@dataclass(frozen=True)
class ServerFail:
    at: float
    server_id: int


@dataclass(frozen=True)
class ServerSlowdown:
    """Server runs ``factor``x slower from ``at`` (until ``until``)."""
    at: float
    server_id: int
    factor: float
    until: Optional[float] = None


@dataclass(frozen=True)
class SetPolicy:
    at: float
    policy: str


@dataclass(frozen=True)
class SetHedge:
    at: float
    delay: Optional[float]


@dataclass(frozen=True)
class SetAdmission:
    """Admission control from ``at``: probabilistic (``admit`` fraction)
    or token-bucket (``rate`` req/s, ``burst`` capacity).  ``admit=1.0``
    with no rate disables shedding."""
    at: float
    admit: Optional[float] = None
    rate: Optional[float] = None
    burst: float = 1.0


@dataclass(frozen=True)
class SetScale:
    """Scale the fleet to ``n`` active servers at ``at``, drawing from
    the standby pool (``ServerSpec.standby=True``) in server-id order;
    surplus servers drain (residual work completes)."""
    at: float
    n: int


@dataclass(frozen=True)
class SetRetry:
    """Install (or, with ``policy=None``, remove) the client-side
    timeout/retry policy (a ``repro.control.RetryPolicy``) at ``at``."""
    at: float
    policy: Optional[object]


@dataclass(frozen=True)
class SetBreaker:
    """Install (or remove) per-server circuit breaking (a
    ``repro.control.BreakerSpec``) at ``at``."""
    at: float
    spec: Optional[object]


@dataclass(frozen=True)
class CorrelatedFailure:
    """Several servers die at the SAME instant (shared rack/AZ failure).
    Lowers to one ``server_fail`` injection per server at identical
    timestamps — their application order is the declaration order of
    ``server_ids`` (the ``(at, seq)`` tie-break)."""
    at: float
    server_ids: tuple


ScenarioEvent = Union[ClientArrival, FlashCrowd, ClientChurn, ServerJoin,
                      ServerDrain, ServerFail, ServerSlowdown, SetPolicy,
                      SetHedge, SetAdmission, SetScale, SetRetry,
                      SetBreaker, CorrelatedFailure]


# ---------------------------------------------------------------------------
# Scenario
# ---------------------------------------------------------------------------
@dataclass
class Scenario:
    name: str
    duration: float
    events: Sequence[ScenarioEvent] = ()
    servers: Sequence[ServerSpec] = (ServerSpec(0),)   # initial fleet
    app: str = "xapian"
    policy: str = "round_robin"
    seed: int = 0
    interval: float = 1.0
    slo: Optional[float] = None
    hedge_delay: Optional[float] = None
    stats_mode: str = "exact"
    # pluggable service layer: a BatchedService switches every server to
    # the continuous-batching serve loop; lengths gives every client a
    # per-request token-size distribution (identical on both backends)
    service_model: Optional[object] = None
    lengths: Optional[object] = None
    # resilience + closed-loop control (repro.control): a RetryPolicy
    # gives clients timeouts/bounded retries from t=0, a BreakerSpec
    # enables per-server circuit breaking, a ControlSpec runs a reactive
    # controller over the run's telemetry
    retry: Optional[object] = None
    breaker: Optional[object] = None
    control: Optional[object] = None

    # ------------------------------------------------------------- compile
    def compile(self) -> Experiment:
        """Lower the declarative events onto ``Experiment`` primitives.

        Client events become ``ClientConfig``s (ids allocated in event
        order, deterministically); server join/drain map to
        ``ServerSpec.join_at``/``drain_at``; everything else becomes an
        ``Injection`` the runtime applies at the scheduled time.
        """
        clients: list[ClientConfig] = []
        servers: dict[int, ServerSpec] = {s.server_id: s for s in self.servers}
        injections: list[Injection] = []
        next_cid = 0

        def add_client(at, schedule, requests=None, leave_at=None):
            nonlocal next_cid
            clients.append(ClientConfig(
                client_id=next_cid, schedule=schedule, start_time=at,
                total_requests=requests,
                end_time=min(leave_at, self.duration)
                         if leave_at is not None else None))
            next_cid += 1

        for ev in self.events:
            if isinstance(ev, ClientArrival):
                sched = (ConstantQPS(float(ev.qps))
                         if not isinstance(ev.qps, QPSSchedule) else ev.qps)
                for _ in range(ev.count):
                    add_client(ev.at, sched, ev.requests, ev.leave_at)
            elif isinstance(ev, FlashCrowd):
                per = ev.peak_qps / max(ev.clients, 1)
                for _ in range(ev.clients):
                    add_client(ev.at, ConstantQPS(per),
                               leave_at=ev.at + ev.duration)
            elif isinstance(ev, ClientChurn):
                rng = np.random.default_rng((self.seed, 0xC4, ev.salt))
                t = ev.start
                while True:
                    t += float(rng.exponential(1.0 / ev.arrival_rate))
                    if t >= ev.stop:
                        break
                    hold = float(rng.exponential(ev.hold_mean))
                    add_client(t, ConstantQPS(ev.qps), leave_at=t + hold)
            elif isinstance(ev, ServerJoin):
                if ev.server_id in servers:
                    raise ValueError(f"server {ev.server_id} already exists")
                servers[ev.server_id] = ServerSpec(
                    ev.server_id, workers=ev.workers, speed=ev.speed,
                    service_noise=ev.service_noise, join_at=ev.at,
                    max_batch=ev.max_batch)
            elif isinstance(ev, ServerDrain):
                spec = servers.get(ev.server_id)
                if spec is None:
                    raise ValueError(f"unknown server {ev.server_id}")
                servers[ev.server_id] = replace(spec, drain_at=ev.at)
            elif isinstance(ev, ServerFail):
                if ev.server_id not in servers:
                    raise ValueError(f"unknown server {ev.server_id}")
                injections.append(Injection(ev.at, "server_fail",
                                            {"server_id": ev.server_id}))
            elif isinstance(ev, ServerSlowdown):
                injections.append(Injection(
                    ev.at, "server_speed",
                    {"server_id": ev.server_id, "factor": 1.0 / ev.factor}))
                if ev.until is not None:
                    injections.append(Injection(
                        ev.until, "server_speed",
                        {"server_id": ev.server_id, "factor": ev.factor}))
            elif isinstance(ev, SetPolicy):
                injections.append(Injection(ev.at, "set_policy",
                                            {"policy": ev.policy}))
            elif isinstance(ev, SetHedge):
                injections.append(Injection(ev.at, "set_hedge",
                                            {"delay": ev.delay}))
            elif isinstance(ev, SetAdmission):
                injections.append(Injection(ev.at, "set_admission",
                                            {"admit": ev.admit,
                                             "rate": ev.rate,
                                             "burst": ev.burst}))
            elif isinstance(ev, SetScale):
                injections.append(Injection(ev.at, "set_scale",
                                            {"n": int(ev.n)}))
            elif isinstance(ev, SetRetry):
                injections.append(Injection(ev.at, "set_retry",
                                            {"policy": ev.policy}))
            elif isinstance(ev, SetBreaker):
                injections.append(Injection(ev.at, "set_breaker",
                                            {"spec": ev.spec}))
            elif isinstance(ev, CorrelatedFailure):
                for sid in ev.server_ids:
                    if sid not in servers:
                        raise ValueError(f"unknown server {sid}")
                    injections.append(Injection(ev.at, "server_fail",
                                                {"server_id": sid}))
            else:
                raise TypeError(f"unknown scenario event: {ev!r}")

        # declaration-order seq stamp + (at, seq) sort: identical-time
        # injections apply in declaration order on every backend
        injections = [replace(inj, seq=k)
                      for k, inj in enumerate(injections)]
        injections.sort(key=lambda i: (i.at, i.seq))
        return Experiment(
            clients=tuple(clients),
            servers=tuple(servers.values()),
            app=self.app, policy=self.policy, duration=self.duration,
            interval=self.interval, seed=self.seed,
            hedge_delay=self.hedge_delay, stats_mode=self.stats_mode,
            slo=self.slo, injections=tuple(injections),
            service_model=self.service_model, lengths=self.lengths,
            retry=self.retry, breaker=self.breaker, control=self.control)
