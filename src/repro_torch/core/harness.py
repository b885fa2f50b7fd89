"""Experiment orchestration — the TailBench++ harness entry point.

Copy of ``repro.core.harness``: ``ServerSpec`` and ``Experiment`` (with
the resolution of its profile, service model and token lengths),
``build_simulator`` and ``run``, which execute one deterministic
simulation on the host, and ``run_repeated``, the paper's 13 seeded
repetitions as a one-point sweep (``repro_torch.sweep``), and the
deprecated ``run_engine_experiment`` shim over
``repro_torch.core.runtime.EngineRuntime``.
``Experiment`` runs on the vector runtime too (``repro_torch.vector``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

from repro_torch.core.balancer import POLICIES
from repro_torch.core.client import ClientConfig
from repro_torch.core.profiles import (FixedProfile, TokenLengths,
                                       resolve_service_model,
                                       tailbench_profile)
from repro_torch.core.simulator import SimConfig, SimServer, Simulator
from repro_torch.core.stats import LatencyRecorder, confidence95


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
    legacy_mode: bool = False
    legacy_requests_per_client: Optional[int] = None
    legacy_expected_clients: Optional[int] = None   # default: len(clients)
    hedge_delay: Optional[float] = None
    profile: Optional[object] = None          # overrides `app`
    stats_mode: str = "exact"                 # "exact" | "streaming" recorder
    fast_clients: bool = False                # vectorized constant-QPS arrivals
    slo: Optional[float] = None               # latency SLO (telemetry frames)
    injections: Sequence = ()                 # compiled Scenario injections
    # pluggable ServiceModel: None = scalar default (the app profile);
    # a BatchedService switches servers to the continuous-batching law
    service_model: Optional[object] = None
    lengths: Optional[object] = None          # default per-request TokenLengths
    # resilience + closed-loop control (repro_torch.control): RetryPolicy
    # and BreakerSpec run on the simulator and the engine runtime (the
    # vector runtime records them as unsupported), ControlSpec on those
    # two and the vector runtime's fluid pre-pass
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


def build_simulator(exp: Experiment, rep: int = 0) -> Simulator:
    """Build one deterministic simulation.

    ``rep`` is the repetition index: every client's arrival stream is
    derived from ``(client seed, client_id, rep)``, so repetitions draw
    independent arrival processes even for clients that pin an explicit
    seed (repetition 0 reproduces the un-repeated run bit-for-bit).
    """
    def _srv_seed(sid: int) -> tuple:
        # domain-separated (seed, server_id, rep): repetitions draw
        # independent server-noise streams (mirrors the client-RNG fix)
        return (9176, exp.seed, sid, rep)

    servers = []
    for s in exp.servers:
        if s.join_at != 0.0:
            continue
        srv = SimServer(s.server_id, s.workers, s.speed, s.service_noise,
                        rng_seed=_srv_seed(s.server_id),
                        service_model=exp.service_model,
                        max_batch=s.max_batch)
        if s.standby:
            # standby pool: present (engine parity: built and warm) but
            # drained until a set_scale action activates it
            srv.draining = True
            srv.accepting = False
        servers.append(srv)
    balancer = POLICIES[exp.policy]() if isinstance(exp.policy, str) else exp.policy
    n_expected = exp.legacy_expected_clients
    if n_expected is None:
        n_expected = len(exp.clients)
    cfg = SimConfig(duration=exp.duration, interval=exp.interval, seed=exp.seed,
                    legacy_mode=exp.legacy_mode,
                    legacy_expected_clients=n_expected if exp.legacy_mode else 0,
                    legacy_requests_per_client=exp.legacy_requests_per_client,
                    hedge_delay=exp.hedge_delay, rep=rep,
                    stats_mode=exp.stats_mode, fast_clients=exp.fast_clients,
                    slo=exp.slo, retry=exp.retry, breaker=exp.breaker,
                    control=exp.control)
    sim = Simulator(cfg, servers, balancer, profile=exp.resolved_profile(),
                    lengths=exp.resolved_lengths(),
                    service_model=exp.service_model)
    for c in exp.clients:
        c2 = replace(c, seed=c.seed if c.seed else exp.seed)
        sim.add_client(c2)
    for s in exp.servers:
        if s.join_at > 0.0:
            sim.add_server(SimServer(s.server_id, s.workers, s.speed,
                                     s.service_noise,
                                     rng_seed=_srv_seed(s.server_id),
                                     service_model=exp.service_model,
                                     max_batch=s.max_batch),
                           s.join_at)
        if s.drain_at is not None:
            sim.drain_server(s.server_id, s.drain_at)
    for inj in exp.injections:
        sim.apply_injection(inj.kind, inj.at, inj.params)
    return sim


def run(exp: Experiment, rep: int = 0) -> Simulator:
    sim = build_simulator(exp, rep=rep)
    sim.run()
    return sim


def _repeated_point(exp: Experiment, ctx):
    """Sweep factory for ``run_repeated``: replay the base experiment
    under the derived per-repetition seed."""
    return replace(exp, seed=ctx.seed)


def run_repeated(exp: Experiment, reps: int = 13,
                 metric: Callable[[LatencyRecorder], float] = lambda r: r.overall().p99):
    """Paper methodology: 13 seeded repetitions -> (mean, 95% CI half-width).

    A one-point ``repro_torch.sweep`` declaration with the
    ``"run-repeated"`` seeder on the host's event simulator (``sim``),
    bit-compatible with the reference's ``run_repeated``: repetition
    ``rep`` runs seed ``exp.seed + 1000*(rep+1)`` and threads ``rep``
    into every client's RNG stream.  The first failing repetition
    raises its original exception (``fail_fast``).
    """
    from functools import partial

    from repro_torch.sweep import Sweep, run_sweep
    sweep = Sweep(name="run_repeated",
                  factory=partial(_repeated_point, exp),
                  reps=reps, base_seed=exp.seed, seeder="run-repeated",
                  metrics=(("value", lambda rt: metric(rt.recorder)),))
    frame = run_sweep(sweep, executor="serial", progress=None,
                      fail_fast=True)
    vals = [row.metrics["value"] for row in frame.rows]
    return confidence95(vals), vals


# ---------------------------------------------------------------------------
# Real-engine mode: deprecated shim over repro_torch.core.runtime.EngineRuntime.
# ---------------------------------------------------------------------------
def run_engine_experiment(engines: list, clients: Sequence[ClientConfig], *,
                          policy: str = "round_robin", duration: float = 10.0,
                          prompt_len: int = 16, max_new_tokens: int = 4,
                          vocab: int = 256, seed: int = 0,
                          time_scale: float = 1.0) -> LatencyRecorder:
    """Deprecated: use ``repro_torch.core.runtime.EngineRuntime``.

    Kept, with the reference's signature and warning, for callers of the
    old entry point: it runs ``EngineRuntime`` on the wall clock for
    ``duration`` seconds and returns its recorder.
    """
    import warnings

    from repro_torch.core.runtime import EngineRuntime
    warnings.warn("run_engine_experiment is deprecated; use "
                  "repro_torch.core.runtime.EngineRuntime",
                  DeprecationWarning, stacklevel=2)
    rt = EngineRuntime(engines, clients, policy=policy, duration=duration,
                       prompt_len=prompt_len, max_new_tokens=max_new_tokens,
                       vocab=vocab, seed=seed, time_scale=time_scale)
    rt.run()
    return rt.recorder
