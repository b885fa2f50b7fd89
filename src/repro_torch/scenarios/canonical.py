"""The canonical TailBench++ scenarios.

Each builder returns a ``Scenario`` exercising one dynamic-cloud pattern
the paper's harness exists to reproduce (DeathStarBench's argument:
benchmark value comes from scenario breadth).  All are deterministic
functions of their seed, run on both backends, and accept keyword
overrides (duration, seed, app, policy, slo, ...).  Copy of
``repro.scenarios.canonical``.
"""
from __future__ import annotations

from repro_torch.core.client import DiurnalQPS, PiecewiseQPS
from repro_torch.core.harness import ServerSpec
from repro_torch.core.profiles import BatchedService, TokenLengths
from repro_torch.core.scenario import (ClientArrival, ClientChurn,
                                       FlashCrowd, Scenario, ServerDrain,
                                       ServerFail, ServerJoin, SetHedge,
                                       SetPolicy)
from repro_torch.scenarios import register


def default_batched_service() -> BatchedService:
    """A small-model serving cost profile: 2ms weight-streaming per decode
    step (memory term), ridge point at batch 8, prompt prefill at
    10us/token.  Calibrate from a real architecture's roofline with
    ``BatchedService.from_arch("phi3-mini-3.8b")`` instead."""
    return BatchedService("batched:default", t_memory=2e-3,
                          t_compute_per_seq=2.5e-4,
                          t_prefill_per_token=1e-5)


@register("steady")
def steady(*, duration: float = 30.0, seed: int = 0, app: str = "xapian",
           policy: str = "round_robin", n_clients: int = 4,
           qps: float = 800.0, n_servers: int = 2, slo: float = None,
           **kw) -> Scenario:
    """Baseline: a fixed fleet under constant aggregate load."""
    return Scenario(
        name="steady", duration=duration, app=app, policy=policy, seed=seed,
        slo=slo,
        servers=tuple(ServerSpec(i) for i in range(n_servers)),
        events=[ClientArrival(0.0, qps / n_clients, count=n_clients)], **kw)


@register("flash-crowd")
def flash_crowd(*, duration: float = 45.0, seed: int = 0,
                app: str = "xapian", policy: str = "round_robin",
                base_qps: float = 600.0, peak_qps: float = 1800.0,
                burst_at: float = None, burst_len: float = None,
                slo: float = None, **kw) -> Scenario:
    """A viral traffic spike: 3x the offered load for a mid-run window
    (timing defaults scale with the duration override)."""
    burst_at = duration / 3 if burst_at is None else burst_at
    burst_len = duration / 4.5 if burst_len is None else burst_len
    return Scenario(
        name="flash-crowd", duration=duration, app=app, policy=policy,
        seed=seed, slo=slo,
        servers=(ServerSpec(0, workers=2), ServerSpec(1, workers=2)),
        events=[ClientArrival(0.0, base_qps / 3, count=3),
                FlashCrowd(burst_at, burst_len, peak_qps, clients=6)], **kw)


@register("diurnal-fleet")
def diurnal_fleet(*, duration: float = 60.0, seed: int = 0,
                  app: str = "xapian", policy: str = "jsq",
                  base_qps: float = 500.0, amplitude: float = 400.0,
                  period: float = None, slo: float = None, **kw) -> Scenario:
    """Day/night sinusoidal load with the fleet tracking it: two extra
    servers join for the daytime peak and drain for the night (one full
    day per run by default)."""
    period = duration if period is None else period
    return Scenario(
        name="diurnal-fleet", duration=duration, app=app, policy=policy,
        seed=seed, slo=slo,
        servers=(ServerSpec(0, workers=2), ServerSpec(1, workers=2)),
        events=[ClientArrival(0.0, DiurnalQPS(base_qps / 2, amplitude / 2,
                                              period=period), count=2),
                ServerJoin(period * 0.15, 2, workers=2),
                ServerJoin(period * 0.25, 3, workers=2),
                ServerDrain(period * 0.55, 2),
                ServerDrain(period * 0.65, 3)], **kw)


@register("server-failure")
def server_failure(*, duration: float = 45.0, seed: int = 0,
                   app: str = "xapian", policy: str = "jsq",
                   qps: float = 1200.0, fail_at: float = None,
                   recover_at: float = None, slo: float = None,
                   **kw) -> Scenario:
    """Fault injection: one of three servers dies mid-run (queued and
    in-flight requests lost, clients rebalance); a replacement joins."""
    fail_at = duration / 3 if fail_at is None else fail_at
    recover_at = duration * 2 / 3 if recover_at is None else recover_at
    return Scenario(
        name="server-failure", duration=duration, app=app, policy=policy,
        seed=seed, slo=slo,
        servers=tuple(ServerSpec(i) for i in range(3)),
        events=[ClientArrival(0.0, qps / 4, count=4),
                ServerFail(fail_at, 2),
                ServerJoin(recover_at, 3)], **kw)


@register("elastic-autoscale")
def elastic_autoscale(*, duration: float = 60.0, seed: int = 0,
                      app: str = "xapian", policy: str = "jsq",
                      slo: float = None, **kw) -> Scenario:
    """Load ramps 400 -> 1600 QPS and back; servers join as it rises and
    drain as it falls (the paper's elastic scale-out, as one scenario).
    All breakpoints scale with the duration override."""
    d = duration / 60.0
    half = PiecewiseQPS([(0, 200), (15 * d, 400), (25 * d, 800),
                         (40 * d, 400), (50 * d, 200)])   # per client, x2
    return Scenario(
        name="elastic-autoscale", duration=duration, app=app, policy=policy,
        seed=seed, slo=slo,
        servers=(ServerSpec(0, workers=2),),
        events=[ClientArrival(0.0, half, count=2),
                ServerJoin(14.0 * d, 1, workers=2),
                ServerJoin(24.0 * d, 2, workers=2),
                ServerDrain(42.0 * d, 2),
                ServerDrain(52.0 * d, 1)], **kw)


@register("batched-serving")
def batched_serving(*, duration: float = 30.0, seed: int = 0,
                    policy: str = "jsq", n_clients: int = 4,
                    qps: float = 150.0, n_servers: int = 2,
                    max_batch: int = 8, arch: str = None,
                    service=None, lengths=None, slo: float = None,
                    **kw) -> Scenario:
    """Continuous-batching inference fleet: BatchedService servers admit
    up to max_batch token-sized requests, per-step cost = max(compute,
    memory) from the roofline — throughput saturates sub-linearly with
    occupancy like the real engine, and the same scenario runs on the
    simulator, the batched stub engine or the real engines.  ``arch=``
    calibrates the service from that architecture's roofline on the
    H100's figures (``BatchedService.from_arch``)."""
    if service is None:
        service = (BatchedService.from_arch(arch) if arch
                   else default_batched_service())
    if lengths is None:
        # bounded maxima keep the real-engine backend's cache sizing
        # (prompt_max + new_max tokens) practical
        lengths = TokenLengths(prompt_max=512, new_max=128)
    return Scenario(
        name="batched-serving", duration=duration, policy=policy, seed=seed,
        slo=slo, service_model=service, lengths=lengths,
        servers=tuple(ServerSpec(i, max_batch=max_batch)
                      for i in range(n_servers)),
        events=[ClientArrival(0.0, qps / n_clients, count=n_clients)], **kw)


@register("churn-storm")
def churn_storm(*, duration: float = 40.0, seed: int = 0,
                app: str = "masstree", policy: str = "load_aware",
                arrival_rate: float = 4.0, hold_mean: float = 3.0,
                client_qps: float = 120.0, slo: float = None,
                **kw) -> Scenario:
    """Heavy connection churn: a Poisson storm of short-lived clients on
    top of a small steady base, plus a mid-run policy change and a late
    hedging experiment — the balancer lifecycle under stress."""
    return Scenario(
        name="churn-storm", duration=duration, app=app, policy=policy,
        seed=seed, slo=slo,
        servers=tuple(ServerSpec(i) for i in range(3)),
        events=[ClientArrival(0.0, 200.0, count=2),
                ClientChurn(duration * 0.05, duration * 0.875,
                            arrival_rate, hold_mean, client_qps),
                SetPolicy(duration / 2, "jsq"),
                SetHedge(duration * 0.75, 0.02)], **kw)
