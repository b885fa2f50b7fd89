"""Chaos scenarios: correlated failures, gray failure, retry storms,
and closed-loop autoscaling under a flash crowd.

These extend the canonical registry with the failure modes that
resilience machinery exists for (the "Metastable Failures in
Distributed Systems" playbook): a retry storm that keeps a fleet
saturated after the original overload has passed, a rack-level
correlated failure, a gray-failing server that is slow but not dead,
and a reactive controller riding out a flash crowd on a standby pool.
All are deterministic functions of their seed.  Copy of
``repro.scenarios.chaos``: every one runs on the ``sim`` backend and on
the engine backend (stub or real replicas); on the vector runtime
retries and circuit breaking are recorded as ``unsupported`` and the
controller runs as the compiler's fluid pre-pass.
"""
from __future__ import annotations

from repro_torch.control import BreakerSpec, ControlSpec, RetryPolicy
from repro_torch.core.harness import ServerSpec
from repro_torch.core.scenario import (ClientArrival, CorrelatedFailure,
                                       FlashCrowd, Scenario, ServerJoin,
                                       ServerSlowdown)
from repro_torch.scenarios import register


@register("retry-storm")
def retry_storm(*, duration: float = 30.0, seed: int = 0,
                app: str = "xapian", policy: str = "jsq",
                qps: float = 1400.0, burst_qps: float = 2800.0,
                mode: str = "naive", timeout: float = 0.25,
                max_retries: int = 3, burst_at: float = None,
                burst_len: float = None, slo: float = 0.25,
                **kw) -> Scenario:
    """A transient overload burst under aggressive client timeouts.

    ``mode="naive"`` retries immediately with no jitter and no budget —
    every timeout adds offered load while the server still holds the
    zombie request, the classic metastable feedback loop.
    ``mode="backoff"`` uses capped exponential backoff with
    decorrelated jitter and a 10% retry budget; the same trigger then
    drains instead of amplifying.  The trigger is a flash-crowd burst
    (not a slowdown) so the storm reproduces on every backend.
    """
    if mode == "naive":
        retry = RetryPolicy(timeout=timeout, max_retries=max_retries,
                            backoff_base=0.0, backoff_cap=0.0,
                            jitter="none", budget_ratio=1.0,
                            budget_burst=10 ** 9)
    elif mode == "backoff":
        retry = RetryPolicy(timeout=timeout, max_retries=max_retries,
                            backoff_base=0.05, backoff_cap=1.0,
                            jitter="decorrelated", budget_ratio=0.1,
                            budget_burst=20)
    else:
        raise ValueError(f"unknown retry-storm mode {mode!r} "
                         f"(naive | backoff)")
    burst_at = duration / 3 if burst_at is None else burst_at
    burst_len = duration / 6 if burst_len is None else burst_len
    return Scenario(
        name="retry-storm", duration=duration, app=app, policy=policy,
        seed=seed, slo=slo, retry=retry,
        servers=(ServerSpec(0, workers=2), ServerSpec(1, workers=2)),
        events=[ClientArrival(0.0, qps / 4, count=4),
                FlashCrowd(burst_at, burst_len, burst_qps,
                           clients=4)], **kw)


@register("correlated-failure")
def correlated_failure(*, duration: float = 40.0, seed: int = 0,
                       app: str = "xapian", policy: str = "jsq",
                       qps: float = 1200.0, fail_at: float = None,
                       recover_at: float = None, slo: float = 0.25,
                       **kw) -> Scenario:
    """Shared-rack failure: two of four servers die at the SAME instant
    (lowered to same-timestamp injections, applied in declaration
    order), then rejoin later as replacements."""
    fail_at = duration / 3 if fail_at is None else fail_at
    recover_at = duration * 2 / 3 if recover_at is None else recover_at
    return Scenario(
        name="correlated-failure", duration=duration, app=app,
        policy=policy, seed=seed, slo=slo,
        servers=tuple(ServerSpec(i) for i in range(4)),
        events=[ClientArrival(0.0, qps / 4, count=4),
                CorrelatedFailure(fail_at, (2, 3)),
                ServerJoin(recover_at, 4),
                ServerJoin(recover_at, 5)], **kw)


@register("gray-failure")
def gray_failure(*, duration: float = 30.0, seed: int = 0,
                 app: str = "xapian", policy: str = "round_robin",
                 qps: float = 900.0, factor: float = 20.0,
                 slow_at: float = None, slow_len: float = None,
                 breaker: bool = False, slo: float = 0.25,
                 **kw) -> Scenario:
    """Gray failure ("Gray Failure: The Achilles' Heel of Cloud-Scale
    Systems"): a server turns pathologically slow but keeps accepting —
    health checks pass, tails explode.  With ``breaker=True`` a
    timeout + circuit breaker pair detects it from the client side and
    routes around it.  Round-robin balancing by default — a
    queue-aware policy (jsq) would mask the gray server on its own,
    which is exactly the contrast worth measuring."""
    slow_at = duration / 3 if slow_at is None else slow_at
    slow_len = duration / 3 if slow_len is None else slow_len
    retry = (RetryPolicy(timeout=0.3, max_retries=1, backoff_base=0.02,
                         backoff_cap=0.2, jitter="full",
                         budget_ratio=0.2, budget_burst=10)
             if breaker else None)
    brk = (BreakerSpec(window=20, threshold=0.5, cooldown=3.0,
                       min_samples=5) if breaker else None)
    return Scenario(
        name="gray-failure", duration=duration, app=app, policy=policy,
        seed=seed, slo=slo, retry=retry, breaker=brk,
        servers=tuple(ServerSpec(i) for i in range(3)),
        events=[ClientArrival(0.0, qps / 3, count=3),
                ServerSlowdown(slow_at, 2, factor,
                               until=slow_at + slow_len)], **kw)


@register("flash-crowd-autoscale")
def flash_crowd_autoscale(*, duration: float = 45.0, seed: int = 0,
                          app: str = "xapian", policy: str = "jsq",
                          base_qps: float = 600.0,
                          peak_qps: float = 2400.0,
                          controller: str = "threshold_autoscaler",
                          interval: float = 1.0, lag: float = 2.0,
                          cooldown: float = 4.0, slo: float = 0.25,
                          **kw) -> Scenario:
    """The flash-crowd spike with a closed loop on top: 2 active + 4
    standby servers and a reactive controller (autoscaler by default,
    ``controller="admission_shedder"`` for brownout-style shedding)
    observing windowed telemetry and actuating with lag + cooldown."""
    if controller == "threshold_autoscaler":
        ctrl = ControlSpec.make("threshold_autoscaler", interval=interval,
                                lag=lag, cooldown=cooldown,
                                high=0.85, low=0.35, metric="util",
                                min_servers=2, max_servers=6)
    elif controller == "admission_shedder":
        ctrl = ControlSpec.make("admission_shedder", interval=interval,
                                lag=lag, cooldown=cooldown,
                                target_qdepth=8.0)
    else:
        raise ValueError(f"unknown controller {controller!r} "
                         f"(threshold_autoscaler | admission_shedder)")
    burst_at, burst_len = duration / 3, duration / 4.5
    servers = tuple(ServerSpec(i, workers=2) for i in range(2)) + \
        tuple(ServerSpec(i, workers=2, standby=True) for i in range(2, 6))
    return Scenario(
        name="flash-crowd-autoscale", duration=duration, app=app,
        policy=policy, seed=seed, slo=slo, control=ctrl, servers=servers,
        events=[ClientArrival(0.0, base_qps / 3, count=3),
                FlashCrowd(burst_at, burst_len, peak_qps, clients=6)], **kw)
