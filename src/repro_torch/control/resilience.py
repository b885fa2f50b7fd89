"""Client-side resilience: timeouts, jittered retries, shedding, breaking.

The mechanics here follow the failure-handling literature the paper's
robustness scenarios reproduce ("Tell-Tale Tail Latencies", the AWS
backoff-and-jitter analysis): a timed-out request's server-side work is
NOT cancelled (it completes as a zombie and is discarded — wasted
capacity), naive immediate retries multiply offered load exactly when
the fleet is saturated (the metastable retry storm), and the cure is
exponential backoff with decorrelated jitter plus a retry *budget* that
caps the retry fraction of traffic.

All randomness is drawn from an injected ``numpy`` Generator the owning
runtime seeds with the domain tag ``(0xB0FF, seed, rep)`` — resilience
decisions never perturb the arrival/service RNG streams, and
repetitions draw independent jitter.

Copy of ``repro.control.resilience``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

#: RNG domain tag for resilience draws (jitter, probabilistic admission)
RESILIENCE_STREAM = 0xB0FF

JITTER_MODES = ("none", "full", "decorrelated")


@dataclass(frozen=True)
class RetryPolicy:
    """Per-request timeout + bounded retry declaration (hashable,
    sweepable, fingerprintable).

    ``jitter="none"`` is the naive exponential schedule every client
    fires in lockstep; ``"full"`` draws U(0, backoff); ``"decorrelated"``
    draws U(base, 3*previous) per the AWS analysis.  ``budget_ratio``
    caps issued retries at that fraction of primary requests (plus a
    small ``budget_burst`` so short runs can retry at all) — the knob
    that separates recovery from congestion collapse.
    """
    timeout: float = 1.0
    max_retries: int = 0
    backoff_base: float = 0.05
    backoff_cap: float = 2.0
    jitter: str = "full"
    budget_ratio: float = 0.1
    budget_burst: int = 10

    def __post_init__(self):
        if self.jitter not in JITTER_MODES:
            raise ValueError(f"unknown jitter mode {self.jitter!r}; "
                             f"known: {', '.join(JITTER_MODES)}")
        if self.timeout <= 0.0:
            raise ValueError("timeout must be positive")

    def delay(self, attempt: int, prev: float, rng) -> float:
        """Backoff before retry ``attempt`` (1-based).  ``prev`` is the
        previous delay (decorrelated jitter chains on it); ``rng`` is
        the runtime's resilience Generator."""
        cap = self.backoff_cap
        if self.jitter == "decorrelated":
            lo = self.backoff_base
            hi = max(3.0 * max(prev, lo), lo)
            return min(cap, lo + float(rng.random()) * (hi - lo))
        base = min(cap, self.backoff_base * (2.0 ** (attempt - 1)))
        if self.jitter == "full":
            return float(rng.random()) * base
        return base


class RetryBudget:
    """Caps retries at ``ratio`` x primary requests (+ ``burst``)."""

    def __init__(self, ratio: float, burst: int = 10):
        self.ratio = float(ratio)
        self.burst = int(burst)
        self.primaries = 0
        self.retries = 0

    def note_primary(self) -> None:
        self.primaries += 1

    def allow(self) -> bool:
        return self.retries < self.ratio * self.primaries + self.burst

    def note_retry(self) -> None:
        self.retries += 1


class AdmissionController:
    """Load shedding at the admission point: probabilistic (admit each
    request with probability ``admit``) or token-bucket (``rate``
    requests/sec with ``burst`` capacity).  Probabilistic decisions
    draw from the injected resilience RNG; the token bucket is
    RNG-free, so it sheds bit-identically on both event backends."""

    def __init__(self, admit: Optional[float] = None,
                 rate: Optional[float] = None, burst: float = 1.0):
        if admit is None and rate is None:
            raise ValueError("set_admission needs admit= or rate=")
        self.admit = 1.0 if admit is None else min(max(float(admit), 0.0), 1.0)
        self.rate = None if rate is None else float(rate)
        self.burst = float(burst)
        self._tokens = self.burst
        self._last_t: Optional[float] = None

    def allow(self, t: float, rng) -> bool:
        if self.rate is not None:
            if self._last_t is not None:
                self._tokens = min(self.burst,
                                   self._tokens + (t - self._last_t)
                                   * self.rate)
            self._last_t = t
            if self._tokens >= 1.0:
                self._tokens -= 1.0
            else:
                return False
        if self.admit >= 1.0:
            return True
        if self.admit <= 0.0:
            return False
        return float(rng.random()) < self.admit

    @property
    def level(self) -> float:
        """The probabilistic admit level (the AIMD shedder's state)."""
        return self.admit


@dataclass(frozen=True)
class BreakerSpec:
    """Per-server circuit breaker declaration: open when the failure
    fraction over the last ``window`` outcomes reaches ``threshold``
    (with at least ``min_samples`` observed), hold open ``cooldown``
    seconds, then half-open — one probe request decides."""
    window: int = 20
    threshold: float = 0.5
    cooldown: float = 5.0
    min_samples: int = 5


class CircuitBreaker:
    """Mutable per-server breaker state for one run."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, spec: BreakerSpec):
        self.spec = spec
        self._outcomes: dict[int, deque] = {}
        self._state: dict[int, str] = {}
        self._opened_at: dict[int, float] = {}

    def state(self, sid: int) -> str:
        return self._state.get(sid, self.CLOSED)

    def record(self, sid: int, ok: bool, now: float) -> None:
        st = self.state(sid)
        if st == self.HALF_OPEN:
            if ok:                       # probe succeeded: close + reset
                self._state[sid] = self.CLOSED
                self._outcomes.pop(sid, None)
            else:                        # probe failed: re-open
                self._state[sid] = self.OPEN
                self._opened_at[sid] = now
            return
        q = self._outcomes.get(sid)
        if q is None:
            q = self._outcomes[sid] = deque(maxlen=self.spec.window)
        q.append(ok)
        if st == self.CLOSED and len(q) >= self.spec.min_samples:
            bad = sum(1 for o in q if not o)
            if bad >= self.spec.threshold * len(q):
                self._state[sid] = self.OPEN
                self._opened_at[sid] = now

    def allow(self, sid: int, now: float) -> bool:
        st = self.state(sid)
        if st == self.CLOSED:
            return True
        if st == self.OPEN:
            if now - self._opened_at.get(sid, now) >= self.spec.cooldown:
                self._state[sid] = self.HALF_OPEN
                return True              # the probe request
            return False
        return False                     # half-open: probe already in flight
