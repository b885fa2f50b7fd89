"""Workload generators — the TailBench++ client module.

Copy of ``repro.core.client`` without ``BatchedClientGenerator`` (the
simulator's opt-in fast path; the port has no simulator yet).

Feature 3 (independent client behavior): every client owns its start time,
request budget, and service-demand distribution.
Feature 4 (variable client load): ``QPSSchedule`` changes the arrival rate
during execution (piecewise-constant = the paper's Table 5; diurnal and
trace schedules model the cited real-world patterns).

Arrivals are open-loop Poisson (exponential inter-arrival at the current
rate) — TailBench's generator — with Zipf-like service demands preserved.
The vector compiler reads the schedules' ``rate_array`` and the
``ClientConfig`` fields; ``EngineRuntime`` draws arrivals one by one
from ``ClientGenerator``, with the reference's RNG streams.
"""
from __future__ import annotations

import math
from bisect import bisect_right
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# QPS schedules (Feature 4)
# ---------------------------------------------------------------------------
class QPSSchedule:
    def rate(self, t: float) -> float:
        raise NotImplementedError

    def rate_array(self, ts) -> np.ndarray:
        """Vectorized ``rate`` over an array of times — the same law
        evaluated as one array op, so the vector runtime can lay a whole
        sweep grid's arrival rates out structure-of-arrays.  Subclasses
        override with closed-form array math; this fallback loops."""
        return np.asarray([self.rate(float(t)) for t in np.asarray(ts)],
                          float)

    def next_change(self, t: float) -> Optional[float]:
        """Earliest time > t at which the rate may change.

        ``math.inf`` means the rate is constant from ``t`` on; ``None``
        means unknown (continuously varying) — callers must re-sample on
        the MAX_STEP grid.  Schedules with breakpoints override this so
        generators can skip zero-rate regions (e.g. night-time trace
        gaps) in one step instead of spinning through them."""
        return None


@dataclass
class ConstantQPS(QPSSchedule):
    qps: float

    def rate(self, t: float) -> float:
        return self.qps

    def rate_array(self, ts) -> np.ndarray:
        return np.full(np.shape(ts), float(self.qps))

    def next_change(self, t: float) -> float:
        return math.inf


@dataclass
class PiecewiseQPS(QPSSchedule):
    """[(t_start, qps), ...] — e.g. the paper's Table 5:
    [(0,100),(10,300),(20,500),(30,600),(40,800),(50,100)].

    Lookups are O(log n) via bisect over the (sorted) breakpoints — the
    generator re-samples the rate every MAX_STEP, so this sits on the
    arrival hot path.  Times before the first breakpoint have rate 0."""
    points: Sequence[tuple]

    def __post_init__(self):
        pts = sorted((float(t0), float(q)) for t0, q in self.points)
        self._ts = [t0 for t0, _ in pts]
        self._qs = [q for _, q in pts]

    def rate(self, t: float) -> float:
        i = bisect_right(self._ts, t) - 1
        return self._qs[i] if i >= 0 else 0.0

    def rate_array(self, ts) -> np.ndarray:
        idx = np.searchsorted(self._ts, np.asarray(ts, float),
                              side="right") - 1
        qs = np.concatenate([[0.0], self._qs])      # idx -1 -> rate 0
        return qs[idx + 1]

    def next_change(self, t: float) -> float:
        i = bisect_right(self._ts, t)
        return self._ts[i] if i < len(self._ts) else math.inf


@dataclass
class DiurnalQPS(QPSSchedule):
    """Sinusoidal day/night load (Atikoglu et al. diurnal pattern)."""
    base: float
    amplitude: float
    period: float = 60.0
    phase: float = 0.0

    def rate(self, t: float) -> float:
        return max(0.0, self.base + self.amplitude
                   * math.sin(2 * math.pi * (t + self.phase) / self.period))

    def rate_array(self, ts) -> np.ndarray:
        ts = np.asarray(ts, float)
        return np.maximum(0.0, self.base + self.amplitude * np.sin(
            2 * np.pi * (ts + self.phase) / self.period))

    def next_change(self, t: float) -> Optional[float]:
        """When ``amplitude >= base`` the clipped sinusoid bottoms out at
        zero for a whole sub-interval of each period; without this,
        generators spin through the trough at the MAX_STEP fallback.
        Inside a trough we return the exact zero-exit time (the rising
        crossing of ``sin = -base/amplitude``).  No RNG draws happen at
        zero rate, so only the resume instant moves (to the true
        crossing instead of an entry-dependent grid point); schedules
        that never clip (``amplitude < base``) are untouched.  Elsewhere
        the rate varies continuously: None keeps the grid re-sampling."""
        if self.amplitude == 0.0:
            return math.inf                       # constant rate forever
        if self.rate(t) > 0.0:
            return None
        # a negative amplitude is the same sinusoid half a period out of
        # phase: fold it into the positive-amplitude math
        amp, phase = self.amplitude, self.phase
        if amp < 0.0:
            amp, phase = -amp, phase + self.period / 2.0
        s0 = -self.base / amp                     # sin level of the clip
        if s0 > 1.0:
            return math.inf                       # rate is zero forever
        two_pi = 2.0 * math.pi
        theta = (two_pi * (t + phase) / self.period) % two_pi
        # zero region: sin(theta) <= s0, i.e. theta in
        # [pi - asin(s0), 2*pi + asin(s0)]; the exit is the upper edge
        theta_exit = two_pi + math.asin(max(min(s0, 1.0), -1.0))
        delta = (theta_exit - theta) % two_pi
        return t + delta * self.period / two_pi


@dataclass
class TraceQPS(QPSSchedule):
    """Replay a recorded per-second QPS trace (uniform dt -> O(1) lookup).

    An empty trace has no defined rate: NaN, not an IndexError."""
    trace: Sequence[float]
    dt: float = 1.0

    def __post_init__(self):
        # change-point indices (cells whose rate differs from their
        # predecessor), precomputed once: next_change is O(log changes)
        # instead of a linear rescan from the current cell — O(n^2) over
        # a long flat trace when the generator walks it breakpoint by
        # breakpoint
        self._changes = [j for j in range(1, len(self.trace))
                         if self.trace[j] != self.trace[j - 1]]

    def rate(self, t: float) -> float:
        if len(self.trace) == 0:
            return float("nan")
        i = min(int(t / self.dt), len(self.trace) - 1)
        return float(self.trace[max(i, 0)])

    def rate_array(self, ts) -> np.ndarray:
        ts = np.asarray(ts, float)
        if len(self.trace) == 0:
            return np.full(ts.shape, float("nan"))
        idx = np.clip((ts / self.dt).astype(np.int64), 0,
                      len(self.trace) - 1)
        return np.asarray(self.trace, float)[idx]

    def next_change(self, t: float) -> float:
        """Start time of the next cell whose rate differs from rate(t) —
        lets generators jump a whole idle night in one step."""
        n = len(self.trace)
        if n == 0:
            return math.inf
        i = max(min(int(t / self.dt), n - 1), 0)
        # cells between two change points share one rate, so the first
        # change index > i is exactly the next differing cell
        k = bisect_right(self._changes, i)
        if k >= len(self._changes):
            return math.inf
        return self._changes[k] * self.dt


# ---------------------------------------------------------------------------
# Client configuration (Features 3 + 4)
# ---------------------------------------------------------------------------
@dataclass
class ClientConfig:
    client_id: int
    schedule: QPSSchedule
    start_time: float = 0.0
    total_requests: Optional[int] = None   # None = run until end_time
    end_time: Optional[float] = None
    seed: int = 0
    # service-demand distribution (overridden by the app profile if None)
    profile: Optional[object] = None
    # per-request token sizes (TokenLengths); None = unsized requests
    lengths: Optional[object] = None


# domain-separation salt for the size-RNG stream: request sizes must not
# perturb the arrival-time draws (bit-compatibility of unsized configs)
_SIZE_STREAM = 0x512E


class ClientGenerator:
    """Open-loop arrival process for one client.

    When a ``TokenLengths`` distribution is configured (``cfg.lengths``
    or the harness default), every arrival also samples
    ``(prompt_tokens, max_new_tokens)`` into ``last_sizes`` — from a
    *separate* RNG stream keyed by the same (seed, client_id, rep), so
    both runtime backends see identical sizes and unsized runs keep
    bit-identical arrival draws."""

    def __init__(self, cfg: ClientConfig, profile, rng_stream: int = 0,
                 lengths=None):
        self.cfg = cfg
        self.profile = cfg.profile or profile
        self.rng = np.random.default_rng((cfg.seed, cfg.client_id, rng_stream))
        self.t = cfg.start_time
        self.sent = 0
        self.lengths = cfg.lengths if cfg.lengths is not None else lengths
        self.last_sizes: tuple = (0, 0)     # (prompt_tokens, max_new_tokens)
        if self.lengths is not None:
            self._size_rng = np.random.default_rng(
                (cfg.seed, cfg.client_id, rng_stream, _SIZE_STREAM))
            self._sample_sizes = self.lengths.sample
        else:
            self._sample_sizes = None
        # hot-path bindings (next_arrival runs once per generated request)
        self._budget = math.inf if cfg.total_requests is None else cfg.total_requests
        self._end = math.inf if cfg.end_time is None else cfg.end_time
        self._rate = cfg.schedule.rate
        self._next_change = cfg.schedule.next_change
        self._draw = self.rng.exponential
        self._sample = self.profile.sample

    def exhausted(self, t: Optional[float] = None) -> bool:
        if self.sent >= self._budget:
            return True
        # explicit None check: t == 0.0 is a real timestamp, not "unset"
        return (self.t if t is None else t) >= self._end

    MAX_STEP = 0.25  # re-sample the rate at least this often (seconds)

    def next_arrival(self) -> Optional[tuple]:
        """-> (time, service_demand) of the next request, or None if done.

        Exponential memorylessness: if the drawn gap crosses a re-sampling
        boundary we advance to the boundary and redraw at the new rate —
        statistically exact for piecewise-constant schedules.
        """
        t = self.t
        budget, end, step = self._budget, self._end, self.MAX_STEP
        if self.sent >= budget or t >= end:
            return None
        while True:
            rate = self._rate(t)
            if rate != rate:       # NaN (e.g. empty TraceQPS): no defined
                self.t = t         # rate, treat the client as exhausted —
                return None        # NaN would slip past the <= 0 guard
            if rate <= 0:
                # skip dead air: jump straight to the schedule's next
                # breakpoint instead of spinning in MAX_STEP increments
                # (no RNG draws happen at zero rate, so skipping is exact)
                nc = self._next_change(t)
                if nc is None:              # continuous schedule: re-sample
                    t += step               # on the grid as before
                elif nc == math.inf:        # zero rate forever -> done
                    self.t = t
                    return None
                else:
                    t = max(nc, t + 1e-12)  # breakpoints are > t by contract
                if t >= end:
                    self.t = t
                    return None
                continue
            gap = self._draw(1.0 / rate)
            # never step across a grid boundary: memorylessness makes
            # redrawing at the boundary exact for piecewise-constant rates
            next_grid = (math.floor(t / step) + 1.0) * step
            if t + gap >= next_grid:
                t = next_grid
                if t >= end:
                    self.t = t
                    return None
                continue
            t += gap
            self.t = t
            if t >= end:
                return None
            self.sent += 1
            if self._sample_sizes is not None:
                self.last_sizes = self._sample_sizes(self._size_rng)
            return t, self._sample(self.rng)
