"""QPS schedules and client configuration — the part of the TailBench++
client module the vector runtime reads.

Trimmed copy of ``repro.core.client``: the schedules keep ``rate`` and
their array form ``rate_array`` (what the vector compiler evaluates per
slot), and ``ClientConfig`` keeps what the vector compiler reads.  The
per-request arrival generators, and the per-client seed, profile and
token sizes they use, belong to the event engine and are not part of
this package.
"""
from __future__ import annotations

import math
from bisect import bisect_right
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


class QPSSchedule:
    def rate(self, t: float) -> float:
        raise NotImplementedError

    def rate_array(self, ts) -> np.ndarray:
        """Vectorized ``rate`` over an array of times.  Subclasses
        override with closed-form array math; this fallback loops."""
        return np.asarray([self.rate(float(t)) for t in np.asarray(ts)],
                          float)


@dataclass
class ConstantQPS(QPSSchedule):
    qps: float

    def rate(self, t: float) -> float:
        return self.qps

    def rate_array(self, ts) -> np.ndarray:
        return np.full(np.shape(ts), float(self.qps))


@dataclass
class PiecewiseQPS(QPSSchedule):
    """[(t_start, qps), ...] — e.g. the paper's Table 5:
    [(0,100),(10,300),(20,500),(30,600),(40,800),(50,100)].
    Times before the first breakpoint have rate 0."""
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


@dataclass
class TraceQPS(QPSSchedule):
    """Replay a recorded per-second QPS trace (uniform dt -> O(1) lookup).

    An empty trace has no defined rate: NaN, not an IndexError."""
    trace: Sequence[float]
    dt: float = 1.0

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


@dataclass
class ClientConfig:
    client_id: int
    schedule: QPSSchedule
    start_time: float = 0.0
    total_requests: Optional[int] = None   # None = run until end_time
    end_time: Optional[float] = None
