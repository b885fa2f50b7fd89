"""Latency summaries and per-interval frames the vector telemetry reads.

Trimmed copy of ``repro.core.stats``: the partition quantiles (without
the reference's plan memo, which never changes a result), the
SLO-violation fraction, ``Summary`` and ``IntervalFrame``.  The
per-request recorder and metrics pipeline belong to the event engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def _as_float_array(xs) -> np.ndarray:
    """Float ndarray view of a sample collection."""
    if not isinstance(xs, (np.ndarray, list, tuple)):
        xs = list(xs)
    return np.asarray(xs, float)


def quantiles_partition(xs, qs) -> np.ndarray:
    """``np.percentile``-style linear-interpolation quantiles via ONE
    ``np.partition`` pass over the floor/ceil order statistics."""
    xs = np.asarray(xs, float)
    n = xs.size
    if n == 0:
        return np.full(np.asarray(qs, float).shape, float("nan"))
    pos = np.asarray(qs, float) / 100.0 * (n - 1)
    lo = np.floor(pos).astype(np.intp)
    hi = np.ceil(pos).astype(np.intp)
    t = pos - lo
    part = np.partition(xs, np.unique(np.concatenate([lo, hi])))
    a, b = part[lo], part[hi]
    # numpy's lerp: anchor on the nearer endpoint for t >= 0.5
    out = a + (b - a) * t
    flip = t >= 0.5
    out[flip] = b[flip] - (b[flip] - a[flip]) * (1.0 - t[flip])
    return out


def slo_violation_frac(xs, slo: Optional[float], n_bad: int = 0) -> float:
    """Fraction of requests violating ``slo``.  ``n_bad`` counts
    requests that never produced a latency sample (shed, timed out,
    failed), each of which is a violation.  No SLO, or no samples and
    no failures -> NaN."""
    if slo is None or (len(xs) == 0 and n_bad == 0):
        return float("nan")
    if len(xs) == 0:
        return 1.0
    xs = _as_float_array(xs)
    return (float(np.count_nonzero(xs > slo)) + n_bad) / (xs.size + n_bad)


@dataclass
class Summary:
    n: int
    mean: float
    p50: float
    p95: float
    p99: float

    @classmethod
    def empty(cls) -> "Summary":
        """The one empty-input summary every code path shares."""
        return cls(0, *(float("nan"),) * 4)


@dataclass
class IntervalFrame:
    """One interval of the run's time series."""
    t: int                          # interval index (t*interval .. (t+1)*interval)
    n: int                          # requests completed in the interval
    qps: float                      # served throughput (n / interval)
    mean: float
    p50: float
    p95: float
    p99: float
    slo_violation_frac: float       # fraction of latencies > slo (nan: no SLO)
    util: dict                      # server_id -> utilization
    qdepth: dict                    # server_id -> queued requests (sampled)
    occupancy: dict                 # server_id -> resident-batch fraction
    # server_id -> generated tokens/sec; only batched servers appear here
    tokens_per_sec: dict
    # requests that ended this interval WITHOUT a latency sample
    n_shed: int = 0
    n_timeout: int = 0
    n_failed: int = 0
