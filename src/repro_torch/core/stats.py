"""Latency statistics: summaries, per-interval frames, the recorder.

Trimmed copy of ``repro.core.stats``: the partition quantiles (without
the reference's plan memo, which never changes a result), the
SLO-violation fraction, ``Summary`` and ``IntervalFrame`` (what the
vector telemetry reads), and the per-request ``LatencyRecorder`` (exact
mode) with the ``MetricsPipeline`` over it (what ``EngineRuntime``
publishes through).  Welch's t-test and the streaming estimators are
not ported yet.
"""
from __future__ import annotations

from collections import defaultdict
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

    @classmethod
    def of(cls, xs) -> "Summary":
        xs = _as_float_array(xs)
        if xs.size == 0:
            return cls.empty()
        p50, p95, p99 = np.percentile(xs, (50, 95, 99))
        return cls(int(xs.size), float(xs.mean()),
                   float(p50), float(p95), float(p99))


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


# ---------------------------------------------------------------------------
# Latency recorder and metrics pipeline (EngineRuntime's telemetry)
# ---------------------------------------------------------------------------
class LatencyRecorder:
    """Streams completed requests into per-client / per-interval buckets.

    Keeps every raw sample (the reference's ``mode="exact"``, which every
    figure script uses).  The reference's bounded ``"streaming"`` mode
    (P² markers and reservoirs) is not ported yet.
    """

    def __init__(self, interval: float = 1.0, mode: str = "exact"):
        if mode == "streaming":
            raise NotImplementedError("the streaming recorder is not ported "
                                      "yet")
        if mode != "exact":
            raise ValueError(f"unknown recorder mode: {mode!r}")
        self.interval = interval
        self.mode = mode
        # disposition accounting: requests that ended
        # WITHOUT a latency sample — shed at admission, timed out, or
        # destroyed by a failure — are first-class rows here, never
        # silently absent from the statistics.  Plain counters: O(1)
        # memory, zero cost on the record() hot path.
        self.failures = {"shed": 0, "timeout": 0, "failed": 0}
        self.fail_by_ivl: dict[int, dict] = {}
        self.by_client: dict[int, list] = defaultdict(list)
        self.by_cell: dict[tuple, list] = defaultdict(list)  # (client, ivl)
        self.all: list[float] = []
        self.queue_times: list[float] = []
        self.service_times: list[float] = []

    def record(self, req) -> None:
        # inlined req.sojourn/queue_time/service_time: every recorded
        # request has all timestamps set, and this sits on the hot path
        completed = req.completed
        started = req.started
        lat = completed - req.created
        cid = req.client_id
        self.by_client[cid].append(lat)
        self.by_cell[(cid, int(completed / self.interval))].append(lat)
        self.all.append(lat)
        self.queue_times.append(started - req.enqueued)
        self.service_times.append(completed - started)

    # ------- dispositions ---------------------------------------------------
    def record_failure(self, t: float, disposition: str) -> None:
        """Account one request that will never complete: ``"shed"``
        (admission control refused it), ``"timeout"`` (the client gave
        up; retries exhausted or budget-denied), or ``"failed"`` (lost
        to a server failure).  ``t`` is the disposition time — the
        request counts against that interval's SLO fraction."""
        if disposition not in self.failures:
            raise ValueError(f"unknown disposition {disposition!r}; "
                             f"known: {', '.join(self.failures)}")
        self.failures[disposition] += 1
        ivl = int(t / self.interval)
        cell = self.fail_by_ivl.get(ivl)
        if cell is None:
            cell = self.fail_by_ivl[ivl] = \
                {"shed": 0, "timeout": 0, "failed": 0}
        cell[disposition] += 1

    def failed_total(self) -> int:
        return (self.failures["shed"] + self.failures["timeout"]
                + self.failures["failed"])

    # ------- summaries ------------------------------------------------------
    def overall(self) -> Summary:
        return Summary.of(self.all)

    def client(self, cid: int) -> Summary:
        return Summary.of(self.by_client.get(cid, []))

    def intervals(self, cid: Optional[int] = None) -> dict[int, Summary]:
        out: dict[int, list] = defaultdict(list)
        for (c, ivl), xs in self.by_cell.items():
            if cid is None or c == cid:
                out[ivl].extend(xs)
        return {ivl: Summary.of(xs) for ivl, xs in sorted(out.items())}

    def clients(self) -> list[int]:
        return sorted(self.by_client)


class MetricsPipeline:
    """Time-series telemetry over a ``LatencyRecorder``.

    Both runtimes (virtual-time ``Simulator`` and wall-clock
    ``EngineRuntime``) publish through this one interface:

    * latency summaries delegate verbatim to the underlying recorder, so
      consumers that switch from ``sim.recorder.X`` to ``sim.telemetry.X``
      see bit-identical numbers (the figure scripts rely on this);
    * per-server gauges (utilization, queue depth) are sampled by the
      runtime at interval boundaries via ``sample_servers``;
    * ``frames()`` joins both into per-interval ``IntervalFrame`` rows
      (served QPS, windowed percentiles, SLO-violation fraction).

    The per-interval percentiles and SLO fractions are computed from the
    recorder's raw per-cell latency lists.
    """

    def __init__(self, recorder: "LatencyRecorder", interval: float = 1.0,
                 slo: Optional[float] = None):
        self.recorder = recorder
        self.interval = interval
        self.slo = slo
        # ivl -> server_id -> (util, queue_depth, occupancy, tokens/sec),
        # sampled at the *end* of each interval by the owning runtime
        self._gauges: dict[int, dict[int, tuple]] = {}
        self._busy_time: dict[int, float] = {}      # last busy_time reading
        self._tokens: dict[int, float] = {}         # last tokens_done reading
        # memoization: frames()/series()/window() rebuild the full
        # interval aggregation; windowed consumers (fig6/7-style sweeps)
        # call them once per window.  Caches are keyed on a revision —
        # recorded-sample count plus a gauge version — so any record()
        # or sample_servers() invalidates them without touching the
        # recorder's hot path (counts are O(1) reads, not write hooks).
        self._gauge_ver = 0
        self._series_cache: dict = {}               # cid -> (rev, series)
        self._frames_cache: Optional[tuple] = None  # (rev, frames)

    def _rev(self) -> tuple:
        rec = self.recorder
        return len(rec.all), rec.failed_total(), self._gauge_ver

    # ---- runtime-facing ----------------------------------------------------
    def sample_servers(self, t: float, servers) -> None:
        """Record per-server gauges at time ``t`` (an interval boundary).

        ``servers`` is any iterable of objects with ``server_id``,
        ``workers``/``max_batch`` capacity, and busy/queue accounting
        (``SimServer`` and the engine-runtime server handles both fit).
        Servers exposing a cumulative ``busy_time`` get time-averaged
        utilization over the interval; otherwise the instantaneous
        busy-worker fraction at the sample point is used.
        """
        ivl = int(round(t / self.interval)) - 1     # gauge closes interval t-1
        snap = {}
        for s in servers:
            # capacity: ``workers`` when the server declares worker slots
            # (0 is a real answer — zero capacity, not "ask max_batch"),
            # else ``max_batch`` for batch-slot servers, else 1
            cap = getattr(s, "workers", None)
            if cap is None:
                cap = getattr(s, "max_batch", None)
            if cap is None:
                cap = 1
            busy = s.busy if hasattr(s, "busy") else s.load()
            toks = getattr(s, "tokens_done", None)
            bt = getattr(s, "busy_time", None)
            # servers declaring ``serializes_ops`` run one op at a time
            # (the continuous-batching serve loop), so busy_time
            # normalizes per server; otherwise busy_time accrues across
            # ``cap`` parallel slots.  Declared explicitly — a token
            # counter's presence says nothing about scheduling semantics.
            util_cap = 1 if getattr(s, "serializes_ops", False) else cap
            if bt is not None and util_cap:
                delta = bt - self._busy_time.get(s.server_id, 0.0)
                self._busy_time[s.server_id] = bt
                util = min(max(delta / (self.interval * util_cap), 0.0), 1.0)
            else:
                util = min(busy / util_cap, 1.0) if util_cap else 0.0
            occ = min(busy / cap, 1.0) if cap else 0.0
            if toks is None:
                rate = None
            else:
                rate = (toks - self._tokens.get(s.server_id, 0.0)) \
                    / self.interval
                self._tokens[s.server_id] = toks
            snap[s.server_id] = (util, max(s.load() - busy, 0), occ, rate)
        self._gauges[ivl] = snap
        self._gauge_ver += 1

    # ---- latency accessors (bit-compatible with the recorder) --------------
    def overall(self) -> Summary:
        return self.recorder.overall()

    def client(self, cid: int) -> Summary:
        return self.recorder.client(cid)

    def clients(self) -> list:
        return self.recorder.clients()

    def series(self, cid: Optional[int] = None) -> dict:
        """Per-interval latency summaries (delegates to the recorder;
        memoized until the next recorded sample)."""
        rev = self._rev()[0]
        hit = self._series_cache.get(cid)
        if hit is not None and hit[0] == rev:
            return hit[1]
        out = self.recorder.intervals(cid)
        self._series_cache[cid] = (rev, out)
        return out

    def window(self, metric: str, lo: int = 0, hi: Optional[int] = None,
               cid: Optional[int] = None) -> list:
        """Raw per-interval values of ``metric`` over [lo, hi) — the
        building block the figure scripts' window statistics use."""
        return [getattr(s, metric) for t, s in self.series(cid).items()
                if t >= lo and (hi is None or t < hi)]

    # ---- time series -------------------------------------------------------
    def _interval_samples(self) -> dict[int, list]:
        out: dict[int, list] = defaultdict(list)
        for (c, ivl), xs in self.recorder.by_cell.items():
            out[ivl].extend(xs)
        return out

    def frames(self) -> list[IntervalFrame]:
        rev = self._rev()
        if self._frames_cache is not None and self._frames_cache[0] == rev:
            return self._frames_cache[1]
        samples = self._interval_samples()
        series = self.series()
        fails = self.recorder.fail_by_ivl
        ivls = sorted(set(series) | set(self._gauges) | set(fails))
        frames = []
        for ivl in ivls:
            s = series.get(ivl)
            xs = samples.get(ivl, [])
            cell = fails.get(ivl, {})
            n_bad = sum(cell.values())
            viol = slo_violation_frac(xs, self.slo, n_bad=n_bad)
            gauges = self._gauges.get(ivl, {})
            util = {sid: g[0] for sid, g in gauges.items()}
            qdepth = {sid: g[1] for sid, g in gauges.items()}
            occupancy = {sid: g[2] for sid, g in gauges.items()}
            tokens = {sid: g[3] for sid, g in gauges.items()
                      if g[3] is not None}
            if s is None:
                s = Summary.empty()
            frames.append(IntervalFrame(
                t=ivl, n=s.n, qps=s.n / self.interval, mean=s.mean,
                p50=s.p50, p95=s.p95, p99=s.p99, slo_violation_frac=viol,
                util=util, qdepth=qdepth, occupancy=occupancy,
                tokens_per_sec=tokens, n_shed=cell.get("shed", 0),
                n_timeout=cell.get("timeout", 0),
                n_failed=cell.get("failed", 0)))
        self._frames_cache = (rev, frames)
        return frames

    def to_rows(self) -> list[dict]:
        """Flat dict rows (CSV-friendly) of the interval time series."""
        rows = []
        for f in self.frames():
            mean_util = (sum(f.util.values()) / len(f.util)
                         if f.util else float("nan"))
            mean_occ = (sum(f.occupancy.values()) / len(f.occupancy)
                        if f.occupancy else float("nan"))
            rows.append({"t": f.t, "n": f.n, "qps": f.qps,
                         "mean_ms": f.mean * 1e3, "p50_ms": f.p50 * 1e3,
                         "p95_ms": f.p95 * 1e3, "p99_ms": f.p99 * 1e3,
                         "slo_violation_frac": f.slo_violation_frac,
                         "n_shed": f.n_shed, "n_timeout": f.n_timeout,
                         "n_failed": f.n_failed,
                         "mean_util": mean_util,
                         "mean_occupancy": mean_occ,
                         "tokens_per_sec": sum(f.tokens_per_sec.values()),
                         "total_qdepth": sum(f.qdepth.values())
                                         if f.qdepth else 0})
        return rows
