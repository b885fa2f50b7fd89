"""Latency statistics: percentile recorder + Welch's t-test (no scipy).

Copy of ``repro.core.stats`` without the reference's order-statistic
plan memo (it never changes a result).

The recorder groups completed-request latencies per (client, interval)
and produces the paper's metrics: mean / p95 / p99 per interval and per
client, with 95% confidence intervals across repetitions (Figs. 5-7).
Welch's t-test (Table 4) validates that harness changes don't perturb
application behavior; the t CDF uses the regularized incomplete beta
function (continued fraction, Numerical-Recipes style).

Two recorder modes:

* ``exact`` (default) — keeps every latency sample, percentiles via
  ``np.percentile``.  All the figure scripts use it.
* ``streaming`` — O(1) memory per stream: P² quantile markers
  (Jain & Chlamtac 1985) for the overall p50/p95/p99 plus bounded
  reservoir samples per client / interval / (client, interval) cell,
  the reservoirs drawing from one RNG keyed ``(0x5EED, seed, rep)``.
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Welch's t-test
# ---------------------------------------------------------------------------
def _betacf(a: float, b: float, x: float) -> float:
    MAXIT, EPS, FPMIN = 200, 3e-9, 1e-30
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c, d = 1.0, 1.0 - qab * x / qap
    if abs(d) < FPMIN:
        d = FPMIN
    d = 1.0 / d
    h = d
    for m in range(1, MAXIT + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < EPS:
            break
    return h


def _betai(a: float, b: float, x: float) -> float:
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_bt = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
             + a * math.log(x) + b * math.log(1.0 - x))
    bt = math.exp(ln_bt)
    if x < (a + 1.0) / (a + b + 2.0):
        return bt * _betacf(a, b, x) / a
    return 1.0 - bt * _betacf(b, a, 1.0 - x) / b


def t_sf(t: float, df: float) -> float:
    """Two-sided survival P(|T| >= t) for Student's t."""
    if not (df > 0.0) or math.isnan(t):
        return float("nan")
    x = df / (df + t * t)
    return _betai(df / 2.0, 0.5, x)


@dataclass
class WelchResult:
    t_stat: float
    p_value: float
    df: float

    @property
    def significant(self) -> bool:
        return self.p_value < 0.05


def welch_ttest(a: Iterable[float], b: Iterable[float]) -> WelchResult:
    """Welch's unequal-variance t-test.

    Degenerate inputs return NaN statistics instead of raising or
    producing garbage: fewer than two samples on either side leaves the
    variance undefined, and two zero-variance samples make the t statistic
    0 (equal means) or ±inf (different means) with an exact p-value.
    """
    a, b = np.asarray(list(a), float), np.asarray(list(b), float)
    na, nb = len(a), len(b)
    if na < 2 or nb < 2:
        return WelchResult(float("nan"), float("nan"), float("nan"))
    va, vb = a.var(ddof=1) / na, b.var(ddof=1) / nb
    diff = float(a.mean() - b.mean())
    if va + vb == 0.0:
        if diff == 0.0:
            return WelchResult(0.0, 1.0, float(na + nb - 2))
        return WelchResult(math.copysign(float("inf"), diff), 0.0,
                           float(na + nb - 2))
    denom = math.sqrt(va + vb)
    t = diff / denom
    df = (va + vb) ** 2 / max(va ** 2 / (na - 1) + vb ** 2 / (nb - 1), 1e-300)
    return WelchResult(t, t_sf(abs(t), df), df)


# ---------------------------------------------------------------------------
# Streaming estimators (P² + reservoir)
# ---------------------------------------------------------------------------
class P2Quantile:
    """Jain & Chlamtac's P² single-quantile estimator: five markers,
    O(1) memory, piecewise-parabolic height adjustment per observation."""

    __slots__ = ("q", "n", "_h", "_pos", "_want", "_dwant")

    def __init__(self, q: float):
        self.q = q
        self.n = 0
        self._h: list[float] = []            # marker heights
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._want = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
        self._dwant = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def add(self, x: float) -> None:
        self.n += 1
        h = self._h
        if self.n <= 5:
            h.append(x)
            if self.n == 5:
                h.sort()
            return
        pos, want, dwant = self._pos, self._want, self._dwant
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            want[i] += dwant[i]
        for i in (1, 2, 3):
            d = want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
               (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                # piecewise-parabolic prediction
                hp = h[i] + d / (pos[i + 1] - pos[i - 1]) * (
                    (pos[i] - pos[i - 1] + d) * (h[i + 1] - h[i])
                    / (pos[i + 1] - pos[i])
                    + (pos[i + 1] - pos[i] - d) * (h[i] - h[i - 1])
                    / (pos[i] - pos[i - 1]))
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:                         # fall back to linear
                    j = i + (1 if d > 0 else -1)
                    h[i] = h[i] + d * (h[j] - h[i]) / (pos[j] - pos[i])
                pos[i] += d

    def value(self) -> float:
        if self.n == 0:
            return float("nan")
        if self.n <= 5:
            return float(np.percentile(np.asarray(self._h, float),
                                       self.q * 100.0))
        return self._h[2]


class ReservoirSample:
    """Vitter's Algorithm R: uniform fixed-size sample of an unbounded
    stream.  Exact (holds everything) while n <= k.

    ``rand`` lets many reservoirs share one RNG: a private generator per
    reservoir carries its own state block, which dominates memory when a
    recorder holds one reservoir per (client, interval) cell.  The
    default stream is a seeded ``np.random.Generator`` keyed by a
    domain tag so it can never collide with the simulation's own
    ``(seed, entity_id, rep)`` streams."""

    __slots__ = ("k", "n", "data", "_rand")

    def __init__(self, k: int = 256, seed: int = 0x5EED, rand=None):
        self.k = k
        self.n = 0
        self.data: list[float] = []
        self._rand = rand if rand is not None else \
            np.random.default_rng((0x512E, int(seed))).random

    def add(self, x: float) -> None:
        n = self.n = self.n + 1
        if n <= self.k:
            self.data.append(x)
        else:
            j = int(self._rand() * n)
            if j < self.k:
                self.data[j] = x


class StreamingStat:
    """Bounded-memory latency stream: count/mean exactly, percentiles via
    P² (when enabled) with a reservoir fallback that is exact for small n."""

    __slots__ = ("n", "total", "res", "p2")

    def __init__(self, reservoir_k: int = 256, use_p2: bool = False,
                 seed: int = 0x5EED, rand=None):
        self.n = 0
        self.total = 0.0
        self.res = ReservoirSample(reservoir_k, seed, rand=rand)
        self.p2 = (P2Quantile(0.50), P2Quantile(0.95), P2Quantile(0.99)) \
            if use_p2 else None

    def add(self, x: float) -> None:
        self.n += 1
        self.total += x
        self.res.add(x)
        if self.p2 is not None:
            p50, p95, p99 = self.p2
            p50.add(x)
            p95.add(x)
            p99.add(x)

    def summary(self) -> "Summary":
        if self.n == 0:
            return Summary.empty()
        mean = self.total / self.n
        if self.p2 is not None and self.n > self.res.k:
            return Summary(self.n, mean, self.p2[0].value(),
                           self.p2[1].value(), self.p2[2].value())
        xs = np.asarray(self.res.data, float)
        p50, p95, p99 = np.percentile(xs, (50, 95, 99))
        return Summary(self.n, mean, float(p50), float(p95), float(p99))


# ---------------------------------------------------------------------------
# Latency recorder
# ---------------------------------------------------------------------------
def _as_float_array(xs) -> np.ndarray:
    """Float ndarray view of a sample collection.  ndarrays (and lists)
    convert directly; only opaque iterables pay the materializing copy."""
    if not isinstance(xs, (np.ndarray, list, tuple)):
        xs = list(xs)
    return np.asarray(xs, float)


def pctl(xs, q: float) -> float:
    if len(xs) == 0:
        return float("nan")
    return float(np.percentile(_as_float_array(xs), q))


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


def quantiles_partition_batched(mat: np.ndarray, counts,
                                qs) -> np.ndarray:
    """Row-wise ``quantiles_partition`` over a padded ``[C, K]`` matrix
    (row ``i`` holds ``counts[i]`` valid samples, padding beyond); NaN
    rows where the count is 0.  The same partition and lerp per row, so
    the output is bit-for-bit the scalar path's (the NumPy vector
    backend's quantile head)."""
    counts = np.asarray(counts)
    qs = tuple(float(q) for q in qs)
    out = np.full((counts.size, len(qs)), float("nan"))
    for i, n in enumerate(counts):
        if n:
            out[i] = quantiles_partition(mat[i, :int(n)], qs)
    return out


def slo_violation_frac(xs, slo: Optional[float], n_bad: int = 0) -> float:
    """Fraction of requests violating ``slo``.  ``n_bad`` counts
    requests that never produced a latency sample — shed, timed out, or
    failed after retries — every one of which IS a violation: a 100%-
    shed interval must report 1.0, not the 0.0 the served-only math
    used to produce.  The empty contract is the same as
    ``Summary.of``/``pctl``: no SLO, or no samples AND no failures ->
    NaN (one code path — ``IntervalFrame`` math must not special-case
    emptiness on its own)."""
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
        # all three quantiles in one vectorized call — this sits on the
        # per-interval hot path of every figure sweep
        p50, p95, p99 = np.percentile(xs, (50, 95, 99))
        return cls(int(xs.size), float(xs.mean()),
                   float(p50), float(p95), float(p99))


class LatencyRecorder:
    """Streams completed requests into per-client / per-interval buckets.

    ``mode="exact"`` keeps raw samples (bit-compatible with the figure
    scripts — no RNG is ever constructed or drawn in this mode);
    ``mode="streaming"`` keeps bounded P²/reservoir state only, with the
    reservoir RNG keyed by ``(0x5EED, seed, rep)`` so repetitions
    subsample independently instead of replaying one stream.
    """

    def __init__(self, interval: float = 1.0, mode: str = "exact",
                 reservoir_k: int = 256, seed: int = 0, rep: int = 0):
        if mode not in ("exact", "streaming"):
            raise ValueError(f"unknown recorder mode: {mode!r}")
        self.interval = interval
        self.mode = mode
        # disposition accounting (both modes): requests that ended
        # WITHOUT a latency sample — shed at admission, timed out, or
        # destroyed by a failure — are first-class rows here, never
        # silently absent from the statistics.  Plain counters: O(1)
        # memory, zero cost on the record() hot path.
        self.failures = {"shed": 0, "timeout": 0, "failed": 0}
        self.fail_by_ivl: dict[int, dict] = {}
        if mode == "exact":
            # raw-sample storage; deliberately NOT created in streaming mode
            # so stale consumers fail loudly instead of reading empty lists
            self.by_client: dict[int, list] = defaultdict(list)
            self.by_cell: dict[tuple, list] = defaultdict(list)  # (client, ivl)
            self.all: list[float] = []
            self.queue_times: list[float] = []
            self.service_times: list[float] = []
        if mode == "streaming":
            # one shared RNG for every reservoir this recorder owns,
            # domain-tagged and keyed by (seed, rep)
            self._rand = np.random.default_rng(
                (0x5EED, int(seed), int(rep))).random
            self._all = StreamingStat(reservoir_k=4096, use_p2=True,
                                      rand=self._rand)
            self._by_client: dict[int, StreamingStat] = {}
            self._by_ivl: dict[int, StreamingStat] = {}
            self._by_cell: dict[tuple, StreamingStat] = {}
            self._queue = StreamingStat(reservoir_k, rand=self._rand)
            self._service = StreamingStat(reservoir_k, rand=self._rand)
            self._k = reservoir_k
            self.record = self._record_streaming    # hot-path dispatch

    def record(self, req) -> None:                  # exact mode
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

    def _record_streaming(self, req) -> None:
        completed = req.completed
        started = req.started
        lat = completed - req.created
        cid = req.client_id
        ivl = int(completed / self.interval)
        self._all.add(lat)
        rand = self._rand
        stat = self._by_client.get(cid)
        if stat is None:
            stat = self._by_client[cid] = StreamingStat(self._k, rand=rand)
        stat.add(lat)
        stat = self._by_ivl.get(ivl)
        if stat is None:
            stat = self._by_ivl[ivl] = StreamingStat(self._k, rand=rand)
        stat.add(lat)
        key = (cid, ivl)
        stat = self._by_cell.get(key)
        if stat is None:
            stat = self._by_cell[key] = StreamingStat(self._k, rand=rand)
        stat.add(lat)
        self._queue.add(started - req.enqueued)
        self._service.add(completed - started)

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
        if self.mode == "streaming":
            return self._all.summary()
        return Summary.of(self.all)

    def client(self, cid: int) -> Summary:
        if self.mode == "streaming":
            stat = self._by_client.get(cid)
            return stat.summary() if stat else Summary.of([])
        return Summary.of(self.by_client.get(cid, []))

    def intervals(self, cid: Optional[int] = None) -> dict[int, Summary]:
        if self.mode == "streaming":
            if cid is None:
                return {ivl: s.summary()
                        for ivl, s in sorted(self._by_ivl.items())}
            return {ivl: s.summary()
                    for (c, ivl), s in sorted(self._by_cell.items())
                    if c == cid}
        out: dict[int, list] = defaultdict(list)
        for (c, ivl), xs in self.by_cell.items():
            if cid is None or c == cid:
                out[ivl].extend(xs)
        return {ivl: Summary.of(xs) for ivl, xs in sorted(out.items())}

    def clients(self) -> list[int]:
        if self.mode == "streaming":
            return sorted(self._by_client)
        return sorted(self.by_client)


# ---------------------------------------------------------------------------
# Metrics pipeline: per-interval time series over a LatencyRecorder
# ---------------------------------------------------------------------------
@dataclass
class IntervalFrame:
    """One interval of the run's time series ("Tell-Tale Tail Latencies":
    tail numbers are only interpretable next to their per-interval series)."""
    t: int                          # interval index (t*interval .. (t+1)*interval)
    n: int                          # requests completed in the interval
    qps: float                      # served throughput (n / interval)
    mean: float
    p50: float
    p95: float
    p99: float
    slo_violation_frac: float       # fraction of latencies > slo (nan: no SLO)
    # server_id -> fraction of capacity consumed by service work INITIATED
    # this interval (busy_time accrues at request start, clipped to 1.0);
    # exact for service times << interval, leads true occupancy by up to
    # one service time otherwise
    util: dict
    qdepth: dict                    # server_id -> queued requests (sampled)
    # server_id -> resident-batch (or busy-slot) fraction at the sample
    # point — for batched servers this is the continuous-batching
    # occupancy the knee depends on, distinct from the util time-average
    occupancy: dict
    # server_id -> generated tokens/sec over the interval; only servers
    # that count tokens (batched ServiceModels) appear here
    tokens_per_sec: dict
    # disposition counts: requests that ended this interval WITHOUT a
    # latency sample (they count into slo_violation_frac, not into n)
    n_shed: int = 0
    n_timeout: int = 0
    n_failed: int = 0


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

    In streaming-recorder mode the per-interval percentiles and SLO
    fractions come from the bounded reservoir samples (approximate); in
    exact mode they are computed from the raw per-cell latency lists.
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
        n = len(rec.all) if rec.mode == "exact" else rec._all.n
        return n, rec.failed_total(), self._gauge_ver

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
        rec = self.recorder
        out: dict[int, list] = defaultdict(list)
        if rec.mode == "exact":
            for (c, ivl), xs in rec.by_cell.items():
                out[ivl].extend(xs)
        else:
            for ivl, stat in rec._by_ivl.items():
                out[ivl] = stat.res.data
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


def confidence95(xs) -> tuple[float, float]:
    """Mean and 95% CI half-width across repetitions (paper's error bars).

    Degenerate inputs yield NaN rather than a misleading zero-width CI:
    no samples -> (nan, nan); one sample -> (mean, nan).
    """
    xs = np.asarray(list(xs), float)
    if len(xs) == 0:
        return float("nan"), float("nan")
    if len(xs) == 1:
        return float(xs[0]), float("nan")
    half = 1.96 * xs.std(ddof=1) / math.sqrt(len(xs))
    return float(xs.mean()), float(half)
