"""MetricsPipeline-compatible telemetry over a ``VectorResult``.

The vector backend has no per-request recorder — its latency numbers
come from bounded per-cell samples ("Sampling in Cloud Benchmarking":
sound percentiles from bounded collection).  This adapter exposes the
same read surface the figure scripts and the sweep executor consume
from ``MetricsPipeline``: ``overall()``, ``series()``, ``window()``,
``frames()``, ``to_rows()``.  Per-client views are not tracked by the
fluid model: ``clients()`` is empty and ``client()`` returns the empty
summary.  Copy of ``repro.vector.telemetry``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.stats import (IntervalFrame, Summary,
                                    quantiles_partition, slo_violation_frac)
from repro_torch.vector.runtime import VectorResult


class VectorTelemetry:
    def __init__(self, result: VectorResult):
        self.result = result
        self.interval = result.interval
        self.slo = result.slo
        self._series_cache = None
        self._groups_cache = None

    def _ivl_samples(self, ivl: int) -> np.ndarray:
        """Samples completing in interval ``ivl`` — grouped once by a
        STABLE argsort (within-group order preserved), so each group is
        bit-for-bit the boolean-mask slice it replaces, without the
        O(intervals x samples) rescan."""
        if self._groups_cache is None:
            r = self.result
            order = np.argsort(r.sample_ivl, kind="stable")
            sorted_ivl = r.sample_ivl[order]
            sorted_xs = r.samples[order]
            starts = np.searchsorted(sorted_ivl, np.arange(len(r.n_ivl) + 1))
            self._groups_cache = (sorted_xs, starts)
        sorted_xs, starts = self._groups_cache
        return sorted_xs[starts[ivl]:starts[ivl + 1]]

    # ---- summaries ---------------------------------------------------------
    def overall(self) -> Summary:
        r = self.result
        if r.n == 0 and r.samples.size == 0:
            return Summary.empty()
        return Summary(r.n, r.mean, r.p50, r.p95, r.p99)

    def client(self, cid: int) -> Summary:
        return Summary.empty()

    def clients(self) -> list:
        return []

    def slo_frac(self) -> float:
        """Overall SLO-violation fraction.  Admission-shed requests are
        violations by definition; the served fraction comes from the
        bounded samples, weighted by the true served count."""
        r = self.result
        base = slo_violation_frac(r.samples, self.slo)
        shed = float(r.shed_ivl.sum()) if r.shed_ivl is not None else 0.0
        if shed <= 0.0 or self.slo is None:
            return base
        if r.n == 0:
            return 1.0
        f = 0.0 if base != base else base          # NaN -> no samples kept
        return (f * r.n + shed) / (r.n + shed)

    # ---- interval series ---------------------------------------------------
    def series(self, cid=None) -> dict:
        if cid is not None:
            return {}
        if self._series_cache is not None:
            return self._series_cache
        r = self.result
        out: dict[int, Summary] = {}
        for ivl in range(len(r.n_ivl)):
            n = int(round(float(r.n_ivl[ivl])))
            xs = self._ivl_samples(ivl)
            if n == 0 and xs.size == 0:
                continue
            if xs.size:
                p50, p95, p99 = quantiles_partition(xs, (50.0, 95.0, 99.0))
                out[ivl] = Summary(n, float(xs.mean()), float(p50),
                                   float(p95), float(p99))
            else:
                out[ivl] = Summary(n, *(float("nan"),) * 4)
        self._series_cache = out
        return out

    def window(self, metric: str, lo: int = 0, hi=None, cid=None) -> list:
        return [getattr(s, metric) for t, s in self.series(cid).items()
                if t >= lo and (hi is None or t < hi)]

    def frames(self) -> list[IntervalFrame]:
        r = self.result
        series = self.series()
        sids = r.server_ids
        frames = []
        for ivl in range(len(r.n_ivl)):
            s = series.get(ivl) or Summary.empty()
            xs = self._ivl_samples(ivl)
            shed_i = (float(r.shed_ivl[ivl]) if r.shed_ivl is not None
                      else 0.0)
            viol = slo_violation_frac(xs, self.slo)
            if shed_i > 0.0 and self.slo is not None:
                # fold sheds in, weighted by the interval's true served
                # count (a 100%-shed interval reports 1.0, not NaN/0)
                f = 0.0 if viol != viol else viol
                viol = (f * s.n + shed_i) / (s.n + shed_i)
            frames.append(IntervalFrame(
                t=ivl, n=s.n, qps=s.n / self.interval, mean=s.mean,
                p50=s.p50, p95=s.p95, p99=s.p99,
                slo_violation_frac=viol, n_shed=int(round(shed_i)),
                util={sid: float(r.util_ivl[ivl, j])
                      for j, sid in enumerate(sids)},
                qdepth={sid: int(round(float(r.qdepth_ivl[ivl, j])))
                        for j, sid in enumerate(sids)},
                occupancy={sid: float(r.occ_ivl[ivl, j])
                           for j, sid in enumerate(sids)},
                tokens_per_sec={} if r.tokens_ivl is None else
                {sid: float(r.tokens_ivl[ivl, j])
                 for j, sid in enumerate(sids)}))
        return frames

    def to_rows(self) -> list[dict]:
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
                         "mean_util": mean_util,
                         "mean_occupancy": mean_occ,
                         "tokens_per_sec": sum(f.tokens_per_sec.values()),
                         "total_qdepth": sum(f.qdepth.values())
                                         if f.qdepth else 0})
        return rows
