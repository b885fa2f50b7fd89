"""Paper Fig. 4 + Table 4: TailBench (legacy) vs TailBench++ equivalence.

Twin of ``benchmarks/fig4_equivalence.py`` on the PyTorch/CUDA port: the same
``SWEEP`` declaration (runtime included), run through
``repro_torch.sweep``; the figure CSV goes to ``artifacts/bench_torch/``.

For each of the 8 apps, run both harness modes over a QPS range with 13
repetitions each (independent seeds per mode, like independent runs on a
real testbed), then Welch's t-test on the mean/p95/p99 distributions.
The null hypothesis (no behavioral difference) must be retained everywhere:
|t| < 2 and p > 0.05 — the paper's validation methodology.

Declared as a ``repro_torch.sweep`` over explicit points (app x per-app QPS x
harness variant, 13 repetitions each).  Per-app seeds come from a
stable digest (``zlib.crc32``), so the run is deterministic in any
process — the old ``hash(app)`` derivation silently depended on
``PYTHONHASHSEED``.
"""
from __future__ import annotations

import time
import zlib

from benchmarks.torch_port.common import emit
from repro_torch.core.legacy import legacy_experiment, plusplus_equivalent
from repro_torch.core.stats import welch_ttest
from repro_torch.sweep import PointCtx, Sweep, run_sweep

QPS_RANGE = {          # per-app load points (scaled to service time)
    "masstree": (500, 2000), "silo": (400, 1500), "xapian": (100, 400),
    "img-dnn": (100, 300), "specjbb": (150, 500), "shore": (40, 120),
    "moses": (4, 10), "sphinx": (0.3, 0.8),
}
REPS = 13
METRICS = ("mean", "p95", "p99")
# slow apps need longer (virtual) windows to accumulate a sample
DURATION = {"sphinx": 150.0, "moses": 40.0}


def app_seed(app: str, rep: int) -> int:
    """Stable per-(app, rep) seed: crc32 digest, never ``hash()``."""
    return 1000 * rep + zlib.crc32(app.encode()) % 997


def _point(ctx: PointCtx):
    app, qps = ctx.params["app"], ctx.params["qps"]
    seed = app_seed(app, ctx.rep)
    dur = DURATION.get(app, 12.0)
    if ctx.params["variant"] == "legacy":
        return legacy_experiment(3, qps / 3,
                                 requests_per_client=int(qps * dur / 3),
                                 app=app, duration=dur, seed=seed)
    # the ++ harness runs as an independent testbed: independent seeds
    return plusplus_equivalent(legacy_experiment(
        3, qps / 3, requests_per_client=int(qps * dur / 3),
        app=app, duration=dur, seed=seed + 500_000))


SWEEP = Sweep(name="fig4_equivalence", factory=_point, mode="points",
              points=tuple({"app": app, "qps": qps, "variant": variant}
                           for app, qs in QPS_RANGE.items()
                           for qps in qs
                           for variant in ("legacy", "plusplus")),
              reps=REPS, seeder="fixed", metrics=METRICS)


def main() -> str:
    t0 = time.time()
    frame = run_sweep(SWEEP, progress=None).raise_errors()
    rows = []
    all_retained = True
    for app in QPS_RANGE:
        for m in METRICS:
            w = welch_ttest(frame.values(m, app=app, variant="legacy"),
                            frame.values(m, app=app, variant="plusplus"))
            retained = abs(w.t_stat) < 2 and w.p_value > 0.05
            all_retained &= retained
            rows.append({"app": app, "metric": m,
                         "t_stat": round(w.t_stat, 3),
                         "p_value": round(w.p_value, 3),
                         "H0_retained": retained})
    emit("fig4_table4_equivalence", rows, t0, f"H0_retained_all={all_retained}")
    return f"H0_retained_all={all_retained}"


if __name__ == "__main__":
    main()
