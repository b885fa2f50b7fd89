"""Closed-loop control benchmark of the port: SLO attainment vs
provisioned cost.

Twin of ``benchmarks/bench_control.py`` on the port's ``sim`` backend
(on the host): the same arms, storm and gates.  It writes
``BENCH_control_torch.json`` (``--smoke``:
``BENCH_control_torch.smoke.json``), never the reference's record.

Two measurements, one committed record (``BENCH_control_torch.json``):

1. **Attainment/cost frontier under a flash crowd** — the same
   flash-crowd trace served four ways: a static 2-server fleet
   (under-provisioned), a static 6-server fleet (peak-provisioned), a
   reactive threshold autoscaler drawing on a standby pool, and an
   AIMD admission shedder (brownout).  Attainment is
   ``1 - slo_frac`` with shed/timed-out/failed requests counted as
   violations (the honest denominator); cost is integrated
   server-seconds from the control log.  Gates: the autoscaler beats
   static-small attainment while staying under static-big cost — the
   closed loop actually buys the middle of the frontier.

2. **Retry-storm contrast** — the same overload burst under naive
   immediate retries vs capped/jittered/budgeted backoff.  Gates:
   backoff serves >= 1.3x the naive goodput and issues < 1/5 the
   retries — the metastable-congestion result the resilience stack
   exists to demonstrate.

Usage:
    PYTHONPATH=src python benchmarks/torch_port/bench_control.py             # full
    PYTHONPATH=src python benchmarks/torch_port/bench_control.py --smoke --check
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                    ".."))
sys.path.insert(0, os.path.join(REPO, "src"))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmarks.torch_port._record import write_record  # noqa: E402
from repro_torch.core.harness import ServerSpec  # noqa: E402
from repro_torch.core.runtime import run_scenario  # noqa: E402
from repro_torch.scenarios import get  # noqa: E402
from repro_torch.sweep.executor import _slo_frac  # noqa: E402

#: the reactive loop must beat the under-provisioned fleet by this much
MIN_ATTAINMENT_GAIN = 0.05
#: ... while spending at most this fraction of peak provisioning
MAX_COST_VS_STATIC_BIG = 0.95
MIN_BACKOFF_GOODPUT_RATIO = 1.3
MAX_BACKOFF_RETRY_FRAC = 0.2

SCALE = {"full": {"duration": 45.0, "reps": 5},
         "smoke": {"duration": 18.0, "reps": 2}}
SEED = 0
#: tight enough that the flash crowd actually violates it on an
#: under-provisioned fleet (the scenario default 250ms never would)
SLO = 0.02


def _cost_server_seconds(sc, rt) -> float:
    """Integrated active-server-seconds from the run's control log."""
    n0 = sum(1 for s in sc.servers if not s.standby)
    steps = [(t, p["n"]) for t, k, p in getattr(rt, "control_log", [])
             if k == "set_scale"]
    cost, t_prev, n_prev = 0.0, 0.0, n0
    for t, n in steps:
        cost += n_prev * (min(t, sc.duration) - t_prev)
        t_prev, n_prev = min(t, sc.duration), n
    return cost + n_prev * (sc.duration - t_prev)


def _arm(name: str, sc, rep: int) -> dict:
    rt = run_scenario(sc, "sim", rep=rep)
    s = rt.telemetry.overall()
    frac = _slo_frac(rt, sc.slo)
    return {"arm": name, "rep": rep, "n": s.n,
            "p99_ms": round(s.p99 * 1e3, 3),
            "shed": int(getattr(rt, "shed", 0)),
            "slo_frac": round(frac, 5),
            "attainment": round(1.0 - frac, 5),
            "cost_server_s": round(_cost_server_seconds(sc, rt), 2)}


def _frontier_arms(duration: float, seed: int):
    base = dict(seed=seed, duration=duration, slo=SLO)
    small = get("flash-crowd-autoscale", **base)
    small.control = None                       # 2 active + idle standby
    big = get("flash-crowd-autoscale", **base)
    big.control = None
    big.servers = tuple(ServerSpec(i, workers=2) for i in range(6))
    auto = get("flash-crowd-autoscale", **base)
    shed = get("flash-crowd-autoscale", **base,
               controller="admission_shedder")
    return [("static-small", small), ("static-big", big),
            ("autoscaler", auto), ("shedder", shed)]


def frontier_section(smoke: bool) -> dict:
    cfg = SCALE["smoke" if smoke else "full"]
    rows = []
    for rep in range(cfg["reps"]):
        for name, sc in _frontier_arms(cfg["duration"], SEED):
            rows.append(_arm(name, sc, rep))
            print(f"  {rows[-1]}", file=sys.stderr, flush=True)

    def agg(name, key):
        xs = [r[key] for r in rows if r["arm"] == name]
        return sum(xs) / len(xs)

    summary = {name: {"attainment": round(agg(name, "attainment"), 5),
                      "cost_server_s": round(agg(name, "cost_server_s"), 2),
                      "p99_ms": round(agg(name, "p99_ms"), 3)}
               for name in ("static-small", "static-big", "autoscaler",
                            "shedder")}
    return {"duration_s": cfg["duration"], "reps": cfg["reps"],
            "arms": rows, "summary": summary}


def retry_storm_section(smoke: bool) -> dict:
    cfg = SCALE["smoke" if smoke else "full"]
    out = {}
    for mode in ("naive", "backoff"):
        ns, tos, rets, p99s = [], [], [], []
        for rep in range(cfg["reps"]):
            rt = run_scenario(get("retry-storm", seed=SEED, mode=mode,
                                  duration=cfg["duration"]), "sim",
                              rep=rep)
            s = rt.telemetry.overall()
            ns.append(s.n)
            tos.append(rt.timeouts)
            rets.append(rt.retries)
            p99s.append(s.p99)
        out[mode] = {"goodput": round(sum(ns) / len(ns), 1),
                     "timeouts": round(sum(tos) / len(tos), 1),
                     "retries": round(sum(rets) / len(rets), 1),
                     "p99_ms": round(sum(p99s) / len(p99s) * 1e3, 3)}
        print(f"  retry-storm {mode}: {out[mode]}", file=sys.stderr,
              flush=True)
    naive, backoff = out["naive"], out["backoff"]
    out["goodput_ratio"] = round(backoff["goodput"]
                                 / max(naive["goodput"], 1.0), 3)
    out["retry_ratio"] = round(backoff["retries"]
                               / max(naive["retries"], 1.0), 4)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI scale; writes the gitignored smoke record")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero if any gate fails")
    args = ap.parse_args(argv)
    scale = "smoke" if args.smoke else "full"
    print(f"bench_control ({scale})", file=sys.stderr)

    frontier = frontier_section(args.smoke)
    storm = retry_storm_section(args.smoke)

    summ = frontier["summary"]
    gates = {
        "autoscaler_beats_static_small": bool(
            summ["autoscaler"]["attainment"]
            >= summ["static-small"]["attainment"] + MIN_ATTAINMENT_GAIN),
        "autoscaler_cheaper_than_static_big": bool(
            summ["autoscaler"]["cost_server_s"]
            <= MAX_COST_VS_STATIC_BIG * summ["static-big"]["cost_server_s"]),
        "shedder_beats_static_small": bool(
            summ["shedder"]["attainment"]
            > summ["static-small"]["attainment"]),
        "backoff_goodput": bool(storm["goodput_ratio"]
                                >= MIN_BACKOFF_GOODPUT_RATIO),
        "backoff_retry_discipline": bool(storm["retry_ratio"]
                                         <= MAX_BACKOFF_RETRY_FRAC),
    }

    payload = {
        "benchmark": "bench_control",
        "scale": scale,
        "frontier": frontier,
        "retry_storm": storm,
        "thresholds": {
            "min_attainment_gain": MIN_ATTAINMENT_GAIN,
            "max_cost_vs_static_big": MAX_COST_VS_STATIC_BIG,
            "min_backoff_goodput_ratio": MIN_BACKOFF_GOODPUT_RATIO,
            "max_backoff_retry_frac": MAX_BACKOFF_RETRY_FRAC,
        },
        "gates": gates,
    }
    write_record("control", payload, smoke=args.smoke)
    print(json.dumps({"gates": gates, "summary": summ,
                      "goodput_ratio": storm["goodput_ratio"]}, indent=1))
    if args.check:
        return 0 if all(gates.values()) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
