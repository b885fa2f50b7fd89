"""One CLI for every canonical scenario, on the vector runtime.

    PYTHONPATH=src python -m repro_torch.scenarios --list
    PYTHONPATH=src python -m repro_torch.scenarios server-failure --backend vector
    PYTHONPATH=src python -m repro_torch.scenarios steady --device cpu --duration 3

The run goes to the CUDA card; ``--device cpu`` runs the kernels' plain
PyTorch versions on the CPU instead.  The ``sim`` and ``engine``
backends are not ported yet.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import scenarios
from repro_torch.core.runtime import run_scenario


def _print_report(rt, scenario, backend: str) -> None:
    s = rt.telemetry.overall()
    print(f"scenario={scenario.name} backend={backend} "
          f"n={s.n} dropped={rt.dropped} mean={s.mean*1e3:.2f}ms "
          f"p50={s.p50*1e3:.2f}ms p95={s.p95*1e3:.2f}ms "
          f"p99={s.p99*1e3:.2f}ms")
    res = {m: int(getattr(rt, m, 0) or 0)
           for m in ("shed", "timeouts", "retries")}
    if any(res.values()):
        print(f"  resilience: shed={res['shed']} "
              f"timeouts={res['timeouts']} retries={res['retries']}")
    unsupported = getattr(rt, "unsupported", ())
    for inj in unsupported:
        print(f"  note: injection {inj.kind}@{inj.at:g}s not supported on "
              f"this backend (skipped)")
    print(f"{'t':>4} {'n':>7} {'qps':>9} {'p50ms':>8} {'p99ms':>9} "
          f"{'util':>5} {'qdepth':>6}  slo_viol")
    for r in rt.telemetry.to_rows():        # same aggregation as --csv
        viol = ("-" if r["slo_violation_frac"] != r["slo_violation_frac"]
                else f"{r['slo_violation_frac']:.3f}")
        print(f"{r['t']:4d} {r['n']:7d} {r['qps']:9.1f} {r['p50_ms']:8.2f} "
              f"{r['p99_ms']:9.2f} {r['mean_util']:5.2f} "
              f"{r['total_qdepth']:6d}  {viol}")


def _write_csv(rt, path: str) -> None:
    rows = rt.telemetry.to_rows()
    if not rows:
        return
    cols = list(rows[0])
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for r in rows:
            f.write(",".join(str(r[c]) for c in cols) + "\n")
    print(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.scenarios",
                                 description=__doc__)
    ap.add_argument("name", nargs="?", help="scenario name (see --list)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--backend", default="vector",
                    choices=["sim", "engine", "vector"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the vector runtime runs (cpu = the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--app", default=None)
    ap.add_argument("--policy", default=None)
    ap.add_argument("--slo", type=float, default=None,
                    help="latency SLO in seconds (telemetry violation frac)")
    ap.add_argument("--csv", default=None, help="write interval frames here")
    args = ap.parse_args(argv)

    if args.list or not args.name:
        print("canonical scenarios:")
        for n in scenarios.names():
            builder = scenarios.SCENARIOS[n]
            doc = (builder.__doc__ or "").strip().splitlines()[0]
            print(f"  {n:<18} {doc}")
        return 0

    if args.backend != "vector":
        ap.error(f"--backend {args.backend} is not ported yet (use vector)")
    # overrides go to the scenario *builder* so event times scale with them
    overrides = {k: v for k, v in (("duration", args.duration),
                                   ("app", args.app),
                                   ("policy", args.policy),
                                   ("slo", args.slo)) if v is not None}
    sc = scenarios.get(args.name, seed=args.seed, **overrides)

    from repro_torch.vector import VectorConfig
    rt = run_scenario(sc, args.backend,
                      vector_config=VectorConfig(device=args.device))
    _print_report(rt, sc, args.backend)
    if args.csv:
        _write_csv(rt, args.csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
