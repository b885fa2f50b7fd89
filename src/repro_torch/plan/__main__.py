"""Gradient-based capacity planning from the command line, on the card.

    PYTHONPATH=src python -m repro_torch.plan steady --slo 0.02 \
        --set policy=jsq --set qps=2600 --capacity 4,1,24
    PYTHONPATH=src python -m repro_torch.plan steady --slo 0.05 \
        --objective slo_frac --target 0.02 --capacity 2,1,16
    PYTHONPATH=src python -m repro_torch.plan steady --slo 0.02 \
        --capacity 4,1,24 --hedge 0.05,0.001,0.5 --steps 200 --device cpu

The planner runs a few hundred Adam steps through the smoothed
surrogate (``repro_torch.vector.soft``), rounds the continuous capacity
to an integer fleet, and verifies it on the exact vector runtime — the
probe ladder plus the final measurement are the only exact cells spent.
``--no-verify`` reports the continuous optimum alone.  Both run on the
CUDA card; ``--device cpu`` runs them on the host (the kernels' plain
PyTorch versions).  Where the port differs from ``python -m
repro.plan``: ``--device``.  ``--cache`` (or ``--cache-dir DIR``) serves
the ladder's exact cells from the port's result cache
(``repro_torch.cache``, default ``artifacts/cache_torch``); the cells it
serves are not counted in ``cell_evals``, and a ``cache[...]`` stats
line follows the answer.

Writes ``<out>/plan_<scenario>.json`` (the full ``PlanResult``) and
prints the verified provisioning point.  Exit status is non-zero when
no fleet inside the box meets the target (infeasible).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.plan.planner import DEFAULT_BOXES, PlanSpec, run_plan

OUT_DEFAULT = os.path.join("artifacts", "plan")


def _scalar(text: str):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    return text


def _box(text: str, name: str) -> tuple:
    parts = [float(v) for v in text.split(",")]
    if len(parts) == 1:
        init = parts[0]
        _, lo, hi = DEFAULT_BOXES[name]
        return (init, lo, hi)
    if len(parts) != 3:
        raise SystemExit(f"--{name} wants init[,lo,hi] (got {text!r})")
    return tuple(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.plan",
                                 description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    ap.add_argument("scenario", nargs="?",
                    help="canonical scenario to plan (see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list plannable scenarios and objectives")
    ap.add_argument("--slo", type=float, default=None,
                    help="latency SLO in seconds (required)")
    ap.add_argument("--objective", default="p99",
                    choices=["p50", "p95", "p99", "mean", "slo_frac"])
    ap.add_argument("--target", type=float, default=None,
                    help="objective threshold (default: the SLO; 0.05 "
                         "for slo_frac)")
    ap.add_argument("--set", action="append", default=[], dest="fixed",
                    metavar="NAME=VALUE", help="scenario keyword override")
    ap.add_argument("--capacity", default="4,1,32", metavar="INIT[,LO,HI]",
                    help="fleet-capacity box (default 4,1,32)")
    ap.add_argument("--hedge", default=None, metavar="INIT[,LO,HI]",
                    help="also learn the hedge delay (seconds)")
    ap.add_argument("--admit", default=None, metavar="INIT[,LO,HI]",
                    help="also learn the admission fraction")
    ap.add_argument("--autoscale", default=None, metavar="BASE,EXTRA",
                    help="learn the autoscale threshold over a "
                         "(base, extra) fleet instead of capacity")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--starts", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.15)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "constant"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samples", type=int, default=16384,
                    help="surrogate draw-batch size")
    ap.add_argument("--dt", type=float, default=0.005)
    ap.add_argument("--tau", type=float, default=0.05,
                    help="relaxation temperature")
    ap.add_argument("--penalty", type=float, default=25.0,
                    help="SLO-barrier weight")
    ap.add_argument("--reps", type=int, default=13,
                    help="exact reps for the final verification")
    ap.add_argument("--probe-reps", type=int, default=5,
                    help="exact reps per rounding-ladder probe")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the exact-runtime verification ladder")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the surrogate and the exact ladder run "
                         "(cpu = the kernels' plain PyTorch versions)")
    ap.add_argument("--out", default=OUT_DEFAULT,
                    help=f"artifact directory (default {OUT_DEFAULT})")
    ap.add_argument("--quiet", action="store_true")
    from repro_torch.cache import add_cache_args, cache_from_args
    add_cache_args(ap)
    args = ap.parse_args(argv)

    if args.list:
        from repro_torch import scenarios
        print("plannable canonical scenarios:")
        for n in scenarios.names():
            print(f"  {n}")
        print("objectives: p50 p95 p99 mean slo_frac")
        print(f"parameters: {', '.join(sorted(DEFAULT_BOXES))}")
        return 0
    if not args.scenario:
        ap.print_usage()
        return 2
    if args.slo is None:
        raise SystemExit("--slo is required (planning needs a target)")

    overrides = {}
    for kv in args.fixed:
        if "=" not in kv:
            raise SystemExit(f"--set wants name=value (got {kv!r})")
        k, v = kv.split("=", 1)
        overrides[k] = _scalar(v)

    params = {}
    autoscale = None
    if args.autoscale is not None:
        base, extra = (float(v) for v in args.autoscale.split(","))
        autoscale = (base, extra)
        params["scale_threshold"] = DEFAULT_BOXES["scale_threshold"]
    else:
        params["capacity"] = _box(args.capacity, "capacity")
    if args.hedge is not None:
        params["hedge_delay"] = _box(args.hedge, "hedge_delay")
    if args.admit is not None:
        params["admit"] = _box(args.admit, "admit")

    spec = PlanSpec(
        scenario=args.scenario, objective=args.objective, slo=args.slo,
        target=args.target, overrides=overrides, params=params,
        autoscale=autoscale, steps=args.steps, starts=args.starts,
        lr=args.lr, schedule=args.schedule, seed=args.seed,
        dt=args.dt, samples=args.samples, tau=args.tau,
        penalty=args.penalty, reps=args.reps, probe_reps=args.probe_reps,
        verify=not args.no_verify)

    def _progress(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    from repro_torch.vector import VectorConfig
    cache = cache_from_args(args)
    res = run_plan(spec, progress=None if args.quiet else _progress,
                   vector_config=VectorConfig(device=args.device),
                   cache=cache)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"plan_{args.scenario}.json")
    with open(path, "w") as f:
        json.dump(res.to_dict(), f, indent=2, sort_keys=True)

    print(f"plan={args.scenario} objective={args.objective} "
          f"target={res.spec['target'] or args.slo}")
    print(f"continuous optimum: {res.params} "
          f"(loss={res.starts[res.best_start]['loss']:.4f}, "
          f"surrogate {args.objective}="
          f"{res.surrogate[args.objective]:.4g})")
    if res.verified is not None:
        v = res.verified
        print(f"verified fleet: n={res.n_star} "
              f"{args.objective}={v['mean']:.4g} +- {v['ci95']:.4g} "
              f"({'feasible' if res.feasible else 'INFEASIBLE'}; "
              f"{res.cell_evals} exact cells)")
    if cache is not None:
        print(f"cache[{cache.cache_dir}] {cache.stats}")
    print(f"wrote {path}")
    return 0 if res.feasible else 1


if __name__ == "__main__":
    sys.exit(main())
