"""Run declarative sweeps from the command line, on either executor.

    PYTHONPATH=src python -m repro_torch.sweep --list
    PYTHONPATH=src python -m repro_torch.sweep steady \
        --axis qps=300,600,900 --reps 13    # whole grid in one card launch
    PYTHONPATH=src python -m repro_torch.sweep steady --axis qps=300,600 \
        --axis n_servers=1,2 --reps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.sweep steady --axis qps=300,600 \
        --runtime sim --executor process --workers 4 --telemetry
    PYTHONPATH=src python -m repro_torch.sweep steady \
        --axis runtime=sim,vector --axis qps=300,600 --reps 3
    PYTHONPATH=src python -m repro_torch.sweep --file my_sweep.json
    PYTHONPATH=src python -m repro_torch.sweep --smoke --executor process

A named sweep is a canonical or chaos scenario (``repro_torch.scenarios``)
swept over its builder keywords: every ``--axis name=v1,v2,...`` becomes
one grid axis (first axis outermost), ``--set name=value`` pins a
constant, and ``runtime`` is itself sweepable (``sim``, stub-``engine``
and ``vector`` backends).

Where the port differs from ``python -m repro.sweep``: ``--runtime``
defaults to ``vector`` (the reference's default is ``sim``), and the
vector grid runs on the CUDA card unless ``--device cpu`` asks for the
kernels' plain PyTorch versions on the CPU (in place of the reference's
``--vector-impl``); ``--vector-devices N`` shards the grid's cells over
N local cards (0 = all), and ``--vector-backend numpy`` runs the
reference's f64 NumPy backend on the host instead.  A
``--file`` declaration, and ``--smoke``, still mean ``sim`` where they
name no runtime, as in the reference.  An ``optimize`` declaration runs
the gradient planner on ``--device``.  ``--cache`` (or ``--cache-dir
DIR``) reuses the port's result cache (``repro_torch.cache``, default
``artifacts/cache_torch``): warm rows launch nothing, and a ``cache[...]``
stats line follows the aggregate.

``--file`` runs a JSON (or YAML, when PyYAML is importable) sweep
declaration::

    {"name": "knee-hunt", "scenario": "steady", "reps": 5,
     "axes": {"qps": [300, 600, 900], "n_servers": [1, 2]},
     "fixed": {"duration": 10.0}, "seed": 0, "seeder": "spawn",
     "metrics": ["n", "mean", "p50", "p95", "p99", "dropped"],
     "telemetry": false, "runtime": "sim"}

Artifacts: ``<out>/<name>.json`` (the exact-round-trip ``ResultFrame``)
and ``<out>/<name>.csv`` (flat per-repetition rows).  Exit status is
non-zero if any point recorded an error row — CI gates on completion.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.sweep.executor import run_sweep
from repro_torch.sweep.spec import (DEFAULT_METRICS, SEEDERS, Axis, Sweep,
                                    scenario_factory)

OUT_DEFAULT = os.path.join("artifacts", "sweeps")

SMOKE = {
    "name": "smoke",
    "scenario": "steady",
    "axes": {"qps": [200.0, 400.0], "n_servers": [1, 2]},
    "fixed": {"duration": 3.0},
    "reps": 2,
    "metrics": list(DEFAULT_METRICS) + ["dropped"],
}


def _scalar(text: str):
    """Parse an axis value: int, then float, then bare string."""
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    return text


def _parse_axis(text: str) -> Axis:
    if "=" not in text:
        raise SystemExit(f"--axis wants name=v1,v2,... (got {text!r})")
    name, vals = text.split("=", 1)
    return Axis(name, tuple(_scalar(v) for v in vals.split(",")))


def _load_file(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError as e:
            raise SystemExit(f"{path}: YAML sweeps need PyYAML ({e})")
        return yaml.safe_load(text)
    import json
    return json.loads(text)


def _sweep_from_decl(decl: dict) -> Sweep:
    scenario = decl.get("scenario")
    if not scenario:
        raise SystemExit("sweep declaration needs a 'scenario' name")
    axes = tuple(Axis(k, tuple(v)) for k, v in decl.get("axes", {}).items())
    points = tuple(decl.get("points", ()))
    metrics = tuple(decl.get("metrics", DEFAULT_METRICS))
    optimize = decl.get("optimize")
    if optimize is not None:
        # planner declaration: {"scenario": ..., "optimize": {"slo": ...,
        # "params": {"capacity": [4, 1, 24]}, ...}, "fixed": {...}}
        return Sweep(name=decl.get("name", scenario), factory=None,
                     mode="optimize",
                     optimize={"scenario": scenario, **optimize},
                     fixed=dict(decl.get("fixed", {})),
                     reps=int(decl.get("reps", 13)),
                     base_seed=int(decl.get("seed", 0)))
    return Sweep(name=decl.get("name", scenario),
                 factory=scenario_factory(scenario),
                 axes=axes,
                 mode=decl.get("mode", "points" if points else "grid"),
                 points=points,
                 fixed=dict(decl.get("fixed", {})),
                 reps=int(decl.get("reps", 13)),
                 base_seed=int(decl.get("seed", 0)),
                 seeder=decl.get("seeder", "spawn"),
                 metrics=metrics,
                 telemetry=bool(decl.get("telemetry", False)),
                 per_client=bool(decl.get("per_client", False)),
                 runtime=decl.get("runtime", "sim"))


def _print_plan(frame) -> None:
    plan = frame.spec["plan"]
    print(f"plan={frame.name} objective={plan['spec']['objective']} "
          f"target={plan['spec']['target']}")
    print(f"continuous optimum: {plan['params']}")
    v = plan.get("verified")
    if v is not None:
        print(f"verified fleet: n={plan['n_star']} "
              f"{v['metric']}={v['mean']:.4g} +- {v['ci95']:.4g} "
              f"({'feasible' if plan['feasible'] else 'INFEASIBLE'}; "
              f"{plan['cell_evals']} exact cells)")


def _print_aggregate(frame) -> None:
    if "plan" in frame.spec:
        _print_plan(frame)
        return
    metrics = [m for m in frame.spec.get("metrics", ())
               if m not in ("n",)]
    headline = "p99" if "p99" in metrics else (metrics[0] if metrics else None)
    print(f"sweep={frame.name} points={len(frame.points())} "
          f"rows={len(frame.rows)} errors={len(frame.errors)}")
    if headline is None:
        return
    print(f"{'point':<48} {'reps':>4} {headline + '_mean':>12} {'ci95':>12}")
    for a in frame.aggregate(headline):
        label = ",".join(f"{k}={v}" for k, v in a["params"].items()) or "-"
        print(f"{label:<48} {a['n_reps']:>4} {a['mean']:>12.6g} "
              f"{a['ci95']:>12.6g}")
    for r in frame.errors:
        print(f"  ERROR point={r.params} rep={r.rep}: {r.error}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweep",
                                 description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    ap.add_argument("scenario", nargs="?",
                    help="canonical scenario to sweep (see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list sweepable scenarios and named seeders")
    ap.add_argument("--file", default=None,
                    help="JSON/YAML sweep declaration to run")
    ap.add_argument("--smoke", action="store_true",
                    help="run the built-in CI smoke grid")
    ap.add_argument("--axis", action="append", default=[],
                    metavar="NAME=V1,V2,...", help="add one grid axis")
    ap.add_argument("--set", action="append", default=[], dest="fixed",
                    metavar="NAME=VALUE", help="pin a constant override")
    ap.add_argument("--zip", action="store_true",
                    help="zip the axes instead of taking their product")
    ap.add_argument("--reps", type=int, default=13)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeder", default="spawn", choices=sorted(SEEDERS))
    ap.add_argument("--metrics", default=None,
                    metavar="M1,M2,...", help="metric names to extract")
    ap.add_argument("--telemetry", action="store_true",
                    help="capture per-interval series per repetition")
    ap.add_argument("--per-client", action="store_true",
                    help="capture per-client summaries per repetition")
    ap.add_argument("--runtime", default="vector",
                    choices=["sim", "engine", "vector"],
                    help="default runtime backend of a named sweep (axis "
                         "'runtime' overrides; 'vector', the default, runs "
                         "the whole grid as one program on --device; the "
                         "reference's default is 'sim')")
    ap.add_argument("--executor", default="serial",
                    choices=["serial", "process"])
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the vector grid runs (cpu = the kernels' "
                         "plain PyTorch versions); sim and engine tasks "
                         "always run on the host")
    ap.add_argument("--vector-backend", default="auto",
                    choices=["auto", "torch", "numpy"],
                    help="vector grid: array backend (auto = torch, on "
                         "--device; numpy = the reference's f64 host "
                         "backend)")
    ap.add_argument("--vector-devices", type=int, default=0,
                    help="vector grid: shard cells over N local devices "
                         "(0 = all)")
    ap.add_argument("--out", default=OUT_DEFAULT,
                    help=f"artifact directory (default {OUT_DEFAULT})")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-task progress lines")
    from repro_torch.cache import add_cache_args, cache_from_args
    add_cache_args(ap)
    args = ap.parse_args(argv)

    if args.list:
        from repro_torch import scenarios
        print("sweepable canonical and chaos scenarios:")
        for n in scenarios.names():
            builder = scenarios.SCENARIOS[n]
            doc = (builder.__doc__ or "").strip().splitlines()[0]
            print(f"  {n:<21} {doc}")
        print(f"named seeders: {', '.join(sorted(SEEDERS))}")
        return 0

    if args.smoke:
        decl = dict(SMOKE)
        sweep = _sweep_from_decl(decl)
    elif args.file:
        sweep = _sweep_from_decl(_load_file(args.file))
    elif args.scenario:
        axes = tuple(_parse_axis(a) for a in args.axis)
        fixed = {}
        for kv in args.fixed:
            if "=" not in kv:
                raise SystemExit(f"--set wants name=value (got {kv!r})")
            k, v = kv.split("=", 1)
            fixed[k] = _scalar(v)
        metrics = tuple(args.metrics.split(",")) if args.metrics \
            else tuple(DEFAULT_METRICS) + ("dropped",)
        sweep = Sweep(name=args.scenario,
                      factory=scenario_factory(args.scenario),
                      axes=axes, mode="zip" if args.zip else "grid",
                      fixed=fixed, reps=args.reps, base_seed=args.seed,
                      seeder=args.seeder, metrics=metrics,
                      telemetry=args.telemetry, per_client=args.per_client,
                      runtime=args.runtime)
    else:
        ap.print_usage()
        return 2

    def _progress(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    from repro_torch.vector import VectorConfig
    cache = cache_from_args(args)
    frame = run_sweep(sweep, executor=args.executor, workers=args.workers,
                      progress=None if args.quiet else _progress,
                      vector_config=VectorConfig(
                          device=args.device, backend=args.vector_backend,
                          devices=args.vector_devices),
                      cache=cache)
    json_path = os.path.join(args.out, f"{frame.name}.json")
    csv_path = os.path.join(args.out, f"{frame.name}.csv")
    frame.to_json(json_path)
    frame.to_csv(csv_path)
    _print_aggregate(frame)
    if cache is not None:
        print(f"cache[{cache.cache_dir}] {cache.stats}")
    print(f"wrote {json_path}")
    print(f"wrote {csv_path}")
    return 1 if frame.errors else 0


if __name__ == "__main__":
    sys.exit(main())
