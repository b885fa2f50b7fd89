"""One CLI for every canonical and chaos scenario, on the vector
runtime, the event simulator or engines.

    PYTHONPATH=src python -m repro_torch.scenarios --list
    PYTHONPATH=src python -m repro_torch.scenarios server-failure --backend vector
    PYTHONPATH=src python -m repro_torch.scenarios steady --device cpu --duration 3
    PYTHONPATH=src python -m repro_torch.scenarios flash-crowd-autoscale --device cpu
    PYTHONPATH=src python -m repro_torch.scenarios retry-storm --backend sim
    PYTHONPATH=src python -m repro_torch.scenarios server-failure --backend engine --stub
    PYTHONPATH=src python -m repro_torch.scenarios retry-storm --backend engine --stub
    PYTHONPATH=src python -m repro_torch.scenarios batched-serving --backend engine --stub
    PYTHONPATH=src python -m repro_torch.scenarios steady --backend engine \
        --arch phi3-mini-3.8b --duration 5

``--backend vector`` (default) runs the batched grid runtime on the
card — the reference's ``python -m repro.scenarios`` defaults to
``--backend sim``, but the port's entry points default to the card;
``--backend sim`` runs the virtual-time event simulator on the host
(exact: retries, timeouts, breakers and the control loop per request;
it never touches the card); ``--backend engine`` drives the wall-clock
runtime against stub replicas in accelerated virtual time (``--stub``,
the default without ``--arch``: profile-timed ``StubEngine``s, or
``BatchedStubEngine``s for a batched service model) or against real
``InferenceEngine`` replicas of a model (``--arch``); retries, breakers,
admission control and the control loop run on it as on ``sim``.  The
vector and model runs go to the CUDA card; ``--device cpu`` runs the
kernels' plain PyTorch versions on the CPU instead, and
``--vector-devices N`` shards the vector cells over N local cards (0 =
all, the default).  The report's first line
names the backend and where it ran (``device=host`` for ``sim`` and
the stub engines, and for ``--vector-backend numpy``, the reference's
f64 NumPy backend).  ``--cache`` (or ``--cache-dir DIR``) serves the
vector cell from the port's result cache (``repro_torch.cache``, default
``artifacts/cache_torch``) when it holds it, and prints a ``cache[...]``
stats line after the report.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import scenarios
from repro_torch.core.runtime import EngineRuntime, VirtualClock, run_scenario


def _print_report(rt, scenario, backend: str, device: str) -> None:
    s = rt.telemetry.overall()
    print(f"scenario={scenario.name} backend={backend} "
          f"n={s.n} dropped={rt.dropped} mean={s.mean*1e3:.2f}ms "
          f"p50={s.p50*1e3:.2f}ms p95={s.p95*1e3:.2f}ms "
          f"p99={s.p99*1e3:.2f}ms device={device}")
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
                    choices=["sim", "engine", "vector"],
                    help="vector (default: the grid runtime on --device; "
                         "the reference's default is sim, but the port's "
                         "entry points default to the card), sim (the "
                         "event simulator, on the host) or engine")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the vector runtime or the model runs "
                         "(cpu = the kernels' plain PyTorch versions); "
                         "the sim backend always runs on the host")
    ap.add_argument("--vector-backend", default="auto",
                    choices=["auto", "torch", "numpy"],
                    help="vector backend: array backend (auto = torch, on "
                         "--device; numpy = the reference's f64 host "
                         "backend, which never touches the card)")
    ap.add_argument("--vector-devices", type=int, default=0,
                    help="vector backend: shard cells over N local "
                         "devices (0 = all)")
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--app", default=None)
    ap.add_argument("--policy", default=None)
    ap.add_argument("--slo", type=float, default=None,
                    help="latency SLO in seconds (telemetry violation frac)")
    ap.add_argument("--csv", default=None, help="write interval frames here")
    # engine-backend options
    ap.add_argument("--stub", action="store_true",
                    help="engine backend: profile-timed StubEngine replicas "
                         "in virtual time (default when --arch is absent)")
    ap.add_argument("--arch", default=None,
                    help="engine backend: real InferenceEngine replicas")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="engine backend: virtual->wall time stretch")
    from repro_torch.cache import add_cache_args, cache_from_args
    add_cache_args(ap)
    args = ap.parse_args(argv)

    if args.list or not args.name:
        print("canonical and chaos scenarios:")
        for n in scenarios.names():
            builder = scenarios.SCENARIOS[n]
            doc = (builder.__doc__ or "").strip().splitlines()[0]
            print(f"  {n:<21} {doc}")
        return 0

    # overrides go to the scenario *builder* so event times scale with them
    overrides = {k: v for k, v in (("duration", args.duration),
                                   ("app", args.app),
                                   ("policy", args.policy),
                                   ("slo", args.slo)) if v is not None}
    sc = scenarios.get(args.name, seed=args.seed, **overrides)

    # the simulator and the stub engines run on the host
    on_host = args.backend == "sim" or (args.backend == "engine"
                                        and not args.arch) or (
        args.backend == "vector" and args.vector_backend == "numpy")
    device = "host" if on_host else args.device
    cache = cache_from_args(args)
    if args.backend == "sim":
        rt = run_scenario(sc, "sim")
    elif args.backend == "vector":
        from repro_torch.vector import VectorConfig
        rt = run_scenario(sc, args.backend,
                          vector_config=VectorConfig(
                              device=args.device,
                              backend=args.vector_backend,
                              devices=args.vector_devices),
                          cache=cache)
    elif args.arch:
        from repro_torch.scenarios.backends import \
            run_experiment_on_real_engines
        rt = run_experiment_on_real_engines(
            sc.compile(), arch=args.arch, smoke=args.smoke,
            max_batch=args.max_batch, prompt_len=args.prompt_len,
            max_new_tokens=args.max_new, seed=args.seed,
            time_scale=args.time_scale, device=args.device)
    else:
        if args.time_scale != 1.0:
            # stub service times and recorded latencies are unscaled
            # profile seconds; stretching only the arrivals would
            # distort utilization and SLO accounting
            ap.error("--time-scale requires a real engine (--arch); "
                     "the stub backend runs in virtual time already")
        from repro_torch.scenarios.backends import build_stub_engines
        exp = sc.compile()
        clock = VirtualClock()
        engines, factory = build_stub_engines(exp, clock, args.seed)
        rt = EngineRuntime.from_experiment(
            exp, engines, engine_factory=factory, clock=clock,
            sleep=clock.sleep)
        rt.run()
    _print_report(rt, sc, args.backend, device)
    if cache is not None:
        print(f"cache[{cache.cache_dir}] {cache.stats}")
    if args.csv:
        _write_csv(rt, args.csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
