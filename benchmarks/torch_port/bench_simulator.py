"""Event-engine throughput benchmark of the port: calendar-queue engine
vs seed heap.

Twin of ``benchmarks/bench_simulator.py`` on the port's event engine
(``repro_torch.core.simulator``, on the host) against its own frozen
seed engine (``benchmarks/torch_port/_seed_sim.py``).  It writes
``BENCH_simulator_torch.json`` (``--smoke``:
``BENCH_simulator_torch.smoke.json``), never the reference's record.

Runs the same open-loop multi-client scenario on the rebuilt engine
(``repro_torch.core.simulator``) and on a frozen copy of the seed engine
(``benchmarks/_seed_sim.py``) at 10 / 100 / 1k / 10k servers, targeting
1M requests, and writes ``BENCH_simulator_torch.json`` at the repo root with
events/sec and peak RSS per run.

Both engines run with identical exact-mode recorders for the speed
comparison (equal stats cost); the calendar engine is additionally
measured with the streaming P²/reservoir recorder to show the bounded-
memory path, and a ``batched`` row runs the continuous-batching serve
loop (BatchedService op events) at every scale so the batched hot path
is perf-gated alongside the scalar one.  The calendar rows run with ``fast_clients`` (the rebuilt
engine's vectorized arrival path), so the reported speedup is the whole
rebuilt request path — event queue + client generation — not the
calendar queue in isolation.  The seed engine's O(n_servers) per-request scan makes full
1M-request runs intractable at scale, so its request count is capped per
scale and throughput compared as a rate (the cap is recorded in the
JSON).  Each run executes in its own subprocess so peak-RSS figures are
per-scenario, not cumulative.

Usage:
    PYTHONPATH=src python benchmarks/torch_port/bench_simulator.py            # full
    PYTHONPATH=src python benchmarks/torch_port/bench_simulator.py --quick
    PYTHONPATH=src python benchmarks/torch_port/bench_simulator.py --smoke --check 1.1
    PYTHONPATH=src python benchmarks/torch_port/bench_simulator.py \
        --single calendar 1000 1000000 exact                       # one run

``--smoke`` is the CI regression gate: small scales, and with
``--check MIN`` the run exits non-zero if the calendar engine's
events/sec advantage over the seed engine at the largest scale falls
below MIN or the exact-mode equivalence check fails — engine-perf
regressions fail CI instead of only showing up in BENCH_simulator_torch.json.
Smoke runs write ``BENCH_simulator_torch.smoke.json`` instead, so the
committed full-scale record at the repo root is never clobbered by a
CI-scale run.
"""
from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                    ".."))
if REPO not in sys.path:          # `import benchmarks...` from a subprocess
    sys.path.insert(0, REPO)

from benchmarks.torch_port._record import write_record  # noqa: E402

DURATION = 90.0           # sim horizon (virtual seconds)
TARGET_SPAN = 55.0        # virtual seconds the offered load is spread over
# seed engine request caps per server count (O(n) scan per request)
SEED_CAP = {10: 300_000, 100: 150_000, 1000: 50_000, 10_000: 15_000}
# batched-row request cap per server count: 10 batched servers sustain
# ~10k req/s with the bench BatchedService, so the full 1M-request load
# (~18k req/s offered) can never finish inside the horizon — cap the
# offered load below capacity and compare throughput as a rate, exactly
# like the seed caps above
BATCHED_CAP = {10: 400_000}


def n_clients_for(servers: int) -> int:
    return min(2000, max(8, servers // 4))


def build(engine: str, servers: int, requests: int, stats_mode: str,
          fast_clients: bool = False):
    from repro_torch.core.balancer import RoundRobin
    from repro_torch.core.client import ClientConfig, ConstantQPS
    from repro_torch.core.profiles import (BatchedService, FixedProfile,
                                     TokenLengths, tailbench_profile)
    from repro_torch.core.simulator import SimConfig, SimServer, Simulator

    ncl = n_clients_for(servers)
    budget = max(1, requests // ncl)
    qps = (requests / TARGET_SPAN) / ncl
    # gauges off: the A/B measures the event engine, and the vendored seed
    # engine predates the telemetry sampler
    cfg = SimConfig(duration=DURATION, seed=7, stats_mode=stats_mode,
                    fast_clients=fast_clients, gauges=False)
    profile = tailbench_profile("masstree")
    clients = [ClientConfig(i, ConstantQPS(qps), seed=i + 1,
                            total_requests=budget) for i in range(ncl)]
    if engine == "calendar":
        sim = Simulator(cfg, [SimServer(i) for i in range(servers)],
                        RoundRobin(), profile=profile)
    elif engine == "batched":
        # continuous-batching serve loop: same arrival machinery, but
        # servers run BatchedService op events (prefill + decode steps)
        # instead of per-request finish events — the serve-loop hot path
        # this row perf-gates
        service = BatchedService("bench", t_memory=5e-4,
                                 t_compute_per_seq=6.25e-5,
                                 t_prefill_per_token=1e-5)
        lengths = TokenLengths(prompt_median=32, prompt_sigma=0.4,
                               new_median=8, new_sigma=0.4,
                               prompt_max=128, new_max=32)
        sim = Simulator(cfg, [SimServer(i, service_model=service,
                                        max_batch=8)
                              for i in range(servers)],
                        RoundRobin(), profile=FixedProfile("tok", 0.0),
                        lengths=lengths, service_model=service)
    elif engine == "seed":
        from benchmarks.torch_port._seed_sim import SeedSimServer, SeedSimulator
        sim = SeedSimulator(cfg, [SeedSimServer(i) for i in range(servers)],
                            RoundRobin(), profile=profile)
    else:
        raise ValueError(engine)
    for c in clients:
        sim.add_client(c)
    return sim


def run_single(engine: str, servers: int, requests: int,
               stats_mode: str) -> dict:
    import gc
    # identical conditions for both engines: no GC pauses mid-measurement
    gc.disable()
    sim = build(engine, servers, requests, stats_mode,
                fast_clients=(engine == "calendar"))
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    s = sim.recorder.overall()
    return {
        "engine": engine,
        "servers": servers,
        "clients": n_clients_for(servers),
        "requests": requests,
        "completed": s.n,
        "events": sim.events,
        "wall_s": round(wall, 3),
        "events_per_sec": round(sim.events / wall) if wall > 0 else None,
        "peak_rss_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1),
        "stats_mode": stats_mode,
        "p99_ms": round(s.p99 * 1e3, 4),
    }


def spawn(engine: str, servers: int, requests: int, stats_mode: str,
          repeats: int = 1) -> dict:
    """One scenario in a fresh subprocess (isolated peak RSS).

    ``repeats`` reruns the scenario and keeps the fastest row: events/sec
    noise from neighbor contention is strictly one-sided (contention only
    slows a run down), so best-of-N is the fair estimate of engine speed
    — the speedup-comparison rows use it so the recorded ratios are not
    artifacts of whichever row drew the noisier seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    print(f"  {engine:>8} servers={servers:<6} requests={requests:<8} "
          f"mode={stats_mode} ...", file=sys.stderr, flush=True)
    best = None
    for _ in range(max(1, repeats)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--single",
             engine, str(servers), str(requests), stats_mode],
            cwd=REPO, env=env, capture_output=True, text=True, check=True)
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        if best is None or row["events_per_sec"] > best["events_per_sec"]:
            best = row
    print(f"           -> {best['events_per_sec']:,} events/s, "
          f"{best['peak_rss_mb']} MB peak RSS, {best['wall_s']}s",
          file=sys.stderr, flush=True)
    return best


def equivalence_check() -> dict:
    """Both engines, same small config, exact mode: results must match."""
    a = build("calendar", 20, 20_000, "exact")
    b = build("seed", 20, 20_000, "exact")
    a.run()
    b.run()
    sa, sb = a.recorder.overall(), b.recorder.overall()
    identical = (a.recorder.all == b.recorder.all)
    return {"servers": 20, "requests": 20_000,
            "calendar": [sa.n, sa.p50, sa.p95, sa.p99],
            "seed": [sb.n, sb.p50, sb.p95, sb.p99],
            "identical": identical}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--single"]:
        engine, servers, requests, stats_mode = argv[1:5]
        row = run_single(engine, int(servers), int(requests), stats_mode)
        print(json.dumps(row))
        return 0

    quick = "--quick" in argv
    smoke = "--smoke" in argv
    check = None
    if "--check" in argv:
        check = float(argv[argv.index("--check") + 1])
    if smoke:
        requests, scales = 60_000, [10, 100]
    elif quick:
        requests, scales = 200_000, [10, 100, 1000]
    else:
        requests, scales = 1_000_000, [10, 100, 1000, 10_000]

    print(f"bench_simulator: scales={scales} target_requests={requests}",
          file=sys.stderr)
    # best-of-3 on the speedup-comparison rows for full runs; smoke/quick
    # trade precision for CI latency (their gate floor has a wide margin)
    reps = 1 if (smoke or quick) else 3
    rows = []
    for s in scales:
        rows.append(spawn("calendar", s, requests, "exact", repeats=reps))
        rows.append(spawn("seed", s, min(requests, SEED_CAP[s]), "exact",
                          repeats=reps))
        rows.append(spawn("batched", s, min(requests, BATCHED_CAP.get(s, requests)),
                          "exact"))
    for s in [x for x in (1000, 10_000) if x in scales]:
        rows.append(spawn("calendar", s, requests, "streaming"))

    speedup = {}
    for s in scales:
        cal = next(r for r in rows if r["engine"] == "calendar"
                   and r["servers"] == s and r["stats_mode"] == "exact")
        seed = next(r for r in rows if r["engine"] == "seed"
                    and r["servers"] == s)
        speedup[str(s)] = round(cal["events_per_sec"] / seed["events_per_sec"], 2)

    print("bench_simulator: running exact-mode equivalence check ...",
          file=sys.stderr)
    equiv = equivalence_check()

    at_1k = speedup.get("1000")
    top = str(max(scales))
    # continuous-batching serve loop, perf-gated like the scalar path:
    # the batched row must complete its full request budget and keep its
    # events/sec within a floor fraction of the scalar calendar engine
    # at the same scale (its events are decode/prefill ops, so absolute
    # rates are comparable but not identical)
    BATCHED_REL_FLOOR = 0.15
    batched_rel = {}
    batched_complete = True
    for s in scales:
        cal = next(r for r in rows if r["engine"] == "calendar"
                   and r["servers"] == s and r["stats_mode"] == "exact")
        bat = next(r for r in rows if r["engine"] == "batched"
                   and r["servers"] == s)
        batched_rel[str(s)] = round(
            bat["events_per_sec"] / cal["events_per_sec"], 3)
        if bat["completed"] != bat["requests"]:
            batched_complete = False
    out = {
        "benchmark": "bench_simulator",
        "scenario": {"duration_s": DURATION, "target_span_s": TARGET_SPAN,
                     "app": "masstree", "policy": "round_robin",
                     "seed_engine_request_caps": SEED_CAP,
                     "batched_request_caps": BATCHED_CAP},
        "rows": rows,
        "speedup_vs_seed_events_per_sec": speedup,
        "acceptance": {"speedup_at_1000_servers": at_1k,
                       "meets_5x": bool(at_1k and at_1k >= 5.0),
                       "exact_mode_bit_identical": equiv["identical"],
                       "batched_completed_all": batched_complete,
                       "batched_rel_events_per_sec": batched_rel,
                       "batched_rel_floor": BATCHED_REL_FLOOR},
        "equivalence_check": equiv,
    }
    write_record("simulator", out, smoke)
    print(json.dumps(out["acceptance"], indent=1))
    print(f"speedup vs seed engine: {speedup}")
    if check is not None:
        ok = True
        if not equiv["identical"]:
            print("CHECK FAILED: exact-mode results diverge from the seed "
                  "engine", file=sys.stderr)
            ok = False
        if speedup[top] < check:
            print(f"CHECK FAILED: speedup at {top} servers is "
                  f"{speedup[top]}x < required {check}x", file=sys.stderr)
            ok = False
        if not batched_complete:
            print("CHECK FAILED: batched serve loop did not complete its "
                  "request budget", file=sys.stderr)
            ok = False
        if batched_rel[top] < BATCHED_REL_FLOOR:
            print(f"CHECK FAILED: batched events/sec at {top} servers is "
                  f"{batched_rel[top]}x the scalar engine < floor "
                  f"{BATCHED_REL_FLOOR}x", file=sys.stderr)
            ok = False
        if not ok:
            return 1
        print(f"check passed: speedup@{top}={speedup[top]}x >= {check}x, "
              f"exact mode bit-identical, batched@{top}="
              f"{batched_rel[top]}x >= {BATCHED_REL_FLOOR}x")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
