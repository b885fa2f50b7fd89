"""Serving launcher: N engine replicas behind the TailBench++ harness.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
      --replicas 2 --qps 4 --duration 10 --prompt-len 128 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
      --replicas 2 --qps 2 --duration 10 --prompt-len 1100 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --replicas 2 --qps 2 --duration 10 --prompt-len 128 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llava-next-mistral-7b --replicas 2 --qps 2 --duration 10 \\
      --prompt-len 128 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
      --smoke --device cpu --duration 3

``--arch`` is any architecture the port registers that serves token
prompts: phi3-mini-3.8b, gemma3-12b, stablelm-3b, command-r-35b,
mamba2-1.3b, the MoE models deepseek-moe-16b (16.9 B parameters, 33.8 GB
in bf16: one card holds it) and mixtral-8x22b (140.6 B: one card holds
its ``--smoke`` form only), the hybrid jamba-1.5-large-398b (397.6 B:
``--smoke`` only) and llava-next-mistral-7b (7.2 B; served without an
image prefix, as the JAX package's engine serves it).  whisper-small, an
encoder-decoder model, is refused: its prefill needs the encoder's input.

Real wall-clock serving of a real model (random weights drawn from
``--seed``, shared by every replica) driven by open-loop clients — the
end-to-end entry point for this paper's kind (latency-critical serving).
Runs on the card unless ``--device cpu``, on ``EngineRuntime``, so
``--scenario`` can replay a canonical or chaos scenario against the
engines (client churn, server join/drain/fail, and the retries,
breakers, admission control and autoscaler of the chaos scenarios are
honored; hedging/slowdown injections are simulator-only and reported as
skipped).

Besides the latency summary it prints one ``serve: {...}`` JSON line:
request latency p50/p95/p99, time to first token, the mean decode step
and prefill, and generated tokens per second of wall time.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core.client import ClientConfig, ConstantQPS
from repro_torch.core.runtime import EngineRuntime


def serving_report(rt: EngineRuntime, wall: float) -> dict:
    """The end-to-end serving metrics of a finished run (milliseconds;
    every engine step ends with the tokens read back to the host, so the
    host clock times the card's work)."""
    s = rt.telemetry.overall()
    engines = [h.engine for h in rt.handles.values()]
    ttft = [c.ttft for e in engines for c in getattr(e, "completed", ())]
    steps = sum(getattr(e, "decode_steps", 0) for e in engines)
    prefills = sum(getattr(e, "prefill_count", 0) for e in engines)
    tokens = sum(getattr(e, "tokens_done", 0) or 0 for e in engines)

    def ms(xs, q):
        return float(np.percentile(xs, q)) * 1e3 if len(xs) else float("nan")

    return {
        "n": s.n, "submitted": rt.submitted, "dropped": rt.dropped,
        "mean_ms": s.mean * 1e3,
        "p50_ms": s.p50 * 1e3, "p95_ms": s.p95 * 1e3, "p99_ms": s.p99 * 1e3,
        "ttft_p50_ms": ms(ttft, 50), "ttft_p99_ms": ms(ttft, 99),
        "decode_steps": steps,
        "decode_step_ms": (sum(getattr(e, "decode_seconds", 0.0)
                               for e in engines) / steps * 1e3
                           if steps else float("nan")),
        "decode_graph_captures": sum(getattr(e, "decode_graph_captures", 0)
                                     for e in engines),
        "decode_graph_replays": sum(getattr(e, "decode_graph_replays", 0)
                                    for e in engines),
        "prefills": prefills,
        "prefill_ms": (sum(getattr(e, "prefill_seconds", 0.0)
                           for e in engines) / prefills * 1e3
                       if prefills else float("nan")),
        "tokens": tokens, "tokens_per_s": tokens / wall if wall else 0.0,
        "wall_s": wall,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cpu = the kernels' plain "
                         "PyTorch versions)")
    # None = "not supplied": lets --scenario reject flags it would ignore
    ap.add_argument("--replicas", type=int, default=None)
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--qps", type=float, default=None)
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--policy", default=None,
                    choices=["round_robin", "jsq", "p2c", "least_connections"])
    ap.add_argument("--scenario", default=None,
                    help="drive a canonical scenario instead of constant-QPS "
                         "clients (see python -m repro_torch.scenarios "
                         "--list)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.scenarios.backends import (build_real_engines,
                                                run_experiment_on_real_engines)

    if args.scenario:
        ignored = [f for f, v in (("--replicas", args.replicas),
                                  ("--clients", args.clients),
                                  ("--qps", args.qps)) if v is not None]
        if ignored:
            ap.error(f"{', '.join(ignored)} cannot be combined with "
                     f"--scenario (the scenario defines fleet and clients)")
        from repro_torch.scenarios import get as get_scenario
        overrides = {k: v for k, v in (("duration", args.duration),
                                       ("policy", args.policy)) if v is not None}
        sc = get_scenario(args.scenario, seed=args.seed, **overrides)
        t0 = time.perf_counter()
        rt = run_experiment_on_real_engines(
            sc.compile(), arch=args.arch, smoke=args.smoke,
            max_batch=args.max_batch, prompt_len=args.prompt_len,
            max_new_tokens=args.max_new, seed=args.seed, device=args.device)
        wall = time.perf_counter() - t0
    else:
        duration = 5.0 if args.duration is None else args.duration
        replicas = 2 if args.replicas is None else args.replicas
        n_clients = 2 if args.clients is None else args.clients
        qps = 20.0 if args.qps is None else args.qps
        engines, _, vocab = build_real_engines(
            args.arch, replicas, smoke=args.smoke,
            max_batch=args.max_batch, prompt_len=args.prompt_len,
            max_new_tokens=args.max_new, seed=args.seed, device=args.device)
        clients = [ClientConfig(i, ConstantQPS(qps / n_clients),
                                end_time=duration, seed=args.seed + i)
                   for i in range(n_clients)]
        rt = EngineRuntime(engines, clients, policy=args.policy or "jsq",
                           duration=duration,
                           prompt_len=args.prompt_len,
                           max_new_tokens=args.max_new,
                           vocab=vocab, seed=args.seed)
        t0 = time.perf_counter()
        rt.run()
        wall = time.perf_counter() - t0
    for inj in rt.unsupported:
        print(f"note: injection {inj.kind}@{inj.at:g}s is simulator-only "
              f"(skipped on the engine backend)")
    s = rt.telemetry.overall()
    print(f"served n={s.n}  mean={s.mean*1e3:.1f}ms  p50={s.p50*1e3:.1f}ms  "
          f"p95={s.p95*1e3:.1f}ms  p99={s.p99*1e3:.1f}ms")
    for cid in rt.telemetry.clients():
        cs = rt.telemetry.client(cid)
        print(f"  client {cid}: n={cs.n} p99={cs.p99*1e3:.1f}ms")
    report = serving_report(rt, wall)
    print("serve: " + json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
