"""Where the time of one serving engine step goes, on the card.

    python3 scripts/serving_breakdown.py
        [--arch phi3-mini-3.8b|mamba2-1.3b|gemma3-12b|deepseek-moe-16b]
        [--device cuda|cpu] [--smoke] [--layers N] [--steps N]

Builds ``--arch`` (phi3-mini-3.8b by default) at full width (random
weights from a seed, bf16, as ``launch.serve`` serves it; ``--layers``
cuts the depth, ``--smoke`` takes the CPU-test config) in one
``InferenceEngine`` with the serving run's shape (``chip_smoke.py``: max
batch 4, 32 new tokens, 128-token prompts for phi3 and deepseek-moe,
512-token ones for mamba2 and 1100-token ones for gemma3, past its
1024-token window),
fills its four slots, and reports:

* the host-clock time of a prefill and of a batch-4 decode step (median
  of ``--steps``; every step ends with the tokens read back to the host,
  so it covers the card's work);
* the host phases of the decode steps, from ``cProfile`` (cumulative
  seconds of the port's own functions: norms, projections, RoPE, the
  attention wrapper, the MLP, for mamba2 the mixer's projections, conv
  steps and output, for deepseek-moe the MoE layer with its router and
  expert products, the unembedding, the read-back; the rest of the step
  total is the cache write, the residual adds and the embedding);
* on the card, the device time of the decode steps and of a prefill by
  kernel group (attention and SSD kernels, matrix products, the rest)
  from ``torch.profiler``, the kernels launched per step and the
  device's busy share of the step's wall time;
* the decode step's bound: the bf16 weights read once, over the card's
  memory rate (for an MoE model every expert bank: the dispatch form
  runs every expert on its capacity slots, filled or not).

The record goes to ``chiprun_out/serving_breakdown.json``
(``serving_breakdown_<arch>.json`` for the other archs).  cProfile
adds a cost per Python call, so its phase times are shares, not
absolutes: the step times are taken with profiling off.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: H100 SXM device memory rate (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
NEW, MAX_BATCH = 32, 4
#: the prompt length of each arch's serving run in chip_smoke.py
PROMPT = {"phi3-mini-3.8b": 128, "mamba2-1.3b": 512, "gemma3-12b": 1100,
          "deepseek-moe-16b": 128}
#: (module suffix, function) of the port whose cumulative time is a phase
PHASES = {
    ("models/layers.py", "apply_norm"): "norms",
    ("models/attention.py", "_proj_qkv"): "qkv projection",
    ("models/layers.py", "rms_norm"): "qk norms (inside the qkv projection)",
    ("models/layers.py", "rope"): "rope",
    ("kernels/ops.py", "decode_attention"): "attention (wrapper + kernel)",
    ("models/attention.py", "_out_proj"): "output projection",
    ("models/layers.py", "apply_mlp"): "mlp",
    ("models/mamba.py", "_project"): "mamba projections",
    ("models/mamba.py", "_conv_step"): "mamba conv steps",
    ("models/mamba.py", "_out"): "mamba gate, norm, output projection",
    ("models/mamba.py", "decode_mamba"): "mamba mixer (total)",
    ("models/moe.py", "apply_moe"): "moe (total)",
    ("models/moe.py", "_router"): "moe router",
    ("models/moe.py", "_expert_ffn"): "moe expert products",
    ("models/layers.py", "unembed"): "unembedding",
    ("serving/engine.py", "_decode_once"): "step total",
}
#: tensor methods whose cumulative time is a phase of the decode step
METHODS = {"cpu": "read-back (waits for the card)"}


def host_phases(fn) -> dict:
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    out = dict.fromkeys(list(PHASES.values()) + list(METHODS.values()),
                        0.0)
    for (path, _line, func), row in pstats.Stats(prof).stats.items():
        for (suffix, name), phase in PHASES.items():
            if func == name and path.endswith(suffix) \
                    and "repro_torch" in path:
                out[phase] += row[3]             # cumulative seconds
        for name, phase in METHODS.items():
            if path == "~" and func.startswith(f"<method '{name}' of "
                                               f"'torch._C"):
                out[phase] += row[3]
    return out


def group(name: str) -> str:
    n = name.lower()
    if any(s in n for s in ("decode_logits", "decode_pv", "decode_combine")):
        return "decode_attention kernels"
    if "flash_attention" in n:
        return "flash_attention kernel"
    if "ssd_scan" in n:
        return "ssd_scan kernel"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "cutlass", "xmma",
                            "matmul", "splitk")):
        return "matrix products (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    return "elementwise, norms, reductions"


def device_time(fn) -> tuple:
    """({group: device us}, kernels launched, [(us, count, kernel)] of
    the 12 longest kernels) for one call, from torch.profiler:
    device-side events only."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out, n, rows = {}, 0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.self_device_time_total > 0:
            g = group(e.key)
            out[g] = out.get(g, 0.0) + e.self_device_time_total
            n += e.count
            rows.append((e.self_device_time_total, e.count, e.key[:120]))
    return out, n, sorted(rows, reverse=True)[:12]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b",
                    choices=sorted(PROMPT))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import param as P
    from repro_torch.models import registry as R
    from repro_torch.serving.engine import InferenceEngine

    device = resolve_device(args.device)
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    prompt = PROMPT[args.arch]
    if args.layers:
        cfg = replace(cfg, num_layers=args.layers)
    params = R.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    weight_bytes = sum(t.numel() * t.element_size()
                       for _, t in P.leaves(params))
    eng = InferenceEngine(cfg, params, max_batch=MAX_BATCH,
                          max_len=prompt + NEW + 32)
    rng = np.random.default_rng(args.seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # warm-up request (kernel build and load), then fill every slot
    eng.submit(rng.integers(0, cfg.vocab_size, prompt), 2, -1)
    eng.run_until_idle()
    prefill_s = []
    for i in range(MAX_BATCH):
        eng.submit(rng.integers(0, cfg.vocab_size, prompt), 10 ** 6, i)
        sync()
        t0 = time.perf_counter()
        eng.step()
        prefill_s.append(time.perf_counter() - t0)
    steps = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        eng.step()                           # ends with the read-back
        steps.append(time.perf_counter() - t0)
    step_s = statistics.median(steps)
    n_prof = 5

    def decode_steps():
        for _ in range(n_prof):
            eng.step()

    record = {"device": (torch.cuda.get_device_name(0)
                         if device.type == "cuda" else "cpu"),
              "arch": cfg.name, "num_layers": cfg.num_layers,
              "params": R.count_params(cfg), "weight_bytes": weight_bytes,
              "max_batch": MAX_BATCH, "prompt": prompt,
              "cache_len": eng.max_len,
              "prefill_s": prefill_s, "decode_step_s": step_s,
              "decode_steps_s": steps,
              "decode_bound_s": weight_bytes / HBM_BYTES_PER_S,
              "host_phases_s_per_step": {
                  k: v / n_prof for k, v in host_phases(decode_steps).items()}}
    print(f"{cfg.name} ({cfg.num_layers} layers, {weight_bytes / 1e9:.2f} "
          f"GB of weights) on {record['device']}: prefill {prompt} tokens "
          f"{statistics.median(prefill_s) * 1e3:.2f} ms, decode step "
          f"(batch {MAX_BATCH}) {step_s * 1e3:.2f} ms, bound "
          f"{record['decode_bound_s'] * 1e3:.3f} ms", flush=True)
    for k, v in sorted(record["host_phases_s_per_step"].items(),
                       key=lambda kv: -kv[1]):
        print(f"  host {v * 1e3:8.3f} ms/step  {k}")
    if device.type == "cuda":
        dev, n, top = device_time(decode_steps)
        record["decode_top_kernels_us"] = top
        busy = sum(dev.values()) / 1e6 / n_prof
        record["decode_device_s_by_group"] = {
            k: v / 1e6 / n_prof for k, v in dev.items()}
        record["decode_device_s"] = busy
        record["decode_kernels_per_step"] = n / n_prof
        record["decode_device_busy_share"] = busy / step_s
        print(f"  device {busy * 1e3:.3f} ms/step busy "
              f"({busy / step_s:.1%} of the step), {n / n_prof:.0f} "
              f"kernels/step", flush=True)
        for k, v in sorted(record["decode_device_s_by_group"].items(),
                           key=lambda kv: -kv[1]):
            print(f"    {v * 1e3:8.3f} ms/step  {k}")
        for us, count, name in top:
            print(f"      {us / 1e3 / n_prof:8.3f} ms/step  "
                  f"x{count // n_prof}  {name}")
        # one more prefill, into a slot freed by hand
        eng.active[0] = None
        eng.submit(rng.integers(0, cfg.vocab_size, prompt), 2, 99)
        dev, n, top = device_time(eng.step)
        record["prefill_top_kernels_us"] = top
        record["prefill_device_s_by_group"] = {k: v / 1e6
                                               for k, v in dev.items()}
        record["prefill_kernels"] = n
        total = sum(dev.values())
        record["prefill_ssd_share"] = dev.get("ssd_scan kernel", 0.0) / total
        record["prefill_flash_share"] = dev.get("flash_attention kernel",
                                                0.0) / total
        print(f"  prefill device {total / 1e3:.3f} ms, {n} kernels, "
              f"ssd_scan {record['prefill_ssd_share']:.1%}, flash_attention "
              f"{record['prefill_flash_share']:.1%}", flush=True)
        for k, v in sorted(dev.items(), key=lambda kv: -kv[1]):
            print(f"    {v / 1e3:8.3f} ms  {k}")
        for us, count, name in top:
            print(f"      {us / 1e3:8.3f} ms  x{count}  {name}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = ("serving_breakdown.json" if args.arch == "phi3-mini-3.8b"
            else f"serving_breakdown_{args.arch}.json")
    (out / name).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
