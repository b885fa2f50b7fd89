"""Where a training step's time goes on the card, at full width and depth.

    python3 scripts/train_breakdown.py [--arch phi3-mini-3.8b|mamba2-1.3b]
        [--seq N] [--steps N]

Builds ``--arch`` in bf16 from seed 0 on the card and runs
``launch.train``'s step (``make_train_step``: remat on, chunked
cross-entropy, AdamW) on its synthetic stream at batch 8 (``--seq``:
phi3 128, mamba2 512).  After one warm-up step, ``--steps`` steps run
with the card synchronised at the boundaries of each part, and each
part's wall is summed:

* ``kernel_forward``: the hand-written kernel's launches in the forward
  pass (flash_attention or ssd_scan: the forward of its
  ``autograd.Function``);
* ``kernel_recompute``: its launches in the backward (the remat
  recompute of each group);
* ``plain_backward``: the kernels' backward, the plain version recomputed
  and differentiated (``ops._plain_grads``);
* ``forward_rest`` and ``backward_rest``: the rest of the forward and of
  the backward (projections, norms, the loss; their gradients and the
  remat recompute of everything but the kernel);
* ``optimizer``: ``adamw_update``;
* ``host``: the step's wall less all of these (batch to the card, the
  Python around them).

The synchronisations slow the step down; its unsynchronised wall is
timed first, over the same number of steps.  Then one step runs under
``torch.profiler``: the card's busy time (the sum of its kernels) and
its idle share of that step's wall, and the kernels by device time.
The record goes to ``chiprun_out/train_breakdown_<arch>.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

SEQ = {"phi3-mini-3.8b": 128, "mamba2-1.3b": 512}
BATCH = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("this script needs a CUDA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention, ops, ssd_scan
    from repro_torch.models import registry as R
    from repro_torch.training import optimizer, train_step
    from repro_torch.training.data import DataConfig, SyntheticLM

    seq = args.seq or SEQ.get(args.arch, 128)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_cfg = optimizer.OptConfig(warmup_steps=2, total_steps=100)
    opt = optimizer.init_opt_state(params, opt_cfg)
    step = train_step.make_train_step(cfg, opt_cfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, BATCH, seq))

    def batch():
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.next_batch().items()}

    params, opt, _ = step(params, opt, batch())          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, opt, m = step(params, opt, batch())
    float(m["loss"])
    plain_step_s = (time.perf_counter() - t0) / args.steps

    parts = dict.fromkeys(("kernel_forward", "kernel_recompute",
                           "plain_backward", "forward", "backward",
                           "optimizer"), 0.0)
    phase = ["forward"]

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[name(a) if callable(name) else name] += \
                time.perf_counter() - t
            return out
        return wrapper

    def kernel_part(_):
        return "kernel_" + ("forward" if phase[0] == "forward"
                            else "recompute")
    fns = (ops.FlashAttentionFn, ops.SSDScanFn)
    real = {"forward": [f.forward for f in fns],
            "plain": ops._plain_grads, "adamw": train_step.adamw_update,
            "loss_fn": train_step.make_loss_fn, "grad": torch.autograd.grad}
    for f in fns:                   # the kernel launches (and their inputs
        f.forward = staticmethod(timed(kernel_part, f.forward))  # kept)
    ops._plain_grads = timed("plain_backward", real["plain"])
    train_step.adamw_update = timed("optimizer", real["adamw"])

    def grad(*a, **kw):
        if phase[0] == "backward":       # the plain backward's own grad
            return real["grad"](*a, **kw)
        phase[0] = "backward"
        try:
            return timed("backward", real["grad"])(*a, **kw)
        finally:
            phase[0] = "forward"

    def make_loss_fn(*a, **kw):
        return timed("forward", real["loss_fn"](*a, **kw))
    torch.autograd.grad = grad
    train_step.make_loss_fn = make_loss_fn
    try:
        split_step = train_step.make_train_step(cfg, opt_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            params, opt, m = split_step(params, opt, batch())
        float(m["loss"])
        wall = time.perf_counter() - t0
    finally:
        for f, fwd in zip(fns, real["forward"]):
            f.forward = staticmethod(fwd)
        ops._plain_grads = real["plain"]
        train_step.adamw_update = real["adamw"]
        train_step.make_loss_fn = real["loss_fn"]
        torch.autograd.grad = real["grad"]
    n = args.steps
    split = {k: v / n * 1e3 for k, v in parts.items()}
    # kernel and plain-backward time sit inside the forward and backward
    split["forward_rest"] = split.pop("forward") - split["kernel_forward"]
    split["backward_rest"] = (split.pop("backward") - split["kernel_recompute"]
                              - split["plain_backward"])
    split["host"] = wall / n * 1e3 - sum(split.values())

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch())
        float(m["loss"])
        prof_wall = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(device_us(e) for e in events) / 1e3                # ms
    top = sorted(events, key=lambda e: -device_us(e))[:15]
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "batch": BATCH,
           "seq": seq, "steps": n, "device": torch.cuda.get_device_name(0),
           "step_ms": plain_step_s * 1e3, "split_step_ms": wall / n * 1e3,
           "split_ms": split, "launches": {
               "flash_attention": flash_attention.flash_attention.launches,
               "ssd_scan": ssd_scan.ssd_scan.launches},
           "profiled_step_ms": prof_wall * 1e3, "device_busy_ms": busy,
           "device_idle_share": 1 - busy / (prof_wall * 1e3),
           "top_kernels_ms": {e.key: device_us(e) / 1e3 for e in top},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{cfg.name}: step {rec['step_ms']:.1f} ms (synchronised split "
          f"{rec['split_step_ms']:.1f} ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"; profiled step {rec['profiled_step_ms']:.1f} ms, device busy "
          f"{busy:.1f} ms, idle {rec['device_idle_share']:.3f}", flush=True)
    for k, v in rec["top_kernels_ms"].items():
        print(f"  {v:9.3f} ms  {k[:110]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"train_breakdown_{args.arch}.json").write_text(
        json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
