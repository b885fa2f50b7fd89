"""Time the ssd_scan kernel alone at chip_smoke's SSD_CASES, with the
device time of each of its launches.

Each case goes through ``chip_smoke.check_ssd``: the kernel is first
held to its plain version (the run fails if they disagree), then timed
with CUDA events on cold inputs beside the plain version, with both of
its bounds.  Then one call of the kernel runs under ``torch.profiler``,
which gives each launch's device time (the chunk states, state passing
and chunk outputs; a build with one launch shows one).  One JSON line per
case and pass.  To compare two builds of the kernel, run this script
from each checkout in one call to the card, in the order A, B, B, A.

    python3 scripts/ssd_timing.py [--passes 2] [--cases 0 2]
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts <repo>/src on sys.path)

torch = chip_smoke.torch


def launch_times(b, s, h, p, n, chunk, dtype) -> dict:
    """{kernel name: device us} of one ``ops.ssd_scan`` call (after a
    warm-up call) on inputs of the case's shape."""
    from repro_torch.kernels import ops
    et = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    x, B, C = rnd(b, s, h, p).to(et), rnd(b, s, 1, n).to(et), \
        rnd(b, s, 1, n).to(et)
    dt = torch.nn.functional.softplus(rnd(b, s, h) - 4.6)
    A = -torch.exp(1.386 + 0.5 * rnd(h))
    ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "ssd_scan" in e.key and e.self_device_time_total > 0):
            m = re.search(r"ssd_scan\w*kernel(<[^>]*>)?", e.key)
            name = m.group() if m else e.key[:60]
            out[name] = out.get(name, 0.0) + e.self_device_time_total
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=2,
                    help="times to time every case (default 2)")
    ap.add_argument("--cases", type=int, nargs="*", default=None,
                    help="indices into SSD_CASES (default all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_timing: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(f"card: {card[0] if card else 'unknown'}", flush=True)
    cases = [chip_smoke.SSD_CASES[i] for i in (
        args.cases if args.cases is not None
        else range(len(chip_smoke.SSD_CASES)))]
    for n in range(args.passes):
        for case in cases:
            rec = chip_smoke.check_ssd("cuda", *case)
            print(json.dumps({"pass": n, "case": case[0], **{
                key: rec.get(key) for key in (
                    "ms", "plain_ms", "bound_ms", "f32_core_bound_ms",
                    "bound_used_y", "bound_used_hN")},
                "launch_us": launch_times(*case[1:])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
