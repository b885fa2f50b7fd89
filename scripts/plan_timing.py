"""Time the planner's optimizer loop on the card: ms a step of the
surrogate's value and gradient, Adam and the box projection, as
``run_plan`` takes them on bench_plan's FULL problem.

Each pass runs ``run_plan`` with the exact ladder off (``verify=False``)
twice, at ``--steps`` optimizer steps and at 0, one start each; the
difference of the two walls (host clock, card synchronised) over the
steps is the ms a step, with the plan data's build and the final
evaluation taken out.  One JSON line per pass.  Only ``PlanSpec`` and
``run_plan`` are used, so the script times any checkout of the port: to
compare two, run it from each in one call to the card, in the order A,
B, B, A.

    python3 scripts/plan_timing.py [--passes 2] [--steps 150] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmarks.torch_port.bench_plan import (FULL, SEED,  # noqa: E402
                                              _overrides)
from repro_torch.plan import PlanSpec, run_plan  # noqa: E402
from repro_torch.vector import VectorConfig  # noqa: E402


def _wall(steps: int, device: str) -> float:
    spec = PlanSpec(scenario="steady", objective="p99", slo=FULL["slo"],
                    overrides=_overrides(FULL), steps=steps, starts=1,
                    samples=FULL["samples"], seed=SEED, verify=False)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_plan(spec, vector_config=VectorConfig(device=device))
    if device == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("plan_timing: no CUDA device", file=sys.stderr)
        return 2
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    _wall(2, args.device)                      # warm-up: build, first launches
    for i in range(args.passes):
        full = _wall(args.steps, args.device)
        base = _wall(0, args.device)
        print(json.dumps({
            "root": str(ROOT), "pass": i, "device": args.device,
            "card": card, "steps": args.steps, "wall_s": full,
            "wall_0_steps_s": base,
            "ms_a_step": (full - base) * 1e3 / args.steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
