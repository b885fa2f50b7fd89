"""Time the slot-scan kernels alone at chip_smoke's SCAN_CASES, the four
scan launches of the vector path's grids.

Each case goes through ``chip_smoke.check_scan``: the kernel is first
held bit-equal to its plain version, the whole launch and a one-slot
launch (the run fails if they differ), then timed with CUDA events on
cold inputs (median of 10 calls), with its bytes bound and its time a
slot.  One JSON line per case and pass.  ``--e2e N`` then runs the four
grids end to end N times (``chip_smoke.run_grids``, its ``e2e`` lines:
wall time and cells/s).  To compare two builds of ``vector_step.cu``,
run this script from each checkout in one call to the card, in the
order A, B, B, A.

    python3 scripts/scan_timing.py [--passes 2] [--cases 0 2] [--e2e 3]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts <repo>/src on sys.path)

torch = chip_smoke.torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=2,
                    help="times to time every case (default 2)")
    ap.add_argument("--cases", type=int, nargs="*", default=None,
                    help="indices into SCAN_CASES (default all)")
    ap.add_argument("--e2e", type=int, default=0,
                    help="runs of the four grids end to end (default 0)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_timing: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(f"card: {card[0] if card else 'unknown'}", flush=True)
    from repro_torch.kernels import _build
    # run_cells launches the quantile kernel too: built here, not timed
    for name, log in _build.build(("vector_step", "vector_quantiles")).items():
        for line in chip_smoke.ptxas_report(log):
            print(f"  {name}: {line}", flush=True)
    built = chip_smoke.build_grids()
    grids = {name: (progs, seeds) for name, progs, seeds in built}
    cases = [chip_smoke.SCAN_CASES[i] for i in (
        args.cases if args.cases is not None
        else range(len(chip_smoke.SCAN_CASES)))]
    inputs = {key: chip_smoke.scan_case(*grids[grid], torch.device("cuda"))
              for key, grid in cases}
    for n in range(args.passes):
        for key, _ in cases:
            rec = chip_smoke.check_scan(key, *inputs[key], time_plain=False)
            print(json.dumps({"pass": n, "case": key, **rec}), flush=True)
    for n in range(args.e2e):
        _, e2e = chip_smoke.run_grids(built)
        print(json.dumps({"e2e_run": n, **e2e}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
