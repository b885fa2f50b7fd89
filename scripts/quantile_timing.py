"""Time the fused-quantile kernel alone at chip_smoke's QUANTILE_CASES,
the first quantile launch of each of the vector path's four grids, and
at its synthetic edge case.

Each case goes through ``chip_smoke.check_quantiles``: the kernel is
first held bit-equal to its plain version (the run fails if they
differ), then timed with CUDA events on cold inputs (median of 10
calls), with the bytes bound of the samples its counts hold and of the
full matrix.  One JSON line per case and pass.  To compare two builds of
``vector_quantiles.cu``, run this script from each checkout in one call
to the card, in the order A, B, B, A (an older checkout takes this
script and ``chip_smoke.py`` copied in, so that only ``src/`` differs).

    python3 scripts/quantile_timing.py [--passes 2] [--plain]
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
    ap.add_argument("--plain", action="store_true",
                    help="also time the plain version and torch.sort")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("quantile_timing: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(f"card: {card[0] if card else 'unknown'}", flush=True)
    from repro_torch.kernels import _build
    # run_cells launches the scan kernels too: built here, not timed
    for name, log in _build.build(("vector_step", "vector_quantiles")).items():
        for line in chip_smoke.ptxas_report(log):
            print(f"  {name}: {line}", flush=True)
    device = torch.device("cuda")
    grids = {name: (progs, seeds)
             for name, progs, seeds in chip_smoke.build_grids()}
    inputs = {key: chip_smoke.quantile_case(*grids[grid], device)
              for key, grid in chip_smoke.QUANTILE_CASES}
    inputs[chip_smoke.QUANTILE_SYNTHETIC] = \
        chip_smoke.synthetic_quantiles(device)
    for n in range(args.passes):
        for key, (L, N) in inputs.items():
            rec = chip_smoke.check_quantiles(key, L, N,
                                             time_plain=args.plain)
            print(json.dumps({"pass": n, "case": key, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
