"""Time the decode_attention kernel alone at chip_smoke's DECODE_CASES.

Each case goes through ``chip_smoke.check_decode``: the kernel is first
held to its plain version (the run fails if they disagree), then timed
with CUDA events on cold inputs beside the plain version and SDPA, with
its bound.  One JSON line per case and pass is printed.  The quickest way
to compare two builds of the kernel: run this script from each checkout
in one call to the card, in the order A, B, B, A, since clocks and the
host's load vary between machines.

    python3 scripts/decode_timing.py [--passes 2]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=2,
                    help="times to time every case (default 2)")
    args = ap.parse_args()
    if not chip_smoke.torch.cuda.is_available():
        print("decode_timing: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(f"card: {card[0] if card else 'unknown'}", flush=True)
    for n in range(args.passes):
        for case in chip_smoke.DECODE_CASES:
            rec = chip_smoke.check_decode("cuda", *case)
            print(json.dumps({"pass": n, "case": case[0], **{
                key: rec.get(key) for key in (
                    "ms", "plain_ms", "library_ms", "bound_ms",
                    "full_cache_bound_ms", "max_abs_err")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
