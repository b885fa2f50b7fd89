"""The knee sweep of one cell: its mix at a ladder of offered rates, in
one process (one set-up), each for ``--seconds``.

    python3 servebench/tools/sweep.py --workload <cell> --rates 2,3,4
        [--seconds 20] [--seed 1]

Prints one JSON line a rate: requests due and served, how long the
drain ran past the window, the end-to-end metrics and the runtime's
per-interval queue depth (summed over replicas).  A rate is sustained
when the queue does not grow over the window and the drain is short.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])
from servebench import env  # noqa: E402

env.prepare()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    from servebench import e2e, harness, spec
    cell = spec.load_cell(args.workload)
    import torch
    if torch.cuda.device_count() < cell.chips:
        sys.exit("servebench: the tools run on the card only")
    st = harness.setup(cell, args.seed, "cuda")
    for rate in (float(r) for r in args.rates.split(",")):
        rec = harness.serve(st, rate, args.seconds, args.seed)
        served = list(rec.served.values())
        q = [d for _, d in rec.frames]
        third = max(len(q) // 3, 1)
        print(json.dumps({
            "workload": args.workload, "rate": rate,
            "attempted": len(rec.arrivals), "served": len(served),
            "drain_s": max((r.done for r in served), default=0.0)
            - args.seconds,
            "queue_first_third": sum(q[:third]) / third,
            "queue_last_third": sum(q[-third:]) / third,
            "queue_depth": q, **e2e.end_to_end(served),
            "prefill_s": sum(e["prefill_seconds"] for e in rec.engines),
            "decode_s": sum(e["decode_seconds"] for e in rec.engines)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
