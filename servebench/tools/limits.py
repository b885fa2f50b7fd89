"""Readings that the output check's limit is set from, in one process.

    python3 servebench/tools/limits.py --workload <cell> --seeds 1,2,3
        [--seconds 12] [--control 3]

For each seed: the weights drawn anew from it (into the same tensors),
a short window of the cell's own traffic at its own rate, and the
comparison that ``run.py`` makes (the same sample: the longest request
and others drawn from the seed).  For the first ``--control`` seeds it
also reads the control: the reference computed in fp8 (every product's
weight and input rounded to float8 e4m3) put in the program's place, at
each compared position the gap of the token it puts first, and that
reading put through the check's verdict in the program's place
(``control_correct``, which has to be false).  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])
from servebench import env  # noqa: E402

env.prepare()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    from servebench import check as C
    from servebench import e2e, harness, spec
    cell = spec.load_cell(args.workload)
    import torch
    if torch.cuda.device_count() < cell.chips:
        sys.exit("servebench: the tools run on the card only")
    seeds = [int(s) for s in args.seeds.split(",")]
    st = harness.setup(cell, seeds[0], "cuda")
    params = st.weights.tree()
    for i, seed in enumerate(seeds):
        if i:
            st.weights.redraw(seed)
        rec = harness.serve(st, cell.rate, args.seconds, seed)
        t = time.perf_counter()
        got = C.compare(cell.config, params, rec, seed,
                        C.sample(rec, seed, cell.check["tokens"]), "cuda",
                        control=i < args.control)
        got["correct"] = C.decide(cell, rec, got)[0]
        if "control_max_logit_gap" in got:
            got["control_correct"] = C.decide(
                cell, rec, dict(got, max_logit_gap=got[
                    "control_max_logit_gap"]))[0]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "attempted": len(rec.arrivals),
                          "served": len(rec.served), **got,
                          "check_s": time.perf_counter() - t,
                          **e2e.end_to_end(list(rec.served.values()))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
