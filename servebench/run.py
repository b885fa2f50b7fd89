"""Run one cell of the serving benchmark once.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

From the root of a checkout: draws the cell's weights on the card from
``--seed``, builds and warms its replicas (set-up), serves the mix for
``--seconds`` through ``repro_torch``'s ``EngineRuntime`` and drains
it, checks what was served against the plain reference, and prints one
JSON line last on standard output.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a traced
run (``torch.profiler`` over the window's last fifth).

It needs an NVIDIA card; without one it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this script's folder, whose modules
# would shadow the standard library's (``trace``)
sys.path[0] = str(Path(__file__).resolve().parents[1])
from servebench import env  # noqa: E402

env.prepare()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from servebench import spec
    from servebench.guard import fail
    try:
        cell = spec.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        return fail(f"cannot load {args.workload}: {e}")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} present")
    from servebench import run_cell
    return run_cell.run(cell, args, T_START)


if __name__ == "__main__":
    sys.exit(main())
