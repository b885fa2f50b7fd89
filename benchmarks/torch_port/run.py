"""Benchmark driver of the port: one function per paper table/figure.

Twin of ``benchmarks/run.py`` on the PyTorch/CUDA port.  Prints
``name,us_per_call,derived`` CSV (one line per benchmark); full result
tables land in ``artifacts/bench_torch/*.csv``.

    PYTHONPATH=src:. python benchmarks/torch_port/run.py

Left out until the port carries what they need: ``roofline_table`` and
``engine_serving``.
"""
from __future__ import annotations

import sys
import traceback


def main() -> None:
    from benchmarks.torch_port import (bench_cache, bench_plan,
                                       fig1_qps_latency,
                                       fig4_equivalence, fig5_multiserver,
                                       fig6_interleaved, fig7_dynamic_qps,
                                       fig8_balancing, fig_batching, hedging)
    benches = [fig1_qps_latency, fig4_equivalence, fig5_multiserver,
               fig6_interleaved, fig7_dynamic_qps, fig8_balancing,
               fig_batching, hedging, bench_plan, bench_cache]
    print("name,us_per_call,derived")
    failures = 0
    for b in benches:
        try:
            rc = b.main()
            # the figures return their derived metric; bench_plan and
            # bench_cache their exit status
            if isinstance(rc, int) and rc:
                raise RuntimeError(f"exit status {rc}")
        except Exception:
            failures += 1
            name = b.__name__.split(".")[-1]
            print(f"{name},-1,FAILED")
            traceback.print_exc()
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
