"""Roofline table over the port's dry-run results (the one-card mesh).

Twin of ``benchmarks/roofline_table.py`` on ``repro_torch.launch.roofline``
(``analyze``, ``load_results``): one row per (arch x shape) with the
three terms on one H100's datasheet figures, the dominant one and the
useful-FLOPs ratio.  The results come from ``python -m
repro_torch.launch.dryrun --all`` (``artifacts/dryrun_torch/``); with
none there it reports ``cells=0``.

    PYTHONPATH=src:. python benchmarks/torch_port/roofline_table.py
"""
from __future__ import annotations

import time

from benchmarks.torch_port.common import emit
from repro_torch.launch.roofline import analyze, load_results


def main() -> str:
    t0 = time.time()
    rows = []
    dominated = {"compute": 0, "memory": 0, "collective": 0}
    for r in load_results(multi_pod=False):
        a = analyze(r)
        dominated[a.dominant] += 1
        rows.append({
            "arch": a.arch, "shape": a.shape,
            "compute_s": f"{a.compute_s:.4e}", "memory_s": f"{a.memory_s:.4e}",
            "collective_s": f"{a.collective_s:.4e}", "dominant": a.dominant,
            "model_flops": f"{a.model_flops:.3e}",
            "hlo_flops": f"{a.hlo_flops:.3e}",
            "useful_ratio": f"{a.useful_ratio:.3f}",
            "roofline_fraction": f"{a.roofline_fraction:.3f}",
        })
    n = len(rows)
    emit("roofline_table", rows, t0,
         f"cells={n};compute={dominated['compute']};"
         f"memory={dominated['memory']};collective={dominated['collective']}")
    return f"cells={n}"


if __name__ == "__main__":
    main()
