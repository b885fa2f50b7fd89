"""Render the dry-run and roofline tables from the port's dry-run results.

Copy of ``repro.launch.render``.  "fits" is judged against one H100's
80 GB (``HBM_BYTES``), where the reference judges a v5e chip's 16 GB.
A production-mesh result records its argument bytes only (no temp
figure), so its temp reads 0.00 and "fits" judges the arguments alone.
``main`` renders both tables between their ``<!-- DRYRUN_TABLE -->`` and
``<!-- ROOFLINE_TABLE -->`` markers in ``artifacts/dryrun_torch/
DRYRUN.md`` (made with both markers when absent), not the reference's
``EXPERIMENTS.md``.

    PYTHONPATH=src python -m repro_torch.launch.render
"""
from __future__ import annotations

import json
import os
import re

from repro_torch.launch.roofline import ARTIFACT_DIR, analyze

#: one H100's memory (80 GB HBM3, datasheet), in GiB as the table reads
HBM_BYTES = 80e9
DOC = os.path.join(ARTIFACT_DIR, "DRYRUN.md")


def _load(tag: str) -> list:
    out = []
    if not os.path.isdir(ARTIFACT_DIR):
        return out
    for f in sorted(os.listdir(ARTIFACT_DIR)):
        if f.endswith(f"_{tag}.json"):
            with open(os.path.join(ARTIFACT_DIR, f)) as fh:
                out.append(json.load(fh))
    return out


def dryrun_table() -> str:
    rows = ["| arch | shape | mesh | strategy | compile (s) | args GiB/chip | temp GiB/chip | fits 80G |",
            "|---|---|---|---|---|---|---|---|"]
    for r in _load("card") + _load("pod") + _load("multipod"):
        mem = r["memory"]
        args_g = mem.get("argument_size_in_bytes", 0) / 2**30
        temp_g = mem.get("temp_size_in_bytes", 0) / 2**30
        fits = "yes" if args_g + temp_g < HBM_BYTES / 2**30 else "**no**"
        mesh = "x".join(str(x) for x in r["mesh"])
        rows.append(f"| {r['arch']} | {r['shape']} | {mesh} | {r.get('strategy','')} "
                    f"| {r['compile_s']} | {args_g:.2f} | {temp_g:.2f} | {fits} |")
    return "\n".join(rows)


def roofline_table() -> str:
    rows = ["| arch | shape | compute (s) | memory (s) | collective (s) | dominant | useful | roofline |",
            "|---|---|---|---|---|---|---|---|"]
    for r in _load("card"):
        if "flops" not in r:
            continue
        a = analyze(r)
        rows.append(f"| {a.arch} | {a.shape} | {a.compute_s:.3e} | {a.memory_s:.3e} "
                    f"| {a.collective_s:.3e} | {a.dominant} | {a.useful_ratio:.2f} "
                    f"| **{a.roofline_fraction:.3f}** |")
    return "\n".join(rows)


def main() -> None:
    if os.path.exists(DOC):
        with open(DOC) as f:
            text = f.read()
    else:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        text = ("# Dry-run of the PyTorch port (meta device)\n\n"
                "<!-- DRYRUN_TABLE -->\n\n<!-- ROOFLINE_TABLE -->\n")
    text = _replace(text, "DRYRUN_TABLE", dryrun_table())
    text = _replace(text, "ROOFLINE_TABLE", roofline_table())
    with open(DOC, "w") as f:
        f.write(text)
    print("rendered", os.path.normpath(DOC))


def _replace(text: str, marker: str, table: str) -> str:
    start = f"<!-- {marker} -->"
    end = f"<!-- /{marker} -->"
    block = f"{start}\n{table}\n{end}"
    if end in text:
        return re.sub(rf"<!-- {marker} -->.*?<!-- /{marker} -->", block,
                      text, flags=re.S)
    return text.replace(start, block)


if __name__ == "__main__":
    main()
