"""The port's per-device dry-run record of a cell on the 16x16 mesh
beside the JAX package's own, on this machine's CPU.

    PYTHONPATH=src python scripts/dryrun_beside_reference.py \
        --arch phi3-mini-3.8b --shape decode_32k [--shape train_4k ...]

The port's record is ``repro_torch.launch.dryrun.run_cell(..., mesh=
"pod")`` (one rank of the mesh over the fake process group); the
reference's is ``repro.launch.dryrun.run_cell`` in a subprocess, on a
16x16 mesh built with ``axis_types=Auto`` (its own ``make_mesh`` gives
Explicit axes on jax 0.9.0, which its ``with_sharding_constraint``
refuses).  Prints one JSON line a cell with both records' argument
bytes, FLOPs, bytes accessed, temp bytes and collectives.  The two
count differently: XLA counts element-wise FLOPs and fuses, and GSPMD
chooses its own collectives; argument bytes are equal.  Needs JAX (the
reference), no card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = r'''
import json, sys
import repro.launch.dryrun as D          # sets the 512-device flag first
import jax
import numpy as np
from jax.sharding import AxisType, Mesh


def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names, axis_types=(AxisType.Auto,) * len(shape))


D.make_production_mesh = auto_mesh
print(json.dumps(D.run_cell(sys.argv[1], sys.argv[2], False, save=False)))
'''


def _summary(r: dict) -> dict:
    return {"argument_size_in_bytes":
            r["memory"]["argument_size_in_bytes"],
            "temp_size_in_bytes": r["memory"].get("temp_size_in_bytes"),
            "flops": r.get("flops"), "bytes_accessed": r.get("bytes_accessed"),
            "collectives": r.get("collectives", {}).get("bytes_by_op"),
            "collective_counts": r.get("collectives", {}).get("counts")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--shape", action="append", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.launch.dryrun import run_cell
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    for shape in args.shape:
        t0 = time.perf_counter()
        ours = run_cell(args.arch, shape, mesh="pod", save=False)
        t1 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", _REFERENCE, args.arch,
                              shape], env=env, capture_output=True,
                             text=True)
        if out.returncode:
            raise SystemExit(f"reference dry-run failed:\n"
                             f"{out.stderr[-3000:]}")
        theirs = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"arch": args.arch, "shape": shape,
                          "mesh": "16x16", "port": _summary(ours),
                          "port_s": round(t1 - t0, 1),
                          "reference": _summary(theirs),
                          "reference_s": round(time.perf_counter() - t1,
                                               1)}), flush=True)


if __name__ == "__main__":
    main()
