"""Numerics of the SSD kernel's split products, emulated on the CPU.

    PYTHONPATH=src python3 scripts/ssd_numerics.py [--seeds 4]

Runs ``repro_torch.kernels.ref.ssd_chunked_parts``, the arithmetic of
``csrc/ssd_scan.cu`` (tensor-core products over bf16 parts of their
operands, chunk states passed in chunk order), at mamba2-1.3b's served
widths (one head, chunk L 256, P 64, N 128, two chunks) on
``chip_smoke.py``'s input ranges, and prints the largest share of
chip_smoke's bound, ``2e-4 (1 + |p|) + L 2^-24 max|p|`` around the
plain version ``ref.ssd_chunked``, that y and the final state use:
f32 operands split in two parts (the kernel beside bf16 inputs),
rounded to bf16 once (the design the kernel avoids), and f32 inputs
with every operand in three parts (the kernel beside f32 inputs).  A
share above 1 fails chip_smoke.  CPU only; prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import ref  # noqa: E402

#: chip_smoke.py's SSD_TOL
TOL = 2e-4
#: mamba2-1.3b's served widths for one head: s, p, n, chunk
SHAPE = (512, 64, 128, 256)


def served_inputs(seed: int, dtype: torch.dtype, shape=SHAPE) -> tuple:
    """x, dt, A, B, C of one head in chip_smoke's ranges: x, B, C unit
    normal in ``dtype``; dt = softplus(N - 4.6 + 2 N), A = -exp(1.386 +
    0.5 N) in f32."""
    s, p, n, _ = shape
    g = np.random.default_rng(seed)

    def f(*sh):
        return torch.from_numpy(g.standard_normal(sh).astype(np.float32))
    x = f(1, s, 1, p).to(dtype)
    dt = torch.nn.functional.softplus(f(1, s, 1) - 4.6 + 2.0 * f(1, s, 1))
    A = -torch.exp(1.386 + 0.5 * f(1))
    B, C = f(1, s, 1, n).to(dtype), f(1, s, 1, n).to(dtype)
    return x, dt, A, B, C


def bound_used(got: torch.Tensor, plain: torch.Tensor, chunk: int) -> float:
    """The largest share of chip_smoke's bound that an element uses."""
    atol = TOL + chunk * 2.0 ** -24 * plain.abs().max().item()
    return ((got - plain).abs() / (atol + TOL * plain.abs())).max().item()


def shares(seed: int, dtype: torch.dtype, parts: int) -> dict:
    x, dt, A, B, C = served_inputs(seed, dtype)
    chunk = SHAPE[-1]
    py, ph = ref.ssd_chunked(x, dt, A, B, C, chunk=chunk)
    ey, eh = ref.ssd_chunked_parts(x, dt, A, B, C, chunk=chunk, parts=parts)
    return {"y": bound_used(ey, py, chunk), "hN": bound_used(eh, ph, chunk)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    out = {}
    for label, dtype, parts in (("bf16 inputs, 2 parts", torch.bfloat16, 2),
                                ("bf16 inputs, rounded once",
                                 torch.bfloat16, 1),
                                ("f32 inputs, 3 parts", torch.float32, 3)):
        runs = [shares(seed, dtype, parts) for seed in range(args.seeds)]
        out[label] = {k: max(r[k] for r in runs) for k in ("y", "hN")}
    print(json.dumps({"shape": dict(zip(("s", "p", "n", "chunk"), SHAPE)),
                      "seeds": args.seeds, "bound_used": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
