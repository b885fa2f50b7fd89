"""chip_smoke's step 7c on four cards: the same models, mesh, inputs and
checks as ``chip_smoke.run_sharded``, each rank on its own card over
NCCL (step 7c puts four gloo ranks on one card).

    python3 scripts/sharded_nccl.py      # needs four cards

Builds the kernels, runs the four ranks (``chip_smoke.sharded_rank`` with
``backend="nccl"``: rank 0 also runs each model unsharded on card 0) and
prints 7c's lines (tokens, logits against the unsharded run and the
one-ulp bound, per-rank launches and shapes, the LSE against the plain
version), the phase's seconds and the cards' name and power limit.
Exits non-zero where a check fails, or without four cards.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        chip_smoke.fail("scripts/sharded_nccl.py needs four CUDA cards")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cards = smi.stdout.strip().splitlines()
    print("\n".join(cards), flush=True)
    from repro_torch.kernels import _build
    _build.build(("flash_attention", "decode_attention", "ssd_scan"))
    record, launches = chip_smoke.run_sharded(
        f"{len(cards)} x {cards[0]}, NCCL", backend="nccl")
    print(json.dumps({"wall_s": record["wall_s"], "launches": launches,
                      "models": {a: {k: m[k] for k in ("rel_err", "bound",
                                                       "sharded_s")}
                                 for a, m in record["models"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
