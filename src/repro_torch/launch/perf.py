"""Perf runner: dry-run one cell with optimization toggles and print the
roofline delta against the recorded baseline.

Copy of ``repro.launch.perf`` on the port's dry-run (``launch.dryrun``,
on the ``meta`` device; it needs no card).  ``--opts`` sets
``REPRO_OPTS`` for the run; the port reads the reference's five options
(``repro_torch.util``): ``w8_experts``, ``remat_dots``,
``sp_naive_attn``, ``ssd_shard_state`` and ``microbatch8``, so the
reference's own example ``--strategy sp --opts sp_naive_attn,remat_dots``
runs both.  The baseline is the untagged
result of the same cell under ``launch.roofline.ARTIFACT_DIR``.
``--multipod`` runs the cell as one rank of the 2x16x16 mesh, and the
line then carries the collective term and bytes.

    python -m repro_torch.launch.perf --arch deepseek-moe-16b \
        --shape decode_32k --opts w8_experts --tag w8
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perf")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--strategy", default="")
    ap.add_argument("--opts", default="")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--no-cost", action="store_true",
                    help="argument bytes only (memory iterations)")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import ARTIFACT_DIR, run_cell
    from repro_torch.launch.roofline import analyze

    r = run_cell(args.arch, args.shape, args.multipod, strategy=args.strategy,
                 opts=args.opts, tag=args.tag, with_cost=not args.no_cost)
    mem = r["memory"]
    if "flops" not in r:
        print(f"[{args.tag}] {r['compile_s']}s "
              f"temp={mem.get('temp_size_in_bytes', 0) / 2**30:.1f}GiB "
              f"args={mem['argument_size_in_bytes'] / 2**30:.1f}GiB"
              + (f" sharded_error={r['sharded_error']}"
                 if "sharded_error" in r else ""))
        return
    a = analyze(r)
    base_path = os.path.join(
        ARTIFACT_DIR, f"{args.arch}_{args.shape}_"
        f"{'multipod' if args.multipod else 'card'}.json")
    print(f"[{args.tag}] compute={a.compute_s:.3e}s memory={a.memory_s:.3e}s "
          f"collective={a.collective_s:.3e}s dominant={a.dominant} "
          f"bound={a.bound_s:.3e}s roofline={a.roofline_fraction:.3f} "
          f"coll={r['collectives']['total_bytes']:.3e}B "
          f"temp={mem['temp_size_in_bytes'] / 2**30:.1f}GiB")
    if os.path.exists(base_path):
        with open(base_path) as f:
            b = analyze(json.load(f))
        print(f"[baseline] bound={b.bound_s:.3e}s roofline="
              f"{b.roofline_fraction:.3f} -> "
              f"speedup {b.bound_s / a.bound_s:.2f}x")


if __name__ == "__main__":
    main()
