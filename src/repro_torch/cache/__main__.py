"""Cache maintenance CLI.

    python -m repro_torch.cache stats  [--cache-dir DIR] [--json]
    python -m repro_torch.cache verify [--cache-dir DIR] [--delete]
    python -m repro_torch.cache gc     [--cache-dir DIR] [--all]

``stats`` inventories entries per code-version salt, ``verify``
re-checks every current-salt entry's recorded fingerprint (exit 1 on
corruption), ``gc`` removes stale-salt trees and corrupt entries.  The
default directory is ``artifacts/cache_torch``; the reference's cache
(``artifacts/cache``) is never touched unless named.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.cache import DEFAULT_CACHE_DIR, gc, scan, verify


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.cache",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("command", choices=("stats", "verify", "gc"))
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR, metavar="DIR")
    ap.add_argument("--delete", action="store_true",
                    help="verify: remove corrupt entries")
    ap.add_argument("--all", action="store_true",
                    help="gc: remove every salt tree, including current")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    if args.command == "stats":
        rep = scan(args.cache_dir)
        if args.json:
            print(json.dumps(rep, indent=1))
        else:
            print(f"cache dir: {rep['dir']}")
            print(f"current salt: {rep['current_salt']}")
            if not rep["salts"]:
                print("(empty)")
            for salt, info in rep["salts"].items():
                mark = "  (stale)" if info["stale"] else "  (current)"
                print(f"  {salt}{mark}: {info['rows']} rows, "
                      f"{info['cells']} cells, {info['bytes']} bytes")
        return 0

    if args.command == "verify":
        rep = verify(args.cache_dir, delete=args.delete)
        if args.json:
            print(json.dumps(rep, indent=1))
        else:
            print(f"checked {rep['checked']} entries, "
                  f"{len(rep['corrupt'])} corrupt"
                  + (" (deleted)" if args.delete and rep["corrupt"] else ""))
            for path in rep["corrupt"]:
                print(f"  corrupt: {path}")
        return 1 if rep["corrupt"] and not args.delete else 0

    rep = gc(args.cache_dir, all_salts=args.all)
    if args.json:
        print(json.dumps(rep, indent=1))
    else:
        print(f"removed {len(rep['removed_salts'])} stale salt tree(s), "
              f"{rep['removed_corrupt_entries']} corrupt entries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
