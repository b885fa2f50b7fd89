"""What a run may not hold, and how it fails."""
from __future__ import annotations

import sys

#: modules a run must not hold once the window has closed (top-level
#: names, compared whole: ``repro_torch`` is the program, ``repro`` the
#: JAX package it was ported from)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def fail(msg: str, code: int = 2) -> int:
    print(f"servebench: {msg}", file=sys.stderr, flush=True)
    return code
