"""Content-addressed result cache for sweeps, vector grids, planning.

Port of ``repro.cache``.  Per-cell RNG derivation is bit-stable across
executors, worker counts, chunking and pipelining, which makes every
(point, rep) cell content-addressable: the same frozen inputs on the
same device always produce the same bits.  This package turns that
invariant into a performance layer: a warm cell launches no kernel.
See ``repro_torch.cache.fingerprint`` for the key anatomy and
``repro_torch.cache.store`` for the hit/miss contract.

CLI integration (``repro_torch.sweep``, ``repro_torch.scenarios``,
``repro_torch.plan``) goes through :func:`add_cache_args` /
:func:`cache_from_args`; maintenance via ``python -m
repro_torch.cache``.  The default directory is ``artifacts/cache_torch``,
apart from the reference's ``artifacts/cache``.
"""
from repro_torch.cache.fingerprint import (CACHE_FORMAT, Unfingerprintable,
                                           code_salt, fingerprint)
from repro_torch.cache.store import (DEFAULT_CACHE_DIR, CacheStats,
                                     ResultCache, gc, scan, verify)

__all__ = [
    "CACHE_FORMAT",
    "CacheStats",
    "DEFAULT_CACHE_DIR",
    "ResultCache",
    "Unfingerprintable",
    "add_cache_args",
    "cache_from_args",
    "code_salt",
    "fingerprint",
    "gc",
    "scan",
    "verify",
]


def add_cache_args(ap) -> None:
    """Attach the shared ``--cache/--no-cache/--cache-dir`` flags."""
    g = ap.add_argument_group("result cache")
    g.add_argument("--cache", action="store_true",
                   help="reuse content-addressed cached results "
                        f"(default dir: {DEFAULT_CACHE_DIR})")
    g.add_argument("--no-cache", action="store_true",
                   help="force recomputation even if --cache-dir is set")
    g.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="cache directory (implies --cache)")


def cache_from_args(args):
    """-> a ``ResultCache`` per the CLI flags, or ``None`` (disabled)."""
    if getattr(args, "no_cache", False):
        return None
    cache_dir = getattr(args, "cache_dir", None)
    if not getattr(args, "cache", False) and cache_dir is None:
        return None
    return ResultCache(cache_dir=cache_dir or DEFAULT_CACHE_DIR)
