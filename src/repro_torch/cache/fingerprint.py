"""Canonical content fingerprints — what makes a cell addressable.

Port of ``repro.cache.fingerprint``.  A cache hit must be *provably*
the same computation, so the key is a SHA-256 over a canonical walk of
everything that decides a cell's bits: the compiled program/experiment
(dataclasses walked field by field, ndarrays and tensors hashed dtype +
shape + raw bytes, floats by ``repr`` so ``0.1`` and
``0.30000000000000004`` key differently exactly when they compute
differently), the derived (seed, stream) pair, the bit-affecting
runtime config, and a code-version salt.

Where the port differs from the reference:

* ``torch.Tensor`` has a branch of its own.  A tensor's ``__dict__`` is
  empty, so the plain-object branch would give every tensor the same
  fingerprint; here its dtype, shape and the raw bytes of a contiguous
  CPU copy are hashed (bf16 through its int16 bit pattern, since NumPy
  has no bf16).  The device is not hashed: the cell key carries it.
  ``torch.dtype`` and ``torch.device`` hash as their ``str``;
  ``torch.Generator`` has no canonical content and is unfingerprintable.
* The salt (``code_salt``) digests every ``.py``, ``.cu``, ``.cuh`` and
  ``.h`` file under ``src/repro_torch`` plus a format-version constant:
  the CUDA sources the kernels are built from decide bits as much as the
  Python does, so an edit to either invalidates the whole cache rather
  than silently serving stale rows.  ``REPRO_TORCH_CACHE_SALT``
  overrides it (tests use this to simulate stale entries); it is not the
  reference's ``REPRO_CACHE_SALT``, so staling one package's cache never
  stales the other's.

Objects that cannot be canonically walked (lambdas, closures, open
handles, generators) raise ``Unfingerprintable`` — callers treat that as
"not cacheable", never as an error.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from functools import lru_cache, partial

import numpy as np
import torch

#: bump to invalidate every existing cache entry on a format change
CACHE_FORMAT = 1

#: source files that participate in the code-version salt: the Python
#: and the CUDA sources and headers the kernels are built from
SALT_SUFFIXES = (".py", ".cu", ".cuh", ".h")

#: the package root whose sources the salt digests
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: top-level packages left out of the salt, as the reference leaves them:
#: ``analysis`` (static lint and checks) never decides a cell's bits
SALT_EXCLUDE = ("analysis",)


class Unfingerprintable(TypeError):
    """The object has no canonical content form (lambda, closure,
    handle, ...) — the computation is valid but not cacheable."""


def _update_callable(h, fn) -> None:
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", getattr(fn, "__name__", None))
    if not mod or not qual or "<lambda>" in qual or "<locals>" in qual \
            or mod == "__main__":
        raise Unfingerprintable(f"callable {fn!r} has no stable "
                                f"module-level identity")
    h.update(f"fn:{mod}:{qual};".encode())


def _update_tensor(h, t: torch.Tensor) -> None:
    if t.layout != torch.strided:
        raise Unfingerprintable(f"{t.layout} tensor has no canonical "
                                f"byte form")
    t = t.detach().cpu().contiguous()
    h.update(f"tt:{t.dtype}:{tuple(t.shape)};".encode())
    if t.dtype == torch.bfloat16:       # NumPy has no bf16: its bit pattern
        t = t.view(torch.int16)
    try:
        raw = t.numpy().tobytes()
    except TypeError as e:              # a dtype NumPy cannot hold
        raise Unfingerprintable(f"tensor of dtype {t.dtype}: {e}") from e
    h.update(raw)


def _update(h, obj) -> None:
    """Stream one object's canonical form into the hash."""
    if obj is None:
        h.update(b"N;")
    elif isinstance(obj, bool):
        h.update(b"T;" if obj else b"F;")
    elif isinstance(obj, (int, np.integer)):
        h.update(f"i{int(obj)};".encode())
    elif isinstance(obj, (float, np.floating)):
        h.update(f"f{float(obj)!r};".encode())
    elif isinstance(obj, str):
        h.update(f"s{len(obj)}:".encode())
        h.update(obj.encode())
    elif isinstance(obj, bytes):
        h.update(f"b{len(obj)}:".encode())
        h.update(obj)
    elif isinstance(obj, np.ndarray):
        h.update(f"nd:{obj.dtype.str}:{obj.shape};".encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, (list, tuple)):
        h.update(f"l{len(obj)}[".encode())
        for v in obj:
            _update(h, v)
        h.update(b"];")
    elif isinstance(obj, dict):
        h.update(f"d{len(obj)}{{".encode())
        for k in sorted(obj, key=lambda k: (type(k).__name__, repr(k))):
            _update(h, k)
            h.update(b"=")
            _update(h, obj[k])
        h.update(b"};")
    elif isinstance(obj, partial):
        h.update(b"partial(")
        _update(h, obj.func)
        _update(h, tuple(obj.args))
        _update(h, dict(obj.keywords))
        h.update(b");")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        h.update(f"dc:{cls.__module__}.{cls.__qualname__}(".encode())
        for f in sorted(dataclasses.fields(obj), key=lambda f: f.name):
            h.update(f.name.encode())
            h.update(b"=")
            _update(h, getattr(obj, f.name))
        h.update(b");")
    elif isinstance(obj, torch.Tensor):
        _update_tensor(h, obj)
    elif isinstance(obj, (torch.dtype, torch.device)):
        h.update(f"{type(obj).__name__}:{obj};".encode())
    elif isinstance(obj, torch.Generator):
        raise Unfingerprintable("torch.Generator has no canonical "
                                "content form")
    elif callable(obj):
        _update_callable(h, obj)
    elif hasattr(obj, "__dict__"):
        # plain object: class identity + its public attribute dict (the
        # declared configuration; leading-underscore derived state is
        # excluded so memo fields never split keys)
        cls = type(obj)
        if cls.__module__ == "__main__":
            raise Unfingerprintable(f"{cls.__qualname__} defined in "
                                    f"__main__ has no stable identity")
        h.update(f"o:{cls.__module__}.{cls.__qualname__}(".encode())
        attrs = {k: v for k, v in vars(obj).items()
                 if not k.startswith("_")}
        _update(h, attrs)
        h.update(b");")
    else:
        raise Unfingerprintable(f"no canonical form for "
                                f"{type(obj).__name__}: {obj!r}")


def fingerprint(obj) -> str:
    """SHA-256 hex digest of ``obj``'s canonical content form."""
    h = hashlib.sha256()
    _update(h, obj)
    return h.hexdigest()


def tree_digest(root: str) -> str:
    """Digest of the salted sources under ``root`` (+ format version):
    every ``SALT_SUFFIXES`` file, by relative path and content, in a
    fixed walk order; ``__pycache__`` and ``SALT_EXCLUDE`` are skipped."""
    h = hashlib.sha256()
    h.update(f"format:{CACHE_FORMAT};".encode())
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        rel_dir = os.path.relpath(dirpath, root)
        parts = rel_dir.split(os.sep)
        if parts[0] in SALT_EXCLUDE or "__pycache__" in parts:
            continue
        for fn in sorted(filenames):
            if not fn.endswith(SALT_SUFFIXES):
                continue
            rel = os.path.join(rel_dir, fn)
            h.update(f"file:{rel};".encode())
            with open(os.path.join(dirpath, fn), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


@lru_cache(maxsize=1)
def code_salt() -> str:
    """Digest of the port's source tree, the CUDA sources included.

    Computed once per process; ``REPRO_TORCH_CACHE_SALT`` overrides it
    for tests that need to simulate a stale cache."""
    env = os.environ.get("REPRO_TORCH_CACHE_SALT")
    if env:
        return env
    return tree_digest(PACKAGE_ROOT)
