"""The content-addressed result store: disk + in-process LRU.

Port of ``repro.cache.store``.  Two entry kinds share one store:

* ``"row"`` — a sweep task's extracted ``SweepRow`` content (metrics,
  optional clients/series) as exact-float JSON;
* ``"cell"`` — a vector-runtime ``VectorResult`` as an ``.npz``
  (its host arrays keep their exact float64 bits) with a JSON meta block
  for the scalars.

Every entry records the key it was stored under and the code-version
salt it was computed with.  ``get`` re-checks both on load: a
corrupted file, a key mismatch, or a stale salt is a silent MISS (the
caller recomputes), never an exception and never a wrong row — the
cache can only ever change how fast an answer arrives, not what it is.

Layout: ``<dir>/<salt>/<key[:2]>/<key>.{json,npz}``.  Keying the top
level by salt makes ``python -m repro_torch.cache gc`` trivial (any
non-current salt directory is stale wholesale) and keeps entries from
different code versions physically apart.  Writes go through a temp
file + ``os.replace`` so concurrent readers never see a torn entry.

Where the port differs from the reference: the default directory is
``artifacts/cache_torch`` (``gc`` removes every salt tree that is not
current, so the two packages must never share one directory), and a
cell's key names the device it ran on (``device_sig``): the card's rows
equal the CPU's only within the runtime's rtol 1e-6 contract, not by
construction, so a CPU entry never answers a card run.  The arrays of a
stored cell are frozen (read-only): a memory hit hands the same arrays
to every caller.
"""
from __future__ import annotations

import copy
import itertools
import json
import os
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.cache.fingerprint import (Unfingerprintable, code_salt,
                                           fingerprint)

#: default on-disk location (CLI ``--cache`` without ``--cache-dir``);
#: the reference's is ``artifacts/cache``
DEFAULT_CACHE_DIR = os.path.join("artifacts", "cache_torch")

#: entries the in-process LRU holds; eviction only costs a disk read
#: (or a recompute), never correctness
_MEMORY_ENTRIES = 128

_EXT = {"row": ".json", "cell": ".npz"}
_TMP_COUNTER = itertools.count()


def device_sig(device: str) -> str:
    """Where a vector cell runs, as its cache key names it: ``"cpu"``,
    or the card's name and compute capability (``"cuda"`` and
    ``"cuda:0"`` name the same card).  Raises where a card is asked for
    and absent, as the runtime does."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"device {device!r}: this host has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    major, minor = torch.cuda.get_device_capability(index)
    return f"{torch.cuda.get_device_name(index)} sm_{major}{minor}"


@dataclass
class CacheStats:
    """Counters for one ``ResultCache`` instance's lifetime."""
    lookups: int = 0
    hits: int = 0
    misses: int = 0
    stores: int = 0
    errors: int = 0                 # corrupt / stale entries seen on get
    uncacheable: int = 0            # objects with no canonical fingerprint

    def as_dict(self) -> dict:
        return dict(vars(self))

    def __str__(self) -> str:
        return (f"hits={self.hits} misses={self.misses} "
                f"stores={self.stores} errors={self.errors} "
                f"uncacheable={self.uncacheable}")


@dataclass
class ResultCache:
    """Content-addressed result cache: on-disk store + in-process LRU.

    ``cache_dir=None`` keeps entries in memory only (useful for
    within-run reuse, e.g. the planner ladder re-probing a fleet).
    """
    cache_dir: Optional[str] = DEFAULT_CACHE_DIR
    stats: CacheStats = field(default_factory=CacheStats)

    def __post_init__(self):
        self.salt = code_salt()
        self._mem: OrderedDict = OrderedDict()

    # ------------------------------------------------------------- keys
    def key(self, kind: str, *parts) -> Optional[str]:
        """Content key for ``parts`` (``None`` = not cacheable)."""
        try:
            return fingerprint((kind, self.salt) + parts)
        except Unfingerprintable:
            self.stats.uncacheable += 1
            return None

    def vector_sig(self, config) -> dict:
        """The bit-affecting slice of a ``repro_torch.vector.VectorConfig``:
        the slot width, the sample budget, the resolved backend, soft
        mode (with its ``tau`` and ``band_frac``) and where the cells
        run: the device and the resolved shard count on the torch
        backend, ``"host"`` on the NumPy backend (f64 on the host,
        whatever ``device`` says).  The shard count is keyed though it
        is proven bit-preserving, as the reference keys it: distinct
        configurations key distinctly.  ``max_slot_elems`` and
        ``pipeline`` stay out: they are proven not to change bits."""
        backend = config.resolve_backend()
        sig = {"dt": config.dt, "samples": config.samples,
               "backend": backend, "soft": bool(config.soft),
               "device": ("host" if backend == "numpy"
                          else device_sig(config.device))}
        if backend == "torch":
            sig["devices"] = config.resolve_devices()
        if config.soft:
            sig["tau"] = config.tau
            sig["band_frac"] = config.band_frac
        return sig

    def cell_key(self, program, seed, config) -> Optional[str]:
        """Key of one vector cell: compiled program + (seed, stream) +
        bit-affecting config + code salt."""
        try:
            sig = self.vector_sig(config)
        except Exception:  # repro: noqa[broad-except] — an unresolvable
            # device: uncacheable, and the real path raises its own error
            self.stats.uncacheable += 1
            return None
        return self.key("cell", program, tuple(int(s) for s in seed), sig)

    # ---------------------------------------------------------- generic
    def _path(self, key: str, kind: str) -> Optional[str]:
        if self.cache_dir is None:
            return None
        return os.path.join(self.cache_dir, self.salt, key[:2],
                            key + _EXT[kind])

    def _mem_put(self, key: str, value) -> None:
        self._mem[key] = value
        self._mem.move_to_end(key)
        while len(self._mem) > _MEMORY_ENTRIES:
            self._mem.popitem(last=False)

    def _write_atomic(self, path: str, writer) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_COUNTER)}"
        try:
            with open(tmp, "wb") as f:
                writer(f)
            os.replace(tmp, path)
        except OSError:
            # a full/readonly disk must never fail the sweep — the
            # cache degrades to a recompute
            if os.path.exists(tmp):
                os.remove(tmp)

    # ------------------------------------------------------------- rows
    def get_row(self, key: str) -> Optional[dict]:
        """-> the stored row payload (deep copy), or ``None``."""
        self.stats.lookups += 1
        hit = self._mem.get(key)
        if hit is not None:
            self._mem.move_to_end(key)
            self.stats.hits += 1
            return copy.deepcopy(hit)
        path = self._path(key, "row")
        if path is not None and os.path.exists(path):
            try:
                with open(path) as f:
                    entry = json.load(f)
                if entry["key"] != key or entry["salt"] != self.salt \
                        or entry["kind"] != "row":
                    raise ValueError("fingerprint mismatch")
                payload = entry["payload"]
            except Exception:  # repro: noqa[broad-except] — a corrupt or
                # stale entry is a silent miss by contract, never a crash
                self.stats.errors += 1
            else:
                self._mem_put(key, payload)
                self.stats.hits += 1
                return copy.deepcopy(payload)
        self.stats.misses += 1
        return None

    def put_row(self, key: str, payload: dict) -> None:
        self._mem_put(key, copy.deepcopy(payload))
        self.stats.stores += 1
        path = self._path(key, "row")
        if path is None:
            return
        entry = {"key": key, "salt": self.salt, "kind": "row",
                 "payload": payload}
        text = json.dumps(entry)
        self._write_atomic(path, lambda f: f.write(text.encode()))

    # ------------------------------------------------------------ cells
    def get_cell(self, key: str):
        """-> the stored ``VectorResult``, or ``None``.  Arrays of a
        memory hit are shared and read-only."""
        self.stats.lookups += 1
        hit = self._mem.get(key)
        if hit is not None:
            self._mem.move_to_end(key)
            self.stats.hits += 1
            return hit
        path = self._path(key, "cell")
        if path is not None and os.path.exists(path):
            try:
                res = _load_cell(path, key, self.salt)
            except Exception:  # repro: noqa[broad-except] — a corrupt or
                # stale entry is a silent miss by contract, never a crash
                self.stats.errors += 1
            else:
                self._mem_put(key, res)
                self.stats.hits += 1
                return res
        self.stats.misses += 1
        return None

    def put_cell(self, key: str, result) -> None:
        _freeze(result)
        self._mem_put(key, result)
        self.stats.stores += 1
        path = self._path(key, "cell")
        if path is None:
            return
        self._write_atomic(path, lambda f: _save_cell(f, key, self.salt,
                                                      result))


# ---------------------------------------------------------------------------
# VectorResult (de)serialization — exact bits
# ---------------------------------------------------------------------------
_CELL_ARRAYS = ("samples", "sample_ivl", "n_ivl", "util_ivl", "occ_ivl",
                "qdepth_ivl")
_OPTIONAL_ARRAYS = ("tokens_ivl", "shed_ivl")


def _freeze(result) -> None:
    """Make a cell's arrays read-only: a memory hit shares them with
    every caller, and a write into one would change a cached answer."""
    for name in _CELL_ARRAYS + _OPTIONAL_ARRAYS:
        a = getattr(result, name)
        if isinstance(a, np.ndarray):
            a.setflags(write=False)


def _save_cell(f, key: str, salt: str, result) -> None:
    meta = {"key": key, "salt": salt, "kind": "cell",
            "n": result.n, "mean": result.mean, "p50": result.p50,
            "p95": result.p95, "p99": result.p99,
            "dropped": result.dropped, "interval": result.interval,
            "slo": result.slo, "server_ids": list(result.server_ids),
            "has_tokens": result.tokens_ivl is not None,
            "has_shed": result.shed_ivl is not None}
    arrays = {name: np.asarray(getattr(result, name))
              for name in _CELL_ARRAYS}
    if result.tokens_ivl is not None:
        arrays["tokens_ivl"] = np.asarray(result.tokens_ivl)
    if result.shed_ivl is not None:
        arrays["shed_ivl"] = np.asarray(result.shed_ivl)
    np.savez(f, meta=np.array(json.dumps(meta)), **arrays)


def _load_cell(path: str, key: str, salt: str):
    from repro_torch.vector.runtime import VectorResult
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"][()]))
        if meta["key"] != key or meta["salt"] != salt \
                or meta["kind"] != "cell":
            raise ValueError("fingerprint mismatch")
        arrays = {name: z[name] for name in _CELL_ARRAYS}
        tokens = z["tokens_ivl"] if meta["has_tokens"] else None
        # older cache entries predate shed accounting: absent = None
        shed = z["shed_ivl"] if meta.get("has_shed") else None
    res = VectorResult(
        n=int(meta["n"]), mean=float(meta["mean"]),
        p50=float(meta["p50"]), p95=float(meta["p95"]),
        p99=float(meta["p99"]), dropped=int(meta["dropped"]),
        interval=float(meta["interval"]),
        slo=None if meta["slo"] is None else float(meta["slo"]),
        server_ids=list(meta["server_ids"]), tokens_ivl=tokens,
        shed_ivl=shed, **arrays)
    _freeze(res)
    return res


# ---------------------------------------------------------------------------
# Maintenance (``python -m repro_torch.cache``)
# ---------------------------------------------------------------------------
def scan(cache_dir: str) -> dict:
    """Inventory of a cache directory: entries/bytes per salt."""
    out: dict = {"dir": cache_dir, "current_salt": code_salt(),
                 "salts": {}}
    if not os.path.isdir(cache_dir):
        return out
    for salt in sorted(os.listdir(cache_dir)):
        sdir = os.path.join(cache_dir, salt)
        if not os.path.isdir(sdir):
            continue
        info = {"rows": 0, "cells": 0, "other": 0, "bytes": 0}
        for dirpath, _dirnames, filenames in os.walk(sdir):
            for fn in filenames:
                p = os.path.join(dirpath, fn)
                info["bytes"] += os.path.getsize(p)
                if fn.endswith(".json"):
                    info["rows"] += 1
                elif fn.endswith(".npz"):
                    info["cells"] += 1
                else:
                    info["other"] += 1
        info["stale"] = salt != out["current_salt"]
        out["salts"][salt] = info
    return out


def verify(cache_dir: str, delete: bool = False) -> dict:
    """Load every current-salt entry and re-check its recorded key and
    salt; -> ``{"checked": n, "corrupt": [paths]}`` (entries removed
    when ``delete``)."""
    salt = code_salt()
    sdir = os.path.join(cache_dir, salt)
    checked, corrupt = 0, []
    if not os.path.isdir(sdir):
        return {"checked": 0, "corrupt": []}
    for dirpath, _dirnames, filenames in os.walk(sdir):
        for fn in sorted(filenames):
            path = os.path.join(dirpath, fn)
            key, ext = os.path.splitext(fn)
            checked += 1
            try:
                if ext == ".npz":
                    _load_cell(path, key, salt)
                elif ext == ".json":
                    with open(path) as f:
                        entry = json.load(f)
                    if entry["key"] != key or entry["salt"] != salt:
                        raise ValueError("fingerprint mismatch")
                else:
                    raise ValueError(f"unknown entry type {ext!r}")
            except Exception:  # repro: noqa[broad-except] — verify's whole
                # job is classifying arbitrary on-disk damage
                corrupt.append(path)
                if delete:
                    os.remove(path)
    return {"checked": checked, "corrupt": corrupt}


def gc(cache_dir: str, all_salts: bool = False) -> dict:
    """Remove stale-salt trees (every tree when ``all_salts``) and
    corrupt current-salt entries; -> removal counts."""
    import shutil
    cur = code_salt()
    removed_salts, removed_entries = [], 0
    if os.path.isdir(cache_dir):
        for salt in sorted(os.listdir(cache_dir)):
            sdir = os.path.join(cache_dir, salt)
            if not os.path.isdir(sdir):
                continue
            if all_salts or salt != cur:
                shutil.rmtree(sdir)
                removed_salts.append(salt)
    if not all_salts:
        removed_entries = len(verify(cache_dir, delete=True)["corrupt"])
    return {"removed_salts": removed_salts,
            "removed_corrupt_entries": removed_entries}
