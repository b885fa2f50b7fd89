"""Fault-tolerant checkpointing: atomic, async, resumable.

Copy of ``repro.checkpoint.store`` over trees of tensors, in the
reference's on-disk format, so a checkpoint written by either package
restores into the other:

Layout:   <dir>/step_<N>/arrays.npz + manifest.json     (tmp dir + rename)

Keys are the ``/``-joined key paths of the tree; npz has no bf16, so a
bf16 leaf is stored as its raw bits (``uint16``) with ``dtypes[key] =
"bfloat16"`` in the manifest, read and written through ``view`` (no
``ml_dtypes``).  Restore picks the highest complete step; partially
written checkpoints (no manifest) are ignored — a crash mid-write can
never corrupt restore.  ``AsyncCheckpointer`` snapshots to host memory
synchronously (cheap) and writes on a background thread so the train
loop keeps stepping.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.models.param import leaves, unflatten


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor -> NumPy on the host, bf16 as its raw ``uint16`` bits."""
    t = t.detach().to("cpu", copy=True)      # never the live storage
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree) -> dict[str, tuple]:
    """-> {``/``-joined key path: (host array, "bfloat16" or None)}."""
    out = {}
    for path, leaf in leaves(tree):
        key = "/".join(str(k) for k in path)
        if isinstance(leaf, torch.Tensor):
            bf16 = leaf.dtype == torch.bfloat16
            out[key] = (_host(leaf), "bfloat16" if bf16 else None)
        else:
            out[key] = (np.asarray(leaf), None)
    return out


def save(tree, directory: str, step: int, extra: Optional[dict] = None) -> str:
    """Write ``tree`` as step ``step`` of ``directory``; -> its path."""
    return _write(_flatten(tree), directory, step, extra)


def _write(arrays: dict, directory: str, step: int,
           extra: Optional[dict]) -> str:
    """``save`` of a tree ``_flatten`` already took to the host."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    dtypes = {k: d for k, (_, d) in arrays.items() if d is not None}
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: a for k, (a, _) in arrays.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "extra": extra or {},
                   "keys": sorted(arrays), "dtypes": dtypes}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    s = steps(directory)
    return s[-1] if s else None


def restore(tree_like, directory: str, step: Optional[int] = None):
    """Restore into the structure of ``tree_like`` (its dtypes and
    devices) -> (tree, step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for p, leaf in leaves(tree_like):
            key = "/".join(str(k) for k in p)
            arr = np.array(data[key])
            if dtypes.get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out.append((p, t.to(dtype=leaf.dtype, device=leaf.device)))
    return unflatten(out), manifest["step"], manifest["extra"]


class AsyncCheckpointer:
    """Background writer; ``wait()`` before exit or next save."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, tree, step: int, extra: Optional[dict] = None):
        self.wait()
        host = _flatten(tree)              # copied off the device now

        def _run():
            try:
                _write(host, self.directory, step, extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self):
        all_steps = steps(self.directory)
        for s in all_steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
