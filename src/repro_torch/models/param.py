"""Parameter spec trees.

Copy of ``repro.models.param`` in PyTorch.  A model is a nested dict of
``Spec`` leaves (shape, dtype, logical axes, initializer); from it come
the parameters themselves (``init_tree``), counts and sizes, the
abstract tree of the dry-run (``abstract_tree``: tensors on the ``meta``
device, PyTorch's counterpart of ``jax.ShapeDtypeStruct``, so nothing is
allocated) and the logical axes the sharding rules read
(``axes_tree``; ``distributed.sharding``).

``from_numpy`` carries a parameter tree across from the JAX package
(its arrays as NumPy, the same key paths), so a test can run both on
the very same weights.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class Spec:
    shape: tuple
    axes: tuple                      # logical axis name (or None) per dim
    dtype: Any = torch.bfloat16
    init: str = "normal"             # normal | zeros | ones | constant
    scale: Optional[float] = None    # stddev for normal / value for constant

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def leaves(tree, path: tuple = ()):
    """``(key path, leaf)`` pairs in the order JAX flattens a dict tree:
    keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


def unflatten(pairs) -> dict:
    """``(key path, leaf)`` pairs -> the nested dict they spell."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict, keeping its keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def abstract_tree(tree) -> dict:
    """Each ``Spec`` -> an empty tensor of its shape and dtype on the
    ``meta`` device (no storage)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


def axes_tree(tree) -> dict:
    """Each ``Spec`` -> its logical-axes tuple (a leaf: ``tree_map`` and
    ``leaves`` walk dicts only, so no wrapper is needed)."""
    return tree_map(lambda s: s.axes, tree)


def init_tree(tree, generator: torch.Generator, device=None) -> dict:
    """Materialise a spec tree: normal leaves draw ``N(0, 1)`` in f32 from
    ``generator`` (on the generator's own device, leaf by leaf in key
    order), scaled by ``Spec.scale`` or ``1 / sqrt(shape[0])`` as the JAX
    package's ``init_tree`` does, then cast to the leaf's dtype; zeros,
    ones and constants are filled.  Everything lands on ``device``
    (default: the generator's).  The draws depend on the generator's
    device, so the same seed gives other weights on the CPU than on the
    card: move weights drawn once when both must agree."""
    device = torch.device(device) if device is not None else generator.device

    def make(s: Spec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        if s.init == "constant":
            return torch.full(s.shape, s.scale, dtype=s.dtype, device=device)
        fan_in = s.shape[0] if s.shape else 1
        std = s.scale if s.scale is not None else 1.0 / math.sqrt(max(fan_in,
                                                                      1))
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        # scaled in place: one f32 copy of the leaf at a time (deepseek's
        # stacked expert bank is 5.2 G values, 20.7 GB in f32)
        return x.mul_(std).to(s.dtype).to(device)

    return unflatten((path, make(s)) for path, s in leaves(tree))


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)                   # a writable copy torch can own
    if a.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def from_numpy(tree, device="cpu") -> dict:
    """A tree of arrays (NumPy, or anything ``np.asarray`` takes, bf16
    as ``ml_dtypes.bfloat16``) -> the same tree of tensors on
    ``device``, bit for bit."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def stack_specs(tree, n: int, axis_name: str = "layer"):
    """Prepend a stacking dim of size n (layer groups)."""
    return tree_map(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape,
                                      axes=(axis_name,) + s.axes), tree)


def count_params_tree(tree) -> int:
    return int(sum(math.prod(s.shape) for _, s in leaves(tree)))


def tree_bytes(tree) -> int:
    """Bytes of every leaf of a spec tree at its dtype."""
    return int(sum(math.prod(s.shape) * s.dtype.itemsize
                   for _, s in leaves(tree)))
