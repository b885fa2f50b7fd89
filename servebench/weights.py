"""The served weights, drawn from the seed on the device.

The leaves and their layout are the program's own (``repro_torch``'s
spec tree, which the caller passes as ``{path: (shape, dtype, init,
scale)}``); the draw is the benchmark's.  Every normal leaf of one dtype
comes from one ``normal_`` call of a generator on the device over a flat
buffer, in sorted key order, and is then scaled in place: a product's
weight by ``1 / sqrt(fan_in)`` (its input width), the embedding table
by the spec's own scale.  A one-layer std keeps a 32-layer model's
residual stream at a scale where bf16 agrees with f32 (a stacked
matrix drawn at ``1 / sqrt(its group count)`` makes the stack chaotic).
Norm scales are ones.  The same tensors go to the program and to the
reference.
"""
from __future__ import annotations

import math

import torch


def fan_in(path: tuple, shape: tuple) -> int:
    """The input width of the product a weight leaf enters."""
    dims = shape[1:] if path[0] == "groups" else shape   # stacked layers
    if path[-1] == "o":                 # (heads, head_dim, d_model)
        return dims[0] * dims[1]
    if path[-2:] == ("unembed", "kernel"):   # (vocab, d_model), x @ w.T
        return dims[1]
    return dims[0]


class Weights:
    """``specs``: ``{path: (shape, dtype, init, scale)}``; ``leaves``:
    ``{path: tensor}`` on ``device``, drawn from ``seed``.  ``redraw``
    draws another seed into the same tensors."""

    def __init__(self, specs: dict, seed: int, device):
        self.specs = specs
        self.device = torch.device(device)
        self.leaves: dict = {}
        self._groups: dict = {}            # dtype -> (flat, [paths])
        for path in sorted(specs):
            shape, dtype, init, scale = specs[path]
            if init == "normal":
                self._groups.setdefault(dtype, [None, []])[1].append(path)
            else:
                value = {"zeros": 0.0, "ones": 1.0}.get(init, scale)
                self.leaves[path] = torch.full(shape, value, dtype=dtype,
                                               device=self.device)
        for dtype, group in self._groups.items():
            total = sum(math.prod(specs[p][0]) for p in group[1])
            group[0] = torch.empty(total, dtype=dtype, device=self.device)
            off = 0
            for p in group[1]:
                n = math.prod(specs[p][0])
                self.leaves[p] = group[0][off:off + n].view(specs[p][0])
                off += n
        self.redraw(seed)

    def redraw(self, seed: int) -> None:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed) % 2 ** 64)
        for dtype in sorted(self._groups, key=str):
            flat, paths = self._groups[dtype]
            flat.normal_(generator=g)
            for p in paths:
                shape, _, _, scale = self.specs[p]
                self.leaves[p].mul_(scale if scale is not None
                                    else fan_in(p, shape) ** -0.5)

    def tree(self) -> dict:
        """The leaves as the nested dict the program reads."""
        out: dict = {}
        for path, leaf in self.leaves.items():
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return out
