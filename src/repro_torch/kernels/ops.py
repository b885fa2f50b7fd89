"""Kernel dispatch by the device of the tensors.

A CUDA tensor launches the hand-written kernel (or the wrapper raises);
a CPU tensor takes the kernel's plain PyTorch version in ``ref``.
There is no switch that sends a CUDA tensor down the plain path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref, vector_quantiles, vector_step


def _on_cuda(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return False


def _hard(consts: dict) -> None:
    if "tau" in consts:
        raise NotImplementedError("soft mode (consts 'tau') is not ported "
                                  "yet")


def scalar_scan(consts: dict, carry: tuple, xs: tuple):
    """Scalar-family slot scan over every slot of ``xs``."""
    _hard(consts)
    if _on_cuda(carry[0]):
        return vector_step.scalar_scan(consts, carry, xs)
    return ref.scalar_scan(consts, carry, xs)


def batched_scan(consts: dict, carry: tuple, xs: tuple):
    """Batched-family (roofline) slot scan over every slot of ``xs``."""
    _hard(consts)
    if _on_cuda(carry[0]):
        return vector_step.batched_scan(consts, carry, xs)
    return ref.batched_scan(consts, carry, xs)


def fused_quantiles(lat: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """p50/p95/p99 of every row of ``lat`` (+inf padded past
    ``counts``) -> [C, 3] f32, NaN rows where the count is 0."""
    if _on_cuda(lat):
        return vector_quantiles.fused_quantiles(lat, counts)
    return ref.fused_quantiles(lat, counts)
