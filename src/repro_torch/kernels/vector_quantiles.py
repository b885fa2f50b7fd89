"""Wrapper of the fused-quantile CUDA kernel (``csrc/vector_quantiles.cu``).

``fused_quantiles`` replaces the Pallas kernel
``repro/kernels/vector_quantiles.py:fused_quantiles``: p50/p95/p99 of
every row of a ``[C, K]`` f32 latency matrix (+inf padded past each
row's count) in one launch, by an exact radix select.  Its plain
PyTorch version is ``ref.fused_quantiles`` (a full sort); the two are
bit-equal.  ``fused_quantiles.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import VECTOR_QS
from repro_torch.kernels.vector_step import _check


def fused_quantiles(lat: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``lat`` [C, K] f32 on the card (non-negative samples, +inf past
    ``counts``), ``counts`` [C] int32 -> [C, 3] f32 p50/p95/p99, NaN
    rows where the count is 0."""
    if lat.dim() != 2 or lat.shape[0] < 1 or lat.shape[1] < 1:
        raise ValueError(f"lat: expected a non-empty [C, K] matrix, got "
                         f"{tuple(lat.shape)}")
    C, K = lat.shape
    _check(lat, "lat", torch.float32, (C, K))
    _check(counts, "counts", torch.int32, (C,))
    out = torch.empty((C, len(VECTOR_QS)), dtype=torch.float32,
                      device=lat.device)
    fn = _build.load("vector_quantiles").fused_quantiles
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(lat.device):
        stream = torch.cuda.current_stream(lat.device).cuda_stream
        rc = fn(lat.data_ptr(), counts.data_ptr(), out.data_ptr(), C, K,
                stream)
    if rc != 0:
        raise RuntimeError(f"fused_quantiles launch failed: CUDA error {rc}")
    fused_quantiles.launches += 1
    return out


fused_quantiles.launches = 0
