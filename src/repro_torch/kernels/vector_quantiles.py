"""Wrapper of the fused-quantile CUDA kernel (``csrc/vector_quantiles.cu``).

``fused_quantiles`` replaces the Pallas kernel
``repro/kernels/vector_quantiles.py:fused_quantiles``: p50/p95/p99 of
every row of a ``[C, K]`` f32 latency matrix (+inf padded past each
row's count) in one launch, by an exact radix select over 8-bit digits.
Its plain PyTorch version is ``ref.fused_quantiles`` (a full sort); the
two are bit-equal.  ``launch_plan`` is the launch's geometry (blocks a
row, shared memory a block, resident or streamed slices), a pure
function of the shape.  ``fused_quantiles.launches`` counts the
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import VECTOR_QS
from repro_torch.kernels.vector_step import _check

#: blocks of a row's thread-block cluster: at most the portable 8
MAX_CLUSTER = 8
#: a row is split further only while each block keeps this many values
#: (a cluster barrier a round costs more than a smaller slice saves below
#: it, on the H100)
MIN_SLICE = 16384
#: the kernel's dynamic shared memory besides its slice (kHistBytes of
#: the source: 6 histograms of 256 words, and three times as many for
#: the cluster's totals)
HIST_BYTES = 4 * 4 * 6 * 256
#: shared memory a block of an H100 can opt into, less a margin for the
#: kernel's static shared memory
SMEM_BYTES = 232448 - 1024
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132


def launch_plan(C: int, K: int, sms: int = H100_SMS,
                smem_bytes: int = SMEM_BYTES) -> tuple:
    """``(cluster, width, resident)`` of a launch over ``[C, K]``.

    ``cluster`` blocks (1, 2, 4 or 8) split each row: doubled while the
    doubled grid still gives each of the ``sms`` SMs at most one block
    and each block keeps at least ``MIN_SLICE`` values, and further
    until a block's slice of ``width`` words (``ceil(K / cluster)``
    rounded up to 4) fits its shared memory beside the histograms.
    ``resident`` is False when even 8 blocks cannot hold the row: each
    round then streams the slices from device memory (``cluster`` 8)."""
    if C < 1 or K < 1:
        raise ValueError(f"unsupported quantile shape C={C} K={K}")

    def width(cs):
        per_block = -(-K // cs)
        return -(-per_block // 4) * 4

    def fits(cs):
        return HIST_BYTES + 4 * (width(cs) + 4) <= smem_bytes

    cs = 1
    while (cs < MAX_CLUSTER and C * cs * 2 <= sms
           and K // (2 * cs) >= MIN_SLICE):
        cs *= 2
    while cs < MAX_CLUSTER and not fits(cs):
        cs *= 2
    return cs, width(cs), fits(cs)


def fused_quantiles(lat: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``lat`` [C, K] f32 on the card (non-negative samples, +inf past
    ``counts``), ``counts`` [C] int32 -> [C, 3] f32 p50/p95/p99, NaN
    rows where the count is 0.

    The kernel reads only the first ``min(counts[i], K)`` values of row
    ``i``: past them the row must hold +inf, which no rank below the
    count selects, so the result is that of the whole row (a count
    above ``K`` clamps its ranks into the row, as the sort's gather
    does)."""
    if lat.dim() != 2 or lat.shape[0] < 1 or lat.shape[1] < 1:
        raise ValueError(f"lat: expected a non-empty [C, K] matrix, got "
                         f"{tuple(lat.shape)}")
    C, K = lat.shape
    _check(lat, "lat", torch.float32, (C, K))
    _check(counts, "counts", torch.int32, (C,))
    if counts.device != lat.device:
        raise ValueError(f"counts on {counts.device}, lat on {lat.device}")
    sms = torch.cuda.get_device_properties(lat.device).multi_processor_count
    cluster, width, resident = launch_plan(C, K, sms)
    out = torch.empty((C, len(VECTOR_QS)), dtype=torch.float32,
                      device=lat.device)
    fn = _build.load("vector_quantiles").fused_quantiles
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(lat.device):
        stream = torch.cuda.current_stream(lat.device).cuda_stream
        rc = fn(lat.data_ptr(), counts.data_ptr(), out.data_ptr(), C, K,
                cluster, width, int(resident), stream)
    if rc != 0:
        raise RuntimeError(f"fused_quantiles launch failed: CUDA error {rc} "
                           f"(C={C} K={K} cluster={cluster} width={width} "
                           f"resident={resident})")
    fused_quantiles.launches += 1
    return out


fused_quantiles.launches = 0
