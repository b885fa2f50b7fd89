"""Wrapper of the prefill flash-attention CUDA kernel
(``csrc/flash_attention.cu``).

``flash_attention`` replaces the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention``: softmax attention
of ``q (B, S, H, hd)`` over ``k, v (B, T, KV, hd)``, all bf16 (the
served model) or all f32, with GQA (query head ``h`` reads KV head
``h // (H // KV)``), an optional causal mask and an optional sliding
window, for any S, T and ``hd <= 256``.  Its plain PyTorch version is
``ref.flash_attention``.  The kernel keeps the probabilities in f32, as
the Pallas kernel does; the plain version rounds them to v's dtype
before P·V, as the oracle does: in f32 the two agree up to the order of
f32 sums, in bf16 they differ by the rounding of the probabilities and
one rounding of the output each.  ``flash_attention.launches`` counts
the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vector_step import _check

MAX_HEAD_DIM = 256


def check_window(window) -> int:
    """``None`` -> 0 (no window); a window must be a positive count."""
    if window is None:
        return 0
    if int(window) < 1:
        raise ValueError(f"window must be None or >= 1, got {window!r}")
    return int(window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """``q (B, S, H, hd)``, ``k, v (B, T, KV, hd)``, contiguous, all bf16
    or all f32, on the card -> ``(B, S, H, hd)`` in the same dtype.
    Query row ``i`` is at position ``i``, key ``j`` at ``j``."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q (B, S, H, hd) and k (B, T, KV, hd), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if KV < 1 or H % KV or not 1 <= hd <= MAX_HEAD_DIM or S < 1 or T < 1:
        raise ValueError(f"unsupported attention shape q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} (need H % KV == 0, "
                         f"1 <= hd <= {MAX_HEAD_DIM}, S, T >= 1)")
    dt = q.dtype if q.dtype in (torch.bfloat16, torch.float32) \
        else torch.bfloat16
    _check(q, "q", dt, (B, S, H, hd))
    _check(k, "k", dt, (B, T, KV, hd))
    _check(v, "v", dt, (B, T, KV, hd))
    win = check_window(window)
    out = torch.empty_like(q)
    fn = _build.load("flash_attention").flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, T, H, KV, hd, int(bool(causal)), win, hd ** -0.5,
                int(dt == torch.float32), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
