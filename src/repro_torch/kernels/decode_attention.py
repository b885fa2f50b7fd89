"""Wrapper of the flash-decode CUDA kernel (``csrc/decode_attention.cu``).

``decode_attention`` replaces the Pallas kernel
``repro/kernels/decode_attention.py:decode_attention``: attention of one
query token per batch row, ``q (B, H, hd)`` (bf16, or f32 in a model
run in f32), over the bf16 decode cache ``k, v (B, T, KV, hd)``, with
per-row ``lengths``, per-slot absolute ``key_positions`` (-1 = empty
slot; a ring for sliding-window layers), the query position ``q_pos`` and
an optional window.  Its plain PyTorch version is
``ref.decode_attention``.  The kernel rounds where the plain version (the
oracle) does: the normalised probabilities to bf16 before P·V, the
output once; the two differ only where f32 sums taken in another order
land a probability or an output on the other side of a bf16 step.
``decode_attention.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, check_window
from repro_torch.kernels.vector_step import _check

#: query heads per KV head one block holds
MAX_GROUP = 16


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     lengths: torch.Tensor, key_positions=None, q_pos=None,
                     window=None) -> torch.Tensor:
    """``q (B, H, hd)`` bf16 or f32, ``k, v (B, T, KV, hd)`` bf16,
    contiguous, on the card; ``lengths (B,)``, ``key_positions (B, T)``
    (default ``arange(T)``), ``q_pos (B,)`` (default ``lengths - 1``),
    integer -> ``(B, H, hd)`` bf16 (v's dtype)."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"expected q (B, H, hd) and k (B, T, KV, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if (KV < 1 or H % KV or H // KV > MAX_GROUP
            or not 1 <= hd <= MAX_HEAD_DIM or T < 1):
        raise ValueError(f"unsupported decode shape q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} (need H % KV == 0, "
                         f"H / KV <= {MAX_GROUP}, 1 <= hd <= "
                         f"{MAX_HEAD_DIM}, T >= 1)")
    _check(q, "q", torch.float32 if q.dtype == torch.float32
           else torch.bfloat16, (B, H, hd))
    _check(k, "k", torch.bfloat16, (B, T, KV, hd))
    _check(v, "v", torch.bfloat16, (B, T, KV, hd))
    dev = q.device
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    if key_positions is None:
        key_positions = torch.arange(T, dtype=torch.int32,
                                     device=dev).expand(B, T)
    key_positions = key_positions.to(device=dev,
                                     dtype=torch.int32).contiguous()
    if q_pos is None:
        q_pos = torch.clamp(lengths - 1, min=0)
    q_pos = q_pos.to(device=dev, dtype=torch.int32).contiguous()
    _check(lengths, "lengths", torch.int32, (B,))
    _check(key_positions, "key_positions", torch.int32, (B, T))
    _check(q_pos, "q_pos", torch.int32, (B,))
    win = check_window(window)
    out = torch.empty((B, H, hd), dtype=torch.bfloat16, device=dev)
    logits = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    fn = _build.load("decode_attention").decode_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                key_positions.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
                logits.data_ptr(), B, T, H, KV, hd, win, hd ** -0.5,
                int(q.dtype == torch.float32), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
