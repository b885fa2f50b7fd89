"""Wrapper of the split-K flash-decode CUDA kernel
(``csrc/decode_attention.cu``).

``decode_attention`` replaces the Pallas kernel
``repro/kernels/decode_attention.py:decode_attention``: attention of one
query token per batch row, ``q (B, H, hd)`` (bf16, or f32 in a model
run in f32), over the bf16 decode cache ``k, v (B, T, KV, hd)``, with
per-row ``lengths``, per-slot absolute ``key_positions`` (-1 = empty
slot; a ring for sliding-window layers), the query position ``q_pos`` and
an optional window.  Its plain PyTorch version is ``ref.decode_attention``.

The cache is cut into splits of ``block_t`` slots (the Pallas kernel's
own argument; by default ``default_block_t``), one block per (KV head,
row, split), in three launches: the logits and each split's softmax
statistics; P·V of each split with the row's global max and sum; the sum
of the splits' partials (skipped with one split).  The kernel rounds
where the plain version (the oracle) does: the globally normalised
probabilities to bf16 before P·V, the output once; the two differ only
where f32 sums taken in another order land a probability or an output on
the other side of a bf16 step.  What bounds it is bytes, and at the
served shapes the chains of dependent memory round trips (the source's
note).  ``decode_attention.launches`` counts the wrapper's calls that
launched the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, check_window
from repro_torch.kernels.vector_step import _check

#: query heads per KV head one block holds
MAX_GROUP = 16
#: fewest cache slots of a default split
MIN_BLOCK_T = 32


def default_block_t(B: int, T: int, KV: int, sms: int) -> int:
    """Cache slots per split from the shapes and the card's ``sms``
    streaming multiprocessors: ``T // s`` for the ``s`` splits that give
    ``KV * B * s >= 2 * sms`` blocks (each launch fills the SMs at least
    twice), but at least ``MIN_BLOCK_T`` slots.  On an H100 SXM (132
    SMs): B4 T192 KV32: 64 (3 splits, 384 blocks); B4 T512 KV8: 56 (10,
    320); B4 T1024 KV8: 113 (10, 320); B1 T192 KV32: 32 (6, 192)."""
    splits = -(-2 * sms // (KV * B))
    return max(MIN_BLOCK_T, T // splits)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _entry():
    fn = _build.load("decode_attention").decode_attention
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     lengths: torch.Tensor, key_positions=None, q_pos=None,
                     window=None, block_t=None, lse_only: bool = False,
                     lse=None) -> torch.Tensor:
    """``q (B, H, hd)`` bf16 or f32, ``k, v (B, T, KV, hd)`` bf16,
    contiguous, on the card; ``lengths (B,)``, ``key_positions (B, T)``
    (default ``arange(T)``), ``q_pos (B,)`` (default ``lengths - 1``),
    integer; ``block_t`` cache slots per split (default
    ``default_block_t``; any ``>= 1``, the last split may be shorter) ->
    ``(B, H, hd)`` bf16 (v's dtype).  The two rounds of a flash-decode
    across ranks (``kernels.ops``): ``lse_only`` -> ``(B, H)`` f32, each
    head's log-sum-exp of its scaled, masked logits over these slots (no
    output); ``lse (B, H)`` f32, the rows' log-sum-exp over every rank's
    slots -> ``(B, H, hd)`` f32, the unrounded sum of ``bf16(exp(s -
    lse)) v`` over these slots.  Without either the launches are those
    of a plain call, bit for bit."""
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
    if block_t is not None and not (block_t >= 1
                                    and -(-T // block_t) <= 65535):
        raise ValueError(f"block_t {block_t} must be >= 1 and give at most "
                         f"65535 splits of T = {T}")
    _check(q, "q", torch.float32 if q.dtype == torch.float32
           else torch.bfloat16, (B, H, hd))
    _check(k, "k", torch.bfloat16, (B, T, KV, hd))
    _check(v, "v", torch.bfloat16, (B, T, KV, hd))
    dev = q.device
    if block_t is None:
        block_t = default_block_t(B, T, KV, _sm_count(dev.index))
    n_split = -(-T // block_t)
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
    if lse_only and lse is not None:
        raise ValueError("lse_only and lse exclude each other")
    mode = 1 if lse_only else 2 if lse is not None else 0
    if mode == 1:
        lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    elif mode == 2:
        _check(lse, "lse", torch.float32, (B, H))
    out = torch.empty((B, H, hd), device=dev, dtype=(
        torch.float32 if mode == 2 else torch.bfloat16)) if mode != 1 \
        else lse
    # one f32 scratch: logits (B, H, T), (m, l) (B, H, n_split, 2), the
    # partials (B, H, n_split, hd) when n_split > 1; (m, l) 16-byte aligned
    n_logits = -(-B * H * T // 4) * 4
    n_ml = B * H * n_split * 2
    n_part = B * H * n_split * hd if n_split > 1 else 0
    scratch = torch.empty(n_logits + n_ml + n_part, dtype=torch.float32,
                          device=dev)
    logits = scratch.data_ptr()
    ml = logits + 4 * n_logits
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lengths.data_ptr(), key_positions.data_ptr(),
                      q_pos.data_ptr(), out.data_ptr(), logits, ml,
                      ml + 4 * n_ml, B, T, H, KV, hd, win, hd ** -0.5,
                      int(q.dtype == torch.float32), block_t,
                      None if lse is None else lse.data_ptr(), mode, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{rc}")
    decode_attention.launches += 1
    if mode == 1:
        decode_attention.lse_launches += 1
        return lse
    if mode == 2:
        decode_attention.partial_launches += 1
    return out


decode_attention.launches = 0
#: of those, the launches with the LSE output (``lse_only``) and those
#: with the LSE input (``lse``): the two rounds of a flash-decode across
#: ranks
decode_attention.lse_launches = 0
decode_attention.partial_launches = 0
