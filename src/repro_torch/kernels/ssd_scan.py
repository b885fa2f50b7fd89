"""Wrapper of the Mamba-2 SSD chunked-scan CUDA kernel
(``csrc/ssd_scan.cu``).

``ssd_scan`` replaces the Pallas kernel ``repro/kernels/ssd_scan.py
:ssd_scan``: the chunked SSD scan of ``x (b, s, h, p)`` with ``dt (b, s,
h)``, ``A (h,)`` and the single B/C group ``(b, s, 1, n)``, carrying the
``(b, h, p, n)`` state from ``h0`` (or zero) across the chunks, ``s`` a
multiple of ``chunk``.  It returns ``y`` and the final state in f32.
Its plain PyTorch version is ``ref.ssd_chunked``; ``kernels.ops
.ssd_scan`` pads any ``s`` to a multiple of the chunk.  Both compute in
f32 from inputs widened first; the kernel's tensor-core products take
every f32 operand as bf16 parts (hi and lo; three parts beside f32
inputs), so the two differ by the order of f32 sums and those parts'
last bits.  One call makes three launches (chunk states with the
chunk's C.B^T tiles, state passing, chunk outputs), four for f32 inputs
(their split into bf16 parts first); ``ssd_scan.launches`` counts the
calls, one each.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vector_step import _check

#: the kernel's limits: head_dim and d_state columns, chunk rows
MAX_HEAD_DIM = 128
MAX_STATE = 128
MAX_CHUNK = 1024

_F32 = torch.float32


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int,
             h0=None) -> tuple:
    """x ``(b, s, h, p)``, B and C ``(b, s, 1, n)``, all bf16 or all f32;
    dt ``(b, s, h)``, A ``(h,)`` and h0 ``(b, h, p, n)`` (or None) f32;
    contiguous, on the card; ``s % chunk == 0`` -> (y ``(b, s, h, p)``,
    hN ``(b, h, p, n)``), both f32."""
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"expected x (b, s, h, p) and B (b, s, 1, n), got "
                         f"{tuple(x.shape)} and {tuple(B.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if B.shape[2] != 1:
        raise ValueError(f"expected one B/C group, got {B.shape[2]}")
    if not (1 <= p <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE
            and 1 <= chunk <= MAX_CHUNK and s >= 1 and s % chunk == 0):
        raise ValueError(f"unsupported SSD shape x {tuple(x.shape)} n {n} "
                         f"chunk {chunk} (need p <= {MAX_HEAD_DIM}, n <= "
                         f"{MAX_STATE}, chunk <= {MAX_CHUNK}, s % chunk "
                         f"== 0)")
    et = x.dtype if x.dtype in (torch.bfloat16, _F32) else torch.bfloat16
    _check(x, "x", et, (b, s, h, p))
    _check(B, "B", et, (b, s, 1, n))
    _check(C, "C", et, (b, s, 1, n))
    _check(dt, "dt", _F32, (b, s, h))
    _check(A, "A", _F32, (h,))
    if h0 is not None:
        _check(h0, "h0", _F32, (b, h, p, n))
    f32 = et == _F32
    nc, parts = s // chunk, 3 if f32 else 2

    def empty(*shape, dtype=_F32):
        return torch.empty(shape, dtype=dtype, device=x.device)
    y, hN = empty(b, s, h, p), empty(b, h, p, n)
    # scratch: each chunk's own state, its decay exp(cum_L), its C.B^T
    # tiles (t >= s), the state entering it as bf16 parts and, for f32
    # inputs, their bf16 parts
    upd, decay = empty(b, nc, h, p, n), empty(b, nc, h)
    tiles = -(-chunk // 64)
    cb = empty(b, nc, tiles * (tiles + 1) // 2, 64, 64)
    hin = empty(b, nc, h, parts, p, n, dtype=torch.bfloat16)
    planes = (empty(3 * (x.numel() + 2 * B.numel()), dtype=torch.bfloat16)
              if f32 else None)
    fn = _build.load("ssd_scan").ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), None if h0 is None else h0.data_ptr(),
                y.data_ptr(), hN.data_ptr(), upd.data_ptr(),
                decay.data_ptr(), cb.data_ptr(), hin.data_ptr(),
                None if planes is None else planes.data_ptr(), b, s, h, p,
                n, int(chunk), int(f32), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    return y, hN


ssd_scan.launches = 0
