"""Wrappers of the slot-scan CUDA kernels (``csrc/vector_step.cu``).

``scalar_scan`` and ``batched_scan`` replace the Pallas kernels
``repro/kernels/vector_step.py:scalar_slot_advance`` and
``:batched_slot_advance``.  Where the TPU ran one kernel per slot inside
``lax.scan``, one launch here advances every cell through every slot of
``xs``; a one-slot ``xs`` is the per-slot form.  The plain PyTorch
versions are ``ref.scalar_scan`` / ``ref.batched_scan``.  The launch
geometry (cells packed into warps for up to 32 servers, one block a
cell beyond) is ``_geometry``.

Each wrapper takes CUDA tensors only, checks their device, dtype, shape
and contiguity, allocates its outputs with ``torch.empty`` and launches
on the current stream without synchronising.  ``<wrapper>.launches``
counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: server lanes one block can hold (one thread per lane)
MAX_LANES = 1024
#: warps one block of the packed path holds at most
WARPS_PER_BLOCK = 4
#: streaming multiprocessors of an H100 SXM: one-warp blocks spread over
#: them before a block takes a second warp
_SMS = 132

_F32, _I32 = torch.float32, torch.int32


def _check(x: torch.Tensor, name: str, dtype, shape: tuple) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _geometry(C: int, S: int) -> tuple:
    """Launch geometry of a scan over ``C`` cells of ``S`` server lanes:
    ``(G, cells_per_warp, warps_per_block, blocks)``.

    ``S <= 32``: a cell is a segment of ``G = next_pow2(S)`` lanes of a
    warp, so a warp holds ``32 // G`` cells; blocks of one warp spread
    over the SMs first, and a block takes up to ``WARPS_PER_BLOCK`` warps
    once there are more warps than SMs.  ``S > 32``: one block a cell,
    ``G`` threads (``S`` rounded up to a warp), ``cells_per_warp`` 0."""
    if C < 1 or not 1 <= S <= MAX_LANES:
        raise ValueError(f"unsupported scan shape C={C} S={S} "
                         f"(need C >= 1 and 1 <= S <= {MAX_LANES})")
    if S > 32:
        G = -(-S // 32) * 32
        return G, 0, G // 32, C
    G = 1 << (S - 1).bit_length()
    cells_per_warp = 32 // G
    warps = -(-C // cells_per_warp)
    per_block = min(WARPS_PER_BLOCK, max(1, warps // _SMS))
    return G, cells_per_warp, per_block, -(-warps // per_block)


def _launch(fn_name: str, ptrs: list, C: int, S: int, T: int, dt: float,
            device: torch.device) -> None:
    lib = _build.load("vector_step")
    fn = getattr(lib, fn_name)
    geometry = _geometry(C, S)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, *[ctypes.c_int] * 4,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    arr = (ctypes.c_void_p * len(ptrs))(*[p.data_ptr() for p in ptrs])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(arr, C, S, T, float(dt), *geometry, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")


def _fast_div(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The scan kernels' branch-free divide of f32 CUDA tensors ``a / b``
    (``FastDiv`` in ``csrc/vector_step.cu``) -> ``(q, bad)``: ``q`` is the
    IEEE quotient wherever ``bad`` is 0.  For the tests."""
    for x, n in ((a, "a"), (b, "b")):
        _check(x, n, _F32, tuple(a.shape))
    q = torch.empty_like(a)
    bad = torch.empty(a.shape, dtype=_I32, device=a.device)
    fn = _build.load("vector_step").vector_step_fast_div
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), q.data_ptr(), bad.data_ptr(),
                a.numel(), torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vector_step_fast_div failed: CUDA error {rc}")
    return q, bad


def _hard_consts(consts: dict) -> None:
    """The kernels implement the hard step only: soft-mode consts
    (``tau``) belong to the plain step (``kernels.ops`` routes them)."""
    if "tau" in consts:
        raise ValueError("soft-mode consts (tau): the scan kernels "
                         "implement the hard step only")


def _shape(carry0: torch.Tensor, t_idx: torch.Tensor) -> tuple:
    if carry0.dim() != 2 or t_idx.dim() != 1:
        raise ValueError("expected carry lanes [C, S] and slot index [T]")
    C, S = carry0.shape
    T = t_idx.shape[0]
    if C < 1 or T < 1 or not 1 <= S <= MAX_LANES:
        raise ValueError(f"unsupported scan shape C={C} S={S} T={T} "
                         f"(need C, T >= 1 and 1 <= S <= {MAX_LANES})")
    return C, S, T


def scalar_scan(consts: dict, carry: tuple, xs: tuple):
    """Scalar-family scan over every slot of ``xs`` on the card.

    consts ``c`` f32 / ``fail_slot`` i32 ``[C, S]``, ``dt`` float; carry
    ``(U, Q [C, S], drops [C])``; xs ``(t [T] i32, Nc, Wc [T, C, S],
    Nf, Wf [T, C], act, acc, spd [T, C, S])`` -> (carry, ys ``(wait_U,
    wait_free [T, C], n_served, drained, Q)``)."""
    _hard_consts(consts)
    U, Q, drops = carry
    t_idx, Nc, Wc, Nf, Wf, act, acc, spd = xs
    C, S, T = _shape(U, t_idx)
    cs, tcs, tc1 = (C, S), (T, C, S), (T, C)
    for x, n, dtype, shape in (
            (consts["c"], "c", _F32, cs), (consts["fail_slot"], "fail_slot",
                                           _I32, cs),
            (t_idx, "t", _I32, (T,)), (Nc, "Nc", _F32, tcs),
            (Wc, "Wc", _F32, tcs), (Nf, "Nf", _F32, tc1),
            (Wf, "Wf", _F32, tc1), (act, "act", _F32, tcs),
            (acc, "acc", _F32, tcs), (spd, "spd", _F32, tcs),
            (U, "U", _F32, cs), (Q, "Q", _F32, cs),
            (drops, "drops", _F32, (C,))):
        _check(x, n, dtype, shape)
    new_carry = (torch.empty_like(U), torch.empty_like(Q),
                 torch.empty_like(drops))
    ys = (torch.empty(tcs, dtype=_F32, device=U.device),
          torch.empty(tc1, dtype=_F32, device=U.device),
          *(torch.empty(tcs, dtype=_F32, device=U.device) for _ in range(3)))
    _launch("scalar_scan",
            [consts["c"], consts["fail_slot"], t_idx, Nc, Wc, Nf, Wf, act,
             acc, spd, U, Q, drops, *new_carry, *ys],
            C, S, T, consts["dt"], U.device)
    scalar_scan.launches += 1
    return new_carry, ys


scalar_scan.launches = 0


def batched_scan(consts: dict, carry: tuple, xs: tuple):
    """Batched-family (roofline) scan over every slot of ``xs`` on the
    card.

    consts ``c`` (batch slots) f32 / ``fail_slot`` i32 ``[C, S]``,
    ``tm``/``tc``/``new_mean`` f32 ``[C, 1]``, ``dt`` float; carry
    ``(P, T, L [C, S], drops [C])``; xs ``(t [T] i32, Nc, Wpc, Wtc
    [T, C, S], Nf, Wpf, Wtf [T, C], act, acc, spd [T, C, S])`` ->
    (carry, ys ``(wait_adm, st_hat, N_arr, n_served, busy_used, L,
    tok_served)``, each ``[T, C, S]``)."""
    _hard_consts(consts)
    P, Tk, L, drops = carry
    t_idx, Nc, Wpc, Wtc, Nf, Wpf, Wtf, act, acc, spd = xs
    C, S, T = _shape(P, t_idx)
    cs, tcs, tc1 = (C, S), (T, C, S), (T, C)
    for x, n, dtype, shape in (
            (consts["c"], "c", _F32, cs), (consts["fail_slot"], "fail_slot",
                                           _I32, cs),
            (consts["tm"], "tm", _F32, (C, 1)),
            (consts["tc"], "tc", _F32, (C, 1)),
            (consts["new_mean"], "new_mean", _F32, (C, 1)),
            (t_idx, "t", _I32, (T,)), (Nc, "Nc", _F32, tcs),
            (Wpc, "Wpc", _F32, tcs), (Wtc, "Wtc", _F32, tcs),
            (Nf, "Nf", _F32, tc1), (Wpf, "Wpf", _F32, tc1),
            (Wtf, "Wtf", _F32, tc1), (act, "act", _F32, tcs),
            (acc, "acc", _F32, tcs), (spd, "spd", _F32, tcs),
            (P, "P", _F32, cs), (Tk, "T", _F32, cs), (L, "L", _F32, cs),
            (drops, "drops", _F32, (C,))):
        _check(x, n, dtype, shape)
    new_carry = (torch.empty_like(P), torch.empty_like(Tk),
                 torch.empty_like(L), torch.empty_like(drops))
    ys = tuple(torch.empty(tcs, dtype=_F32, device=P.device)
               for _ in range(7))
    _launch("batched_scan",
            [consts["c"], consts["fail_slot"], consts["tm"], consts["tc"],
             consts["new_mean"], t_idx, Nc, Wpc, Wtc, Nf, Wpf, Wtf, act,
             acc, spd, P, Tk, L, drops, *new_carry, *ys],
            C, S, T, consts["dt"], P.device)
    batched_scan.launches += 1
    return new_carry, ys


batched_scan.launches = 0
