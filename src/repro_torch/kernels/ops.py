"""Kernel dispatch by the device of the tensors.

A CUDA tensor launches the hand-written kernel (or the wrapper raises);
a CPU tensor takes the kernel's plain PyTorch version in ``ref``, and so
does a ``meta`` tensor (the dry-run's shapes, ``launch.dryrun``).
There is no switch that sends a CUDA tensor down the plain path, and no
fallback when a build or launch fails.  The one routing rule besides
the device: scan consts that carry a soft-mode ``tau`` run the plain
step with the smoothed water-fill on the grid's own device, the card
included — the reference pins soft consts to its jnp step
(``repro/kernels/ops.py``), and no kernel implements them.

Gradients: the JAX package writes no backward kernel (no ``custom_vjp``;
off the TPU its ``impl="auto"`` runs the jnp oracle, so its gradient is
the oracle's).  Here a CUDA input that needs a gradient goes through an
``autograd.Function`` whose forward launches the hand-written kernel and
keeps its inputs, and whose backward recomputes the plain version under
autograd and returns its gradient.  On the CPU the plain version is
differentiated directly; with no gradient needed (serving) a CUDA tensor
takes the kernel as before, launch for launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref, vector_quantiles, vector_step
from repro_torch.kernels import ssd_scan as _ssd


def _on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor; False for a CPU tensor and for a ``meta``
    tensor (shapes only), which take the plain version: the dry-run
    (``launch.dryrun``) asks for ``meta`` by name, as the reference's
    dry-run asks for ``impl="ref"``.  Any other device raises."""
    if x.is_cuda:
        return True
    if x.device.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    return False


def _scan_kernel(consts: dict, x: torch.Tensor) -> bool:
    """True where the scan kernel runs: hard consts on a CUDA tensor.
    Soft consts (``tau``) take the plain step wherever ``x`` lies."""
    return _on_cuda(x) and "tau" not in consts


def scalar_scan(consts: dict, carry: tuple, xs: tuple):
    """Scalar-family slot scan over every slot of ``xs``."""
    if _scan_kernel(consts, carry[0]):
        return vector_step.scalar_scan(consts, carry, xs)
    return ref.scalar_scan(consts, carry, xs)


def batched_scan(consts: dict, carry: tuple, xs: tuple):
    """Batched-family (roofline) slot scan over every slot of ``xs``."""
    if _scan_kernel(consts, carry[0]):
        return vector_step.batched_scan(consts, carry, xs)
    return ref.batched_scan(consts, carry, xs)


def fused_quantiles(lat: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """p50/p95/p99 of every row of ``lat`` (+inf padded past
    ``counts``) -> [C, 3] f32, NaN rows where the count is 0."""
    if _on_cuda(lat):
        return vector_quantiles.fused_quantiles(lat, counts)
    return ref.fused_quantiles(lat, counts)


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def _plain_grads(ctx, plain, outputs_grad):
    """The gradient of the plain version ``plain(*inputs)`` at the
    inputs the forward kept, for the inputs that need one."""
    inputs = ctx.saved_tensors
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(need) if x is not None else None
              for x, need in zip(inputs, ctx.needs_input_grad)]
        outs = plain(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [x for x, need in zip(xs, ctx.needs_input_grad)
               if x is not None and need]
        grads = iter(torch.autograd.grad(outs, wrt, outputs_grad))
    return [next(grads) if x is not None and need else None
            for x, need in zip(xs, ctx.needs_input_grad)]


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: the kernel forward, the plain
    version's backward (recomputed from q, k, v)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        return _flash.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad_out):
        causal, window = ctx.mask

        def plain(q, k, v):
            return ref.flash_attention(q, k, v, causal=causal, window=window)
        return (*_plain_grads(ctx, plain, (grad_out,)), None, None)


class SSDScanFn(torch.autograd.Function):
    """``ssd_scan`` with a gradient: the kernel forward, the plain
    version's (``ref.ssd_chunked``) backward, recomputed from the
    inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0, chunk):
        ctx.save_for_backward(x, dt, A, B, C, h0)
        ctx.chunk = chunk
        return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk, h0=h0)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        def plain(x, dt, A, B, C, h0):
            return ref.ssd_chunked(x, dt, A, B, C, chunk=ctx.chunk, h0=h0)
        return (*_plain_grads(ctx, plain, (grad_y, grad_h)), None)


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q ``(B, S, H, hd)``; k, v ``(B, T, KV, hd)`` -> ``(B, S, H, hd)``."""
    if _on_cuda(q):
        if _needs_grad(q, k, v):
            return FlashAttentionFn.apply(q, k, v, causal, window)
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return ref.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, *, lengths, key_positions=None, q_pos=None,
                     window=None):
    """q ``(B, H, hd)``; k, v ``(B, T, KV, hd)``; lengths ``(B,)`` ->
    ``(B, H, hd)``."""
    if _on_cuda(q):
        return _decode.decode_attention(q, k, v, lengths=lengths,
                                        key_positions=key_positions,
                                        q_pos=q_pos, window=window)
    return ref.decode_attention(q, k, v, lengths=lengths,
                                key_positions=key_positions, q_pos=q_pos,
                                window=window)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256, h0=None):
    """Mamba-2 SSD.  x ``(b, s, h, p)``; dt ``(b, s, h)``; A ``(h,)``; B, C
    ``(b, s, 1, n)`` -> (y ``(b, s, h, p)`` f32, final state ``(b, h, p,
    n)`` f32).  Any ``s``: the sequence is padded with zeros to a multiple
    of ``chunk`` (``dt = 0`` is state-neutral: decay 1, zero update) and
    ``y`` is cut back to ``s``."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        def padt(a):
            return torch.nn.functional.pad(
                a, [0, 0] * (a.dim() - 2) + [0, pad])
        x, dt, B, C = padt(x), padt(dt), padt(B), padt(C)
    if _on_cuda(x):
        args = (x.contiguous(), dt.contiguous(), A.contiguous(),
                B.contiguous(), C.contiguous(),
                None if h0 is None else h0.contiguous())
        if _needs_grad(*args):
            y, h = SSDScanFn.apply(*args, chunk)
        else:
            y, h = _ssd.ssd_scan(*args[:5], chunk=chunk, h0=args[5])
    else:
        y, h = ref.ssd_chunked(x, dt, A, B, C, chunk=chunk, h0=h0)
    return (y[:, :s] if pad else y), h
