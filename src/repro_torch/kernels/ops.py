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

Sharded execution: where an argument is a DTensor (``torch.distributed
.tensor``, a model run under ``distributed.sharding.mesh_context``),
``flash_attention``, ``decode_attention`` and ``ssd_scan`` run on each
rank's local shard through ``local_map``: the inputs are laid out so
that every rank holds whole sequences of whole heads (a batch shard
stays, a sequence shard becomes a head shard where the heads divide, an
all-to-all, else is gathered), the same dispatch as above runs on the
local tensors (the kernel on the card, the plain version on the CPU or
``meta``), and the output is a DTensor of that layout.  Grouped-query
attention with the query heads sharded and the KV heads replicated reads
on each rank only the KV heads its query heads use.  Decode over a cache
sharded along its slots is a flash-decode across ranks: each rank runs
the kernel over its slice of every head for all query heads (q is
gathered first; it is one token), in two rounds around an all-gather of
the slices' log-sum-exps and followed by an all-reduce of the f32
partial outputs (``_sharded_decode``).
A DTensor never reaches a kernel's launch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref, vector_quantiles, vector_step
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.distributed.sharding import (from_local_as, is_dtensor,
                                              mesh_chunk, mesh_context,
                                              to_local_as)


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
    if is_dtensor(q) or is_dtensor(k):
        return _sharded_flash(q, k, v, causal, window)
    if _on_cuda(q):
        if _needs_grad(q, k, v):
            return FlashAttentionFn.apply(q, k, v, causal, window)
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return ref.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, *, lengths, key_positions=None, q_pos=None,
                     window=None, lse_only: bool = False, lse=None):
    """q ``(B, H, hd)``; k, v ``(B, T, KV, hd)``; lengths ``(B,)`` ->
    ``(B, H, hd)``; ``lse_only`` and ``lse`` are the two rounds of a
    flash-decode across ranks (``ref.decode_attention``)."""
    if is_dtensor(q) or is_dtensor(k):
        return _sharded_decode(q, k, v, lengths, key_positions, q_pos,
                               window)
    if _on_cuda(q):
        return _decode.decode_attention(q, k, v, lengths=lengths,
                                        key_positions=key_positions,
                                        q_pos=q_pos, window=window,
                                        lse_only=lse_only, lse=lse)
    return ref.decode_attention(q, k, v, lengths=lengths,
                                key_positions=key_positions, q_pos=q_pos,
                                window=window, lse_only=lse_only, lse=lse)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256, h0=None):
    """Mamba-2 SSD.  x ``(b, s, h, p)``; dt ``(b, s, h)``; A ``(h,)``; B, C
    ``(b, s, 1, n)`` -> (y ``(b, s, h, p)`` f32, final state ``(b, h, p,
    n)`` f32).  Any ``s``: the sequence is padded with zeros to a multiple
    of ``chunk`` (``dt = 0`` is state-neutral: decay 1, zero update) and
    ``y`` is cut back to ``s``."""
    if is_dtensor(x):
        return _sharded_ssd(x, dt, A, B, C, chunk, h0)
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


# ---------------------------------------------------------------------------
# DTensor arguments: the kernels on each rank's local shard
# ---------------------------------------------------------------------------
def _placements():
    from torch.distributed.tensor import Replicate, Shard
    return Replicate, Shard


def _waited(t):
    """A functional collective's result, waited for (its ``wait``)."""
    return t.wait() if hasattr(t, "wait") else t


def _is_shard(p, dim: int) -> bool:
    return p.is_shard() and p.dim == dim


def _head_layout(x, seq_dim: int, head_dim: int, heads: int):
    """The placements that give each rank whole sequences of whole heads
    of ``x``, per mesh dim: a batch shard (dim 0) stays; a shard of the
    sequence or of the heads becomes a head shard where ``heads`` divide
    (a sequence shard moves to the heads by an all-to-all); anything else
    is replicated.  -> (placements, the mesh dims that shard the heads)."""
    Replicate, Shard = _placements()
    mesh = x.device_mesh
    pl, hdims, nh = [], [], 1
    for d, p in enumerate(x.placements):
        n = mesh.size(d)
        if _is_shard(p, 0):
            pl.append(Shard(0))
        elif (_is_shard(p, seq_dim) or _is_shard(p, head_dim)) \
                and heads % (nh * n) == 0:
            nh *= n
            hdims.append(d)
            pl.append(Shard(head_dim))
        else:
            pl.append(Replicate())
    return pl, hdims


def _kv_heads(q_pl, hdims, heads: int, kv_heads: int, mesh):
    """The KV placements beside query placements ``q_pl`` (heads over the
    mesh dims ``hdims``), and the slice of the local KV heads a rank's
    query heads read: KV heads sharded like the query heads where they
    divide (no slice), else replicated there, each rank slicing the KV
    heads of its own query heads.  -> (kv placements, slice or None), or
    None where the query heads split a group unevenly."""
    Replicate, Shard = _placements()
    nh = math.prod(mesh.size(d) for d in hdims)
    if nh == 1 or kv_heads % nh == 0:
        return ([Shard(2) if d in hdims else p for d, p in enumerate(q_pl)],
                None)
    hl, g = heads // nh, heads // kv_heads
    if hl % g and g % hl:
        return None
    c, _ = mesh_chunk(mesh, hdims)
    k0 = c * hl // g
    kv_pl = [Replicate() if d in hdims else p for d, p in enumerate(q_pl)]
    return kv_pl, slice(k0, k0 + max(1, hl // g))


def _sharded_flash(q, k, v, causal, window):
    """``flash_attention`` of DTensors: each rank's whole sequences of
    its query heads over the KV heads they read."""
    Replicate, _ = _placements()
    mesh = (q if is_dtensor(q) else k).device_mesh
    H, KV = q.shape[2], k.shape[2]
    q_pl, hdims = _head_layout(q, 1, 2, H)
    kv = _kv_heads(q_pl, hdims, H, KV, mesh)
    if kv is None:            # uneven groups: every rank takes all heads
        q_pl = [Replicate() if d in hdims else p for d, p in enumerate(q_pl)]
        kv = (q_pl, None)
    kv_pl, cut = kv
    ql = to_local_as(q, mesh, q_pl)
    kl = to_local_as(k, mesh, kv_pl, q_pl)
    vl = to_local_as(v, mesh, kv_pl, q_pl)
    if cut is not None:
        kl, vl = kl[:, :, cut], vl[:, :, cut]
    o = flash_attention(ql, kl.contiguous(), vl.contiguous(), causal=causal,
                        window=window)
    return from_local_as(o, mesh, q_pl, q.shape)


def _sharded_ssd(x, dt, A, B, C, chunk, h0):
    """``ssd_scan`` of DTensors: each rank scans whole sequences of its
    heads (the heads are independent; B and C are shared by all)."""
    Replicate, Shard = _placements()
    mesh = x.device_mesh
    x_pl, _ = _head_layout(x, 1, 2, x.shape[2])

    def like(dims):           # batch and heads as x, the rest replicated
        return [Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                else Replicate() for p in x_pl]
    xl = to_local_as(x, mesh, x_pl)
    dtl = to_local_as(dt, mesh, like({0: 0, 2: 2}), x_pl)
    Al = to_local_as(A, mesh, like({2: 0}), x_pl)
    Bl = to_local_as(B, mesh, like({0: 0}), x_pl)
    Cl = to_local_as(C, mesh, like({0: 0}), x_pl)
    st_pl = like({0: 0, 2: 1})
    hl = to_local_as(h0, mesh, st_pl, x_pl)
    with mesh_context(None):      # each rank scans its own heads
        y, h = ssd_scan(xl, dtl, Al, Bl, Cl, chunk=chunk, h0=hl)
    b, s, nh, p = x.shape
    return (from_local_as(y, mesh, x_pl, (b, s, nh, p)),
            from_local_as(h, mesh, st_pl, (b, nh, p, B.shape[-1])))


def _sharded_decode(q, k, v, lengths, key_positions, q_pos, window):
    """``decode_attention`` of DTensors.  A batch or KV-head shard of the
    cache stays (the query heads follow its KV heads); a shard of its
    slots is a flash-decode across ranks in two rounds of the kernel
    around one exchange: each rank takes the log-sum-exp of its slots for
    every query head of its rows (the kernel's LSE output; the slots'
    absolute positions mask them), the ranks all-gather these and take
    the row's ``L = logsumexp``, each rank's kernel then sums
    ``bf16(exp(s - L)) v`` over its slots in f32 (the LSE input), and an
    all-reduce of those partials, rounded once, is the output.  Every
    rank rounds the same globally normalised probabilities as one device
    does, so the result differs from the unsharded one only by the order
    of f32 sums; a slice with no valid slot adds zeros."""
    import torch.distributed._functional_collectives as funcol
    Replicate, Shard = _placements()
    mesh = (k if is_dtensor(k) else q).device_mesh
    H, KV = q.shape[1], k.shape[2]
    k_pl = list(k.placements) if is_dtensor(k) else \
        [Replicate()] * mesh.ndim
    kv_pl, row_pl, kp_pl, sdims, hdims = [], [], [], [], []
    for d, p in enumerate(k_pl):
        kv_pl.append(p if p.is_shard() and p.dim in (0, 1, 2)
                     else Replicate())
        row_pl.append(Shard(0) if _is_shard(p, 0) else Replicate())
        kp_pl.append(Shard(p.dim) if p.is_shard() and p.dim in (0, 1)
                     else Replicate())
        if _is_shard(p, 2):
            hdims.append(d)
        if _is_shard(p, 1):
            sdims.append(d)
    nh = math.prod(mesh.size(d) for d in hdims)
    if nh > 1 and (KV % nh or H % nh):
        kv_pl = [Replicate() if d in hdims else p for d, p in enumerate(kv_pl)]
        hdims = []
    q_pl = [Shard(1) if d in hdims else r for d, r in enumerate(row_pl)]
    ql = to_local_as(q, mesh, q_pl)
    kl, vl = to_local_as(k, mesh, kv_pl), to_local_as(v, mesh, kv_pl)
    lens = to_local_as(lengths, mesh, row_pl)
    qp = to_local_as(q_pos, mesh, row_pl)
    c, n = mesh_chunk(mesh, sdims)
    t = kl.shape[1]
    if key_positions is None:
        kpl = torch.arange(c * t, (c + 1) * t, dtype=torch.int32,
                           device=kl.device).expand(kl.shape[0], t)
    else:
        kpl = to_local_as(key_positions, mesh, kp_pl)
    if qp is None:            # the query position of the whole row
        qp = torch.clamp(lens - 1, min=0)
    args = dict(lengths=lens, key_positions=kpl, q_pos=qp, window=window)
    if n == 1:
        return from_local_as(decode_attention(ql, kl, vl, **args), mesh,
                             q_pl, q.shape)
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    lses = decode_attention(ql, kl, vl, lse_only=True, **args)[None]
    for d in sdims:
        lses = _waited(gather(lses, 0, (mesh, d)))
    part = decode_attention(ql, kl, vl, lse=torch.logsumexp(lses, dim=0),
                            **args)
    for d in sdims:
        part = _waited(funcol.all_reduce(part, "sum", (mesh, d)))
    return from_local_as(part.to(vl.dtype), mesh, q_pl, q.shape)
