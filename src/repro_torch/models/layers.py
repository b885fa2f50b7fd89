"""Shared layer primitives: norms, MLPs, RoPE, embeddings.

Copy of ``repro.models.layers`` in PyTorch: plain functions over dicts
of tensors.  Products run in the parameters' dtype (bf16) with f32
accumulation; norms and RoPE compute in f32 and cast back.  Where JAX
would promote mixed operands (a bf16 activation against f32 weights),
``matmul`` promotes the same way.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (from_local_as, is_dtensor,
                                              reduce_partial, replicated,
                                              shard, to_local_as)
from repro_torch.models.param import Spec

F32 = torch.float32


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.einsum``.
    DTensors take ``_sharded_matmul``."""
    dt = torch.promote_types(x.dtype, w.dtype)
    if is_dtensor(x) or is_dtensor(w):
        return _sharded_matmul(x.to(dt), w.to(dt))
    return torch.matmul(x.to(dt), w.to(dt))


def _sharded_matmul(x, w):
    """``x (..., K) @ w (K, N)`` of DTensors, as Megatron lays it out, on
    each rank's local tensors; per mesh dim:

    * a shard of a leading (batch or sequence) dim of ``x`` stays and the
      weight is gathered there (FSDP's just-in-time gather: the batch
      rides "data", which also shards the weight's embed dim);
    * a shard of ``w``'s output dim stays (column-parallel);
    * a shard of the contraction on either side splits it on both (the
      other side is sliced, with no move), and the partial sums are
      all-reduced at once (row-parallel), not carried on;
    * a shard of the contraction in ``x`` facing a column-parallel
      weight is gathered.

    Only gathers, reductions and slices move data, so the layout is the
    same on every torch release, and no product runs whole on each rank
    where either side is split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = (x if is_dtensor(x) else w).device_mesh
    x = reduce_partial(x)
    last = x.ndim - 1
    rep = [Replicate()] * mesh.ndim
    xp = list(x.placements) if is_dtensor(x) else rep
    wp = list(w.placements) if is_dtensor(w) else rep
    x_pl, w_pl, out_pl = [], [], []
    for a, b in zip(xp, wp):
        if a.is_shard() and a.dim != last:           # batch: gather w
            x_pl.append(a), w_pl.append(Replicate()), out_pl.append(a)
        elif b.is_shard() and b.dim == 1:            # column-parallel
            x_pl.append(Replicate()), w_pl.append(b)
            out_pl.append(Shard(last))
        elif a.is_shard() or (b.is_shard() and b.dim == 0):  # row-parallel
            x_pl.append(Shard(last)), w_pl.append(Shard(0))
            out_pl.append(Partial())
        else:
            x_pl.append(a), w_pl.append(b), out_pl.append(Replicate())
    out = torch.matmul(to_local_as(x, mesh, x_pl, out_pl),
                       to_local_as(w, mesh, w_pl, out_pl))
    return reduce_partial(from_local_as(out, mesh, out_pl,
                                        (*x.shape[:-1], w.shape[-1])))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_specs(cfg: ArchConfig, d: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    out = {"scale": Spec((d,), ("embed",), torch.float32, "ones")}
    if cfg.norm == "layernorm":
        out["bias"] = Spec((d,), ("embed",), torch.float32, "zeros")
    return out


def apply_norm(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    x = x.to(F32)
    if cfg.norm == "layernorm":
        x = x - x.mean(dim=-1, keepdim=True)
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + 1e-6) * p["scale"]
    if cfg.norm == "layernorm":
        x = x + p["bias"]
    return x.to(dt)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(F32)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * scale).to(dt)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU/GeGLU or plain)
# ---------------------------------------------------------------------------
def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    out = {"wo": Spec((f, d), ("mlp", "embed")),
           "wi_0": Spec((d, f), ("embed", "mlp"))}
    if cfg.glu:
        out["wi_1"] = Spec((d, f), ("embed", "mlp"))
    if cfg.use_bias:
        out["bi"] = Spec((f,), ("mlp",), torch.float32, "zeros")
        out["bo"] = Spec((d,), ("embed",), torch.float32, "zeros")
    return out


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(1.0 + torch.exp(-x))


class _Logistic(torch.autograd.Function):
    """``lax.logistic``: ``1 / (1 + exp(-x))`` forward, and its own
    derivative ``s (1 - s)`` backward, as JAX defines it.  The composed
    ops' backward is NaN where ``exp(-x)`` overflows (x < -88 in f32):
    ``0 * inf`` through the reciprocal and the exp."""

    @staticmethod
    def forward(ctx, x):
        s = _sigmoid(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` as ``jax.nn.silu`` computes it: the sigmoid is
    ``1 / (1 + exp(-x))``, every step rounded to x's dtype (in bf16
    ``F.silu``, which rounds once, differs in about 40 % of values);
    with a gradient, the sigmoid's is ``lax.logistic``'s (``_Logistic``)."""
    grad = torch.is_grad_enabled() and x.requires_grad
    return x * (_Logistic.apply(x) if grad else _sigmoid(x))


@functools.lru_cache(maxsize=None)
def _rounded(c: float, dtype: torch.dtype) -> float:
    return torch.tensor(c, dtype=dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh GeLU as ``jax.nn.gelu`` (``approximate=True``, its
    default) computes it: ``x * 0.5 (1 + tanh(c1 (x + c2 x^3)))`` with
    ``c1 = sqrt(2 / pi)`` and ``c2 = 0.044715`` first rounded to x's dtype,
    every step rounded to x's dtype (``F.gelu(approximate="tanh")``
    rounds once)."""
    c1 = _rounded(math.sqrt(2.0 / math.pi), x.dtype)
    c2 = _rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c1 * (x + c2 * (x * x * x)))))


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return silu(x) if cfg.act == "silu" else gelu(x)


def apply_mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = matmul(x, p["wi_0"])
    if "bi" in p:
        h = h + p["bi"].to(h.dtype)
    h = _act(cfg, h)
    if cfg.glu:
        h = h * matmul(x, p["wi_1"])
    h = shard(h, *(("batch", "res_seq", "mlp") if h.ndim == 3
                   else ("batch", "mlp")))
    o = matmul(h, p["wo"])
    if "bo" in p:
        o = o + p["bo"].to(o.dtype)
    return o


# ---------------------------------------------------------------------------
# RoPE (partial-rotary aware)
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=F32,
                                          device=x.device) / half)
    ang = positions[..., None].to(F32) * freq                # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = xr[..., :half].to(F32), xr[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_specs(cfg: ArchConfig) -> dict:
    return {"tokens": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           scale=1.0)}


class _ConcreteGrad(torch.autograd.Function):
    """The identity on a DTensor whose gradient arrives with its partial
    sums reduced: the masked lookup of a vocabulary-sharded table takes
    the whole gradient of its rows (DTensor cannot turn a partial-sum
    gradient into the lookup's masked partial)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_partial(g)


def embed_tokens(cfg: ArchConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows of the embedding; gemma scales them by
    ``sqrt(d_model)`` rounded to their dtype, as the JAX package does (a
    Python number: no host tensor is built on each call).  A DTensor
    table takes ``embedding``, which DTensor runs on a vocabulary-sharded
    table as a masked lookup and one all-reduce (an index would gather
    the table first); a plain one is indexed, the same rows."""
    table = p["tokens"]
    if is_dtensor(table):
        # the embed dim's FSDP shard gathered just in time, the
        # vocabulary's kept; the tokens take the batch shard of the rows
        # first, so the masked lookup's mask is the rows' own
        from torch.distributed.tensor import Replicate
        table = table.redistribute(table.device_mesh, [
            q if q.is_shard() and q.dim == 0 else Replicate()
            for q in table.placements])
        tokens = shard(replicated(tokens, table), *("batch", "seq")[
            :tokens.ndim])
        x = torch.nn.functional.embedding(tokens.long(), table)
        x = _ConcreteGrad.apply(reduce_partial(x))
    else:
        x = table[tokens.long()]
    if cfg.name.startswith("gemma"):
        x = x * _rounded(math.sqrt(cfg.d_model), x.dtype)
    return shard(x, *(("batch", "seq", "embed") if x.ndim == 3
                      else ("batch", "embed")))


def unembed(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    kern = (params["embed"]["tokens"] if cfg.tie_embeddings
            else params["unembed"]["kernel"])
    logits = matmul(x, kern.t())
    if cfg.attn_logit_softcap:  # gemma-style final softcap reuse
        c = cfg.attn_logit_softcap
        logits = torch.tanh(logits / c) * c
    return shard(logits, *(("batch", "seq", "vocab") if logits.ndim == 3
                           else ("batch", "vocab")))
