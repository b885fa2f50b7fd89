"""Shared layer primitives: norms, MLPs, RoPE, embeddings.

Copy of ``repro.models.layers`` in PyTorch: plain functions over dicts
of tensors.  Products run in the parameters' dtype (bf16) with f32
accumulation; norms and RoPE compute in f32 and cast back.  Where JAX
would promote mixed operands (a bf16 activation against f32 weights),
``matmul`` promotes the same way.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.param import Spec

F32 = torch.float32


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.einsum``."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


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


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = matmul(x, p["wi_0"])
    if "bi" in p:
        h = h + p["bi"].to(h.dtype)
    h = _act(cfg, h)
    if cfg.glu:
        h = h * matmul(x, p["wi_1"])
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


def embed_tokens(cfg: ArchConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = p["tokens"][tokens.long()]
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    kern = (params["embed"]["tokens"] if cfg.tie_embeddings
            else params["unembed"]["kernel"])
    logits = matmul(x, kern.t())
    if cfg.attn_logit_softcap:  # gemma-style final softcap reuse
        c = cfg.attn_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
