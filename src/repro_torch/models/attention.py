"""Attention: GQA self attention for prefill and decode.

Copy of ``repro.models.attention`` in PyTorch.  The attention itself
goes through ``kernels.ops``: the CUDA kernels for tensors on the card,
their plain versions (the JAX reference oracle's arithmetic) on the
CPU.  Cross attention (encoder-decoder models) is not ported yet.

The decode cache is updated in place: ``decode_self_attention`` writes
the new token's K/V and position into the cache it is given (the JAX
engine donates the cache to its jitted decode instead).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import matmul, rms_norm, rope
from repro_torch.models.param import Spec


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
def attention_specs(cfg: ArchConfig, cross: bool = False) -> dict:
    if cross:
        raise NotImplementedError("cross attention is not ported yet")
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {
        "q": Spec((d, h, hd), ("embed", "heads", "head_dim")),
        "k": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "v": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "o": Spec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.use_bias:
        out["qb"] = Spec((h, hd), ("heads", "head_dim"), torch.float32, "zeros")
        out["kb"] = Spec((kv, hd), ("kv_heads", "head_dim"), torch.float32, "zeros")
        out["vb"] = Spec((kv, hd), ("kv_heads", "head_dim"), torch.float32, "zeros")
        out["ob"] = Spec((d,), ("embed",), torch.float32, "zeros")
    if cfg.qk_norm:
        out["q_norm"] = Spec((hd,), ("head_dim",), torch.float32, "ones")
        out["k_norm"] = Spec((hd,), ("head_dim",), torch.float32, "ones")
    return out


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------
def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,dhk->...hk", x, w)."""
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _proj_qkv(cfg: ArchConfig, p: dict, x: torch.Tensor):
    q, k, v = _heads(x, p["q"]), _heads(x, p["k"]), _heads(x, p["v"])
    if "qb" in p:
        q = q + p["qb"].to(q.dtype)
        k = k + p["kb"].to(k.dtype)
        v = v + p["vb"].to(v.dtype)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _out_proj(p: dict, o: torch.Tensor) -> torch.Tensor:
    h, k, d = p["o"].shape
    y = matmul(o.reshape(*o.shape[:-2], h * k), p["o"].reshape(h * k, d))
    if "ob" in p:
        y = y + p["ob"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Prefill / full-sequence and one-token decode
# ---------------------------------------------------------------------------
def self_attention(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
                   positions: torch.Tensor, causal: bool = True,
                   window: Optional[int] = None):
    """Full-sequence self attention (prefill).  x: (B, S, D) ->
    ``(output, k, v)``: also the rotated K and V, which the prefill turns
    into the decode cache (the JAX package projects them a second time;
    the values are the same)."""
    q, k, v = _proj_qkv(cfg, p, x)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    return _out_proj(p, o), k, v


def make_kv_cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                        window: Optional[int] = None) -> dict:
    """Cache specs for one attention position.  K/V are bf16 whatever the
    model's dtype; SWA layers get a ring buffer."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    size = min(max_len, window) if window else max_len
    return {
        "k": Spec((batch, size, kv, hd), ("batch", "kv_seq", "kv_heads", "head_dim"), torch.bfloat16, "zeros"),
        "v": Spec((batch, size, kv, hd), ("batch", "kv_seq", "kv_heads", "head_dim"), torch.bfloat16, "zeros"),
        # absolute position held by each slot (-1 = empty); ring for SWA
        "pos": Spec((batch, size), ("batch", "kv_seq"), torch.int32, "constant", -1),
    }


def decode_self_attention(cfg: ArchConfig, p: dict, x: torch.Tensor,
                          cache: dict, *, positions: torch.Tensor,
                          lengths: torch.Tensor,
                          window: Optional[int] = None):
    """One-token decode.  x: (B, D); positions: (B,).  Writes the token's
    K/V and position into ``cache`` in place (slot ``position % size``)
    and returns ``(output (B, D), cache)``."""
    b = x.shape[0]
    q, k, v = _proj_qkv(cfg, p, x[:, None, :])          # (B,1,H,hd)
    q = rope(q, positions[:, None], cfg.rope_theta, cfg.rope_fraction)[:, 0]
    k = rope(k, positions[:, None], cfg.rope_theta, cfg.rope_fraction)[:, 0]
    v = v[:, 0]
    size = cache["k"].shape[1]
    slot = (positions % size).long()     # ring for SWA, identity for full
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, slot] = k.to(cache["k"].dtype)
    cache["v"][bidx, slot] = v.to(cache["v"].dtype)
    cache["pos"][bidx, slot] = positions.to(cache["pos"].dtype)
    o = ops.decode_attention(q, cache["k"], cache["v"], lengths=lengths,
                             key_positions=cache["pos"], q_pos=positions,
                             window=window)
    return _out_proj(p, o), cache
