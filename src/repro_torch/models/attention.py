"""Attention: GQA self attention for prefill and decode, and the cross
attention of encoder-decoder models.

Copy of ``repro.models.attention`` in PyTorch.  The attention itself
goes through ``kernels.ops``: the CUDA kernels for tensors on the card,
their plain versions (the JAX reference oracle's arithmetic) on the
CPU.  Cross attention reads the encoder's output: over the whole decoder
sequence through ``flash_attention`` without a causal mask, and at
decode through ``decode_attention`` over the cached encoder K/V; it has
no RoPE and no qk-norm.

The decode cache is updated in place: ``decode_self_attention`` writes
the new token's K/V and position into the cache it is given (the JAX
engine donates the cache to its jitted decode instead).  A cache that is
a DTensor sharded along its slots (``kv_seq``) is written on each rank's
local slice, only the slots that slice holds.

Under a mesh (``distributed.sharding.mesh_context``) the layout
constraints sit where the reference's do: q, k and the attention output
over (batch, res_seq, heads), the updated cache over (batch, kv_seq,
kv_heads).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (is_dtensor, mesh_chunk, shard,
                                              to_local_as)
from repro_torch.kernels import ops
from repro_torch.models.layers import matmul, rms_norm, rope
from repro_torch.models.param import Spec


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
def attention_specs(cfg: ArchConfig, cross: bool = False) -> dict:
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
    if cfg.qk_norm and not cross:
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
    q = shard(q, "batch", "res_seq", "heads", "head_dim")
    k = shard(k, "batch", "res_seq", "kv_heads", "head_dim")
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    o = shard(o, "batch", "res_seq", "heads", "head_dim")
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
    _write_slots(cache["k"], slot, k)
    _write_slots(cache["v"], slot, v)
    _write_slots(cache["pos"], slot, positions)
    for name in ("k", "v"):
        cache[name] = shard(cache[name], "batch", "kv_seq", "kv_heads",
                            "head_dim")
    o = ops.decode_attention(q, cache["k"], cache["v"], lengths=lengths,
                             key_positions=cache["pos"], q_pos=positions,
                             window=window)
    return _out_proj(p, o), cache


def _write_slots(buf: torch.Tensor, slot: torch.Tensor,
                 value: torch.Tensor) -> None:
    """``buf[b, slot[b]] = value[b]`` for every row ``b``, in place, in
    ``buf``'s dtype.  A DTensor ``buf`` is written on each rank's local
    tensor: ``value`` and ``slot`` are laid out as ``buf`` is without its
    slot dim, and where ``buf`` is sharded along its slots a rank writes
    only the rows whose slot it holds (the others write back what the
    slot held: no host sync on a mask)."""
    if not is_dtensor(buf):
        bidx = torch.arange(buf.shape[0], device=buf.device)
        buf[bidx, slot] = value.to(buf.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    row_pl, val_pl, sdims = [], [], []
    for d, p in enumerate(buf.placements):
        if p.is_shard() and p.dim == 1:
            sdims.append(d)
        row_pl.append(Shard(0) if p.is_shard() and p.dim == 0
                      else Replicate())
        val_pl.append(Shard(p.dim - 1) if p.is_shard() and p.dim > 1
                      else row_pl[-1])
    loc = buf.to_local()
    val = to_local_as(value, mesh, val_pl).to(loc.dtype)
    sl = to_local_as(slot, mesh, row_pl)
    start = mesh_chunk(mesh, sdims)[0] * loc.shape[1]
    here = (sl >= start) & (sl < start + loc.shape[1])
    ls = torch.clamp(sl - start, 0, loc.shape[1] - 1)
    bidx = torch.arange(loc.shape[0], device=loc.device)
    keep = here.view(-1, *([1] * (val.dim() - 1)))
    loc[bidx, ls] = torch.where(keep, val, loc[bidx, ls])


# ---------------------------------------------------------------------------
# Cross attention (decoder over the encoder's output)
# ---------------------------------------------------------------------------
def _query(p: dict, x: torch.Tensor) -> torch.Tensor:
    q = _heads(x, p["q"])
    if "qb" in p:
        q = q + p["qb"].to(q.dtype)
    return q


def cross_kv(p: dict, enc_out: torch.Tensor):
    """The cross-attention K/V of the encoder's output ``(B, T, D)``:
    each ``(B, T, KV, hd)`` in the promoted dtype of ``enc_out`` and the
    weights, with the biases ``kb``/``vb``; no RoPE."""
    k, v = _heads(enc_out, p["k"]), _heads(enc_out, p["v"])
    if "kb" in p:
        k = k + p["kb"].to(k.dtype)
        v = v + p["vb"].to(v.dtype)
    return k, v


def cross_attention_seq(cfg: ArchConfig, p: dict, x: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor):
    """The decoder sequence ``x (B, S, D)`` over the encoder's output,
    without a mask; ``k, v`` are ``cross_kv(p, enc_out)`` (the JAX
    package projects them here; the port's prefill keeps them for the
    decode cache too).  The flash kernel takes one dtype: where q and K/V
    differ, all three are cast to their promoted dtype."""
    q = _query(p, x)
    dt = torch.promote_types(q.dtype, k.dtype)
    o = ops.flash_attention(q.to(dt), k.to(dt), v.to(dt), causal=False)
    return _out_proj(p, o)


def cross_attention_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
                           ek: torch.Tensor, ev: torch.Tensor,
                           enc_lengths: torch.Tensor):
    """One decoder token ``x (B, D)`` over the cached encoder K/V ``ek,
    ev (B, T, KV, hd)`` (bf16); key ``j`` of row ``b`` counts when ``j <
    enc_lengths[b]`` (no key positions, no query position)."""
    o = ops.decode_attention(_query(p, x), ek, ev, lengths=enc_lengths)
    return _out_proj(p, o)
