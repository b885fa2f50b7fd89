"""Decoder and encoder stack assembly: pattern groups of blocks, run
group by group.

Copy of ``repro.models.transformer`` in PyTorch.  A model is ``embed ->
groups -> final_norm``, where one group is one repetition of a pattern
(``cfg.resolved_pattern`` for the decoder, gemma3: 5 sliding-window + 1
global attention layer; ``(ENC_ATTN,)`` for an encoder).  Parameters
and caches are stacked along a leading group axis, as in the JAX
package; where JAX scans over that axis (``lax.scan``), the port runs a
Python loop over the stacked tree's groups and hands each block views of
its group's slices.  Every layer kind is ported: ``ATTN``, ``ATTN_SWA``
(attention over the last ``cfg.sliding_window`` positions, a ring of
that many cache slots), ``ENC_ATTN`` (bidirectional attention; at decode
it reads its cache as ``ATTN`` does, as in the JAX package) and
``MAMBA``, each with a dense MLP (or none, ``d_ff = 0``) or, at
``cfg.moe_positions``, an MoE FFN (``models/moe.py``; ``moe_impl`` picks
its dispatch or dense form), sequential or parallel (command-r: ``x +
attn(h) + mlp(h)``).  A decoder block of an encoder-decoder model
(``cross=True``) adds cross attention over the encoder's output between
its mixer and its FFN: ``x + xattn(xnorm(x))``.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ATTN, ATTN_SWA, ENC_ATTN, MAMBA, ArchConfig
from repro_torch.distributed.sharding import (group_of, pad_dim, replicated,
                                              shard, stack_groups)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_specs, norm_specs
from repro_torch.models.param import leaves, stack_specs, tree_map
from repro_torch.util import opt_flags


def _check_kind(cfg: ArchConfig, kind: str) -> None:
    if kind not in (ATTN, ATTN_SWA, ENC_ATTN, MAMBA):
        raise ValueError(f"unknown layer kind {kind!r} ({cfg.name})")


def _window(cfg: ArchConfig, kind: str):
    """The attention window of a layer kind: ``cfg.sliding_window`` for
    ``ATTN_SWA``, None (the whole prefix) otherwise."""
    return cfg.sliding_window if kind == ATTN_SWA else None


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def block_specs(cfg: ArchConfig, pos: int, kind: str,
                cross: bool = False) -> dict:
    _check_kind(cfg, kind)
    out = {"norm1": norm_specs(cfg)}
    if kind == MAMBA:
        out["mamba"] = mamba_mod.mamba_specs(cfg)
    else:
        out["attn"] = attn_mod.attention_specs(cfg)
    if cross:
        out["xnorm"] = norm_specs(cfg)
        out["xattn"] = attn_mod.attention_specs(cfg, cross=True)
    is_moe = (cfg.moe is not None and cfg.moe_positions
              and pos in cfg.moe_positions)
    if cfg.d_ff > 0 or is_moe:
        if not cfg.parallel_block:
            out["norm2"] = norm_specs(cfg)
        if is_moe:
            out["moe"] = moe_mod.moe_specs(cfg)
        else:
            out["mlp"] = mlp_specs(cfg)
    return out


def stack_block_specs(cfg: ArchConfig, pattern, n_groups: int,
                      cross: bool = False) -> dict:
    per_pos = {f"pos{i}": block_specs(cfg, i, kind, cross=cross)
               for i, kind in enumerate(pattern)}
    return stack_specs(per_pos, n_groups)


def cache_specs_for_kind(cfg: ArchConfig, kind: str, batch: int,
                         max_len: int) -> dict:
    _check_kind(cfg, kind)
    if kind == MAMBA:
        return mamba_mod.mamba_cache_specs(cfg, batch)
    return attn_mod.make_kv_cache_specs(cfg, batch, max_len,
                                        window=_window(cfg, kind))


def stack_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    per_pos = {f"pos{i}": cache_specs_for_kind(cfg, kind, batch, max_len)
               for i, kind in enumerate(cfg.resolved_pattern)}
    return stack_specs(per_pos, cfg.n_groups)


def group_slice(tree: dict, g: int) -> dict:
    """Group ``g`` of a stacked tree: views, so in-place writes reach the
    stacked tensors."""
    return tree_map(lambda t: group_of(t, g), tree)


def n_groups(tree: dict) -> int:
    """The groups of a stacked tree: its leaves' leading axis (the
    encoder's ``num_encoder_layers``, the decoder's ``cfg.n_groups``)."""
    return next(leaves(tree))[1].shape[0]


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _ffn(cfg: ArchConfig, p: dict, x: torch.Tensor,
         moe_impl: str) -> torch.Tensor:
    if "moe" in p:
        return moe_mod.apply_moe(cfg, p["moe"], x, impl=moe_impl)
    return apply_mlp(cfg, p["mlp"], x)


def _residual(cfg: ArchConfig, p: dict, x: torch.Tensor, h: torch.Tensor,
              mix: torch.Tensor, moe_impl: str, cross=None) -> torch.Tensor:
    """The block's output from its input ``x``, the ``norm1`` output ``h``
    and the mixer's output ``mix``: ``x + mix + ffn(h)`` for a parallel
    block (which, as in the JAX package, has no cross attention);
    otherwise ``x + mix``, then ``+ cross(xnorm(.))`` where the block
    has cross attention (``cross`` maps the normed stream to its
    output), then ``+ ffn(norm2(.))`` where the block has an FFN (its MLP
    or its MoE)."""
    has_ffn = "mlp" in p or "moe" in p
    if cfg.parallel_block:
        return x + mix + _ffn(cfg, p, h, moe_impl) if has_ffn else x + mix
    x = x + mix
    if cross is not None:
        x = x + cross(apply_norm(cfg, p["xnorm"], x))
    if not has_ffn:
        return x
    return x + _ffn(cfg, p, apply_norm(cfg, p["norm2"], x), moe_impl)


def apply_block_seq(cfg: ArchConfig, p: dict, kind: str, x: torch.Tensor, *,
                    positions: torch.Tensor, moe_impl: str = "dispatch",
                    enc_out=None):
    """-> (x, payload): the block's output and what its decode cache is
    built from: the rotated ``(k, v)`` of an attention block; the cache
    itself (final SSD state and conv tails) of a Mamba block.  A cross
    block adds ``ek``/``ev``, the ``cross_kv`` of ``enc_out`` rounded to
    bf16 for the cache (the attention here reads them unrounded): ``(k,
    v, ek, ev)``, or the Mamba cache with those two entries."""
    h = apply_norm(cfg, p["norm1"], x)
    if kind == MAMBA:
        mix, payload = mamba_mod.apply_mamba(cfg, p["mamba"], h)
    else:
        mix, k, v = attn_mod.self_attention(cfg, p["attn"], h,
                                            positions=positions,
                                            causal=kind != ENC_ATTN,
                                            window=_window(cfg, kind))
        payload = (k, v)
    cross = None
    if "xattn" in p:
        xkv = attn_mod.cross_kv(p["xattn"], enc_out)

        def cross(hx):
            return attn_mod.cross_attention_seq(cfg, p["xattn"], hx, *xkv)
        ek, ev = (t.to(torch.bfloat16) for t in xkv)
        payload = (dict(payload, ek=ek, ev=ev) if kind == MAMBA
                   else payload + (ek, ev))
    x = _residual(cfg, p, x, h, mix, moe_impl, cross)
    return shard(x, "batch", "res_seq", "embed"), payload


def apply_block_decode(cfg: ArchConfig, p: dict, kind: str, x: torch.Tensor,
                       cache: dict, *, positions: torch.Tensor,
                       moe_impl: str = "dispatch", enc_lengths=None):
    """x: (B, D) single token; ``cache`` updated in place (a cross
    block's ``ek``/``ev`` are read, never written)."""
    h = apply_norm(cfg, p["norm1"], x)
    if kind == MAMBA:
        mix = mamba_mod.decode_mamba(cfg, p["mamba"], h, cache)
    else:
        mix, _ = attn_mod.decode_self_attention(cfg, p["attn"], h, cache,
                                                positions=positions,
                                                lengths=positions + 1,
                                                window=_window(cfg, kind))
    cross = None
    if "xattn" in p:
        def cross(hx):
            return attn_mod.cross_attention_decode(
                cfg, p["xattn"], hx, cache["ek"], cache["ev"], enc_lengths)
    return _residual(cfg, p, x, h, mix, moe_impl, cross)


# ---------------------------------------------------------------------------
# Stack runners (a loop over groups)
# ---------------------------------------------------------------------------
#: ``REPRO_OPTS=remat_dots``: the group checkpoint keeps the outputs of
#: products with no batch dimension and recomputes the rest, the
#: counterpart of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.
#: The projections (``layers.matmul``: ``torch.matmul`` of a ``[..., d]``
#: activation by a 2-D weight) fold the leading dims into one and reach
#: ``aten.mm`` (``aten.addmm`` where a bias add is fused); batched
#: products, ``aten.bmm`` (the attention einsums, the MoE experts), are
#: recomputed, as the reference recomputes its batched dots
_REMAT_DOTS_CONTEXT = functools.partial(
    torch.utils.checkpoint.create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def run_stack_seq(cfg: ArchConfig, groups: dict, x: torch.Tensor, *,
                  positions: torch.Tensor, moe_impl: str = "dispatch",
                  remat: bool = False, pattern=None,
                  enc_out=None) -> torch.Tensor:
    """Every group of the stacked tree ``groups`` over ``x``, each a
    repetition of ``pattern`` (default ``cfg.resolved_pattern``); cross
    blocks read ``enc_out``.  ``remat`` runs each group under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
    scan body): the backward recomputes the group's forward instead of
    keeping its activations, all of it, or all but the unbatched
    products' outputs under ``REPRO_OPTS=remat_dots``.  The groups are
    ``unbind`` views of the stacked leaves, so a backward gathers each leaf's gradient with one
    ``stack`` (an indexed view would add a stack-sized zero tensor a
    group)."""
    pattern = pattern or cfg.resolved_pattern
    per_group = tree_map(lambda t: t.unbind(0), groups)

    def group_fn(h, g):
        gp = tree_map(lambda u: u[g], per_group)
        for i, kind in enumerate(pattern):
            h, _ = apply_block_seq(cfg, gp[f"pos{i}"], kind, h,
                                   positions=positions, moe_impl=moe_impl,
                                   enc_out=enc_out)
        return h

    context_fn = _REMAT_DOTS_CONTEXT if "remat_dots" in opt_flags() \
        else torch.utils.checkpoint.noop_context_fn
    for g in range(n_groups(groups)):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                group_fn, x, g, use_reentrant=False,
                preserve_rng_state=False,          # no random op inside
                context_fn=context_fn)
        else:
            x = group_fn(x, g)
    return x


def run_stack_prefill(cfg: ArchConfig, groups: dict, x: torch.Tensor, *,
                      positions: torch.Tensor, max_len: int,
                      moe_impl: str = "dispatch", pattern=None,
                      enc_out=None):
    """Like ``run_stack_seq``, and also the decode cache of every block,
    stacked by group as ``stack_cache_specs`` lays it out (a cross
    block's entry with its ``ek``/``ev``)."""
    pattern = pattern or cfg.resolved_pattern
    per_group = []
    for g in range(n_groups(groups)):
        gp = group_slice(groups, g)
        caches = {}
        for i, kind in enumerate(pattern):
            x, payload = apply_block_seq(cfg, gp[f"pos{i}"], kind, x,
                                         positions=positions,
                                         moe_impl=moe_impl, enc_out=enc_out)
            if kind == MAMBA:
                entry = payload
            else:
                entry = _prefill_cache(*payload[:2], positions, max_len,
                                       _window(cfg, kind))
                if len(payload) == 4:
                    entry["ek"], entry["ev"] = payload[2:]
            caches[f"pos{i}"] = entry
        per_group.append(caches)
    stacked = {name: {leaf: stack_groups([c[name][leaf] for c in per_group])
                      for leaf in per_group[0][name]}
               for name in per_group[0]}
    return x, stacked


def _prefill_cache(k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, max_len: int,
                   window=None) -> dict:
    """The decode cache entry of one attention block from its prefill
    K/V, ``size = min(max_len, window)`` slots (``max_len`` without a
    window), as ``make_kv_cache_specs`` sizes it: bf16, padded to
    ``size`` with empty (-1) slots, or, when the prompt is longer (a
    sliding-window layer's ring), its last ``size`` tokens placed at
    slot ``position % size``."""
    b, s = k.shape[:2]
    size = min(max_len, window) if window else max_len
    pos = torch.broadcast_to(positions.to(torch.int32), (b, s))
    if size >= s:
        pad = size - s
        kc = pad_dim(k, 1, 0, pad).to(torch.bfloat16)
        vc = pad_dim(v, 1, 0, pad).to(torch.bfloat16)
        pos = pad_dim(pos, 1, 0, pad, value=-1)
    else:  # ring: keep the last `size`, placed at slot = pos % size
        last = torch.arange(s - size, s)
        slot_of = torch.zeros(size, dtype=torch.long)
        slot_of[last % size] = last
        slot_of = slot_of.to(k.device)
        kc = k[:, slot_of].to(torch.bfloat16)
        vc = v[:, slot_of].to(torch.bfloat16)
        pos = torch.broadcast_to(slot_of.to(torch.int32), (b, size)).clone()
    kc = shard(kc, "batch", "kv_seq", "kv_heads", "head_dim")
    vc = shard(vc, "batch", "kv_seq", "kv_heads", "head_dim")
    pos = shard(replicated(pos.contiguous(), kc), "batch", "kv_seq")
    return {"k": kc, "v": vc, "pos": pos}


def run_stack_decode(cfg: ArchConfig, groups: dict, x: torch.Tensor,
                     cache: dict, *, positions: torch.Tensor,
                     moe_impl: str = "dispatch", pattern=None,
                     enc_lengths=None):
    """One decode step through every group; ``cache`` is updated in
    place and returned."""
    pattern = pattern or cfg.resolved_pattern
    for g in range(n_groups(groups)):
        gp, gc = group_slice(groups, g), group_slice(cache, g)
        for i, kind in enumerate(pattern):
            x = apply_block_decode(cfg, gp[f"pos{i}"], kind, x,
                                   gc[f"pos{i}"], positions=positions,
                                   moe_impl=moe_impl,
                                   enc_lengths=enc_lengths)
    return x, cache
