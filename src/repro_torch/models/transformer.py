"""Decoder stack assembly: pattern groups of blocks, run group by group.

Copy of ``repro.models.transformer`` in PyTorch for the dense attention
and Mamba-2 stacks.  Parameters and caches are stacked along a leading
group axis, as in the JAX package; where JAX scans over that axis
(``lax.scan``), the port runs a Python loop over groups and hands each
block views of its group's slices.  The ``ATTN`` and ``MAMBA`` layer
kinds with a dense MLP (or none, ``d_ff = 0``) are ported:
sliding-window attention, MoE, parallel blocks and cross attention
raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, MAMBA, ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_specs, norm_specs
from repro_torch.models.param import stack_specs, tree_map


def _check_kind(cfg: ArchConfig, pos: int, kind: str) -> None:
    if kind not in (ATTN, MAMBA):
        raise NotImplementedError(f"layer kind {kind!r} ({cfg.name}) is not "
                                  f"ported yet")
    if cfg.moe is not None and cfg.moe_positions and pos in cfg.moe_positions:
        raise NotImplementedError(f"MoE layers ({cfg.name}) are not ported "
                                  f"yet")
    if cfg.parallel_block:
        raise NotImplementedError(f"parallel blocks ({cfg.name}) are not "
                                  f"ported yet")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def block_specs(cfg: ArchConfig, pos: int, kind: str) -> dict:
    _check_kind(cfg, pos, kind)
    out = {"norm1": norm_specs(cfg)}
    if kind == MAMBA:
        out["mamba"] = mamba_mod.mamba_specs(cfg)
    else:
        out["attn"] = attn_mod.attention_specs(cfg)
    if cfg.d_ff > 0:
        out["norm2"] = norm_specs(cfg)
        out["mlp"] = mlp_specs(cfg)
    return out


def stack_block_specs(cfg: ArchConfig, pattern, n_groups: int) -> dict:
    per_pos = {f"pos{i}": block_specs(cfg, i, kind)
               for i, kind in enumerate(pattern)}
    return stack_specs(per_pos, n_groups)


def cache_specs_for_kind(cfg: ArchConfig, kind: str, batch: int,
                         max_len: int) -> dict:
    _check_kind(cfg, -1, kind)
    if kind == MAMBA:
        return mamba_mod.mamba_cache_specs(cfg, batch)
    return attn_mod.make_kv_cache_specs(cfg, batch, max_len)


def stack_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    per_pos = {f"pos{i}": cache_specs_for_kind(cfg, kind, batch, max_len)
               for i, kind in enumerate(cfg.resolved_pattern)}
    return stack_specs(per_pos, cfg.n_groups)


def group_slice(tree: dict, g: int) -> dict:
    """Group ``g`` of a stacked tree: views, so in-place writes reach the
    stacked tensors."""
    return tree_map(lambda t: t[g], tree)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _ffn(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if "norm2" not in p:
        return x
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))


def apply_block_seq(cfg: ArchConfig, p: dict, kind: str, x: torch.Tensor, *,
                    positions: torch.Tensor):
    """-> (x, payload): the block's output and what its decode cache is
    built from: the rotated ``(k, v)`` of an attention block; the cache
    itself (final SSD state and conv tails) of a Mamba block."""
    h = apply_norm(cfg, p["norm1"], x)
    if kind == MAMBA:
        mix, payload = mamba_mod.apply_mamba(cfg, p["mamba"], h)
    else:
        mix, k, v = attn_mod.self_attention(cfg, p["attn"], h,
                                            positions=positions, causal=True)
        payload = (k, v)
    return _ffn(cfg, p, x + mix), payload


def apply_block_decode(cfg: ArchConfig, p: dict, kind: str, x: torch.Tensor,
                       cache: dict, *, positions: torch.Tensor):
    """x: (B, D) single token; ``cache`` updated in place."""
    h = apply_norm(cfg, p["norm1"], x)
    if kind == MAMBA:
        mix = mamba_mod.decode_mamba(cfg, p["mamba"], h, cache)
    else:
        mix, _ = attn_mod.decode_self_attention(cfg, p["attn"], h, cache,
                                                positions=positions,
                                                lengths=positions + 1)
    return _ffn(cfg, p, x + mix)


# ---------------------------------------------------------------------------
# Stack runners (a loop over groups)
# ---------------------------------------------------------------------------
def run_stack_seq(cfg: ArchConfig, groups: dict, x: torch.Tensor, *,
                  positions: torch.Tensor) -> torch.Tensor:
    pattern = cfg.resolved_pattern
    for g in range(cfg.n_groups):
        gp = group_slice(groups, g)
        for i, kind in enumerate(pattern):
            x, _ = apply_block_seq(cfg, gp[f"pos{i}"], kind, x,
                                   positions=positions)
    return x


def run_stack_prefill(cfg: ArchConfig, groups: dict, x: torch.Tensor, *,
                      positions: torch.Tensor, max_len: int):
    """Like ``run_stack_seq``, and also the decode cache of every block,
    stacked by group as ``stack_cache_specs`` lays it out."""
    pattern = cfg.resolved_pattern
    per_group = []
    for g in range(cfg.n_groups):
        gp = group_slice(groups, g)
        caches = {}
        for i, kind in enumerate(pattern):
            x, payload = apply_block_seq(cfg, gp[f"pos{i}"], kind, x,
                                         positions=positions)
            caches[f"pos{i}"] = (payload if kind == MAMBA else
                                 _prefill_cache(*payload, positions,
                                                max_len))
        per_group.append(caches)
    stacked = {name: {leaf: torch.stack([c[name][leaf] for c in per_group])
                      for leaf in per_group[0][name]}
               for name in per_group[0]}
    return x, stacked


def _prefill_cache(k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, max_len: int) -> dict:
    """The decode cache entry of one full-attention block from its
    prefill K/V: bf16, padded to ``max_len`` with empty (-1) slots, or,
    when the prompt is longer, its last ``max_len`` tokens placed at
    slot ``position % max_len``."""
    b, s = k.shape[:2]
    size = max_len
    pos = torch.broadcast_to(positions.to(torch.int32), (b, s))
    if size >= s:
        pad = size - s
        kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)).to(torch.bfloat16)
        vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).to(torch.bfloat16)
        pos = torch.nn.functional.pad(pos, (0, pad), value=-1)
    else:  # ring: keep the last `size`, placed at slot = pos % size
        last = torch.arange(s - size, s)
        slot_of = torch.zeros(size, dtype=torch.long)
        slot_of[last % size] = last
        slot_of = slot_of.to(k.device)
        kc = k[:, slot_of].to(torch.bfloat16)
        vc = v[:, slot_of].to(torch.bfloat16)
        pos = torch.broadcast_to(slot_of.to(torch.int32), (b, size)).clone()
    return {"k": kc, "v": vc, "pos": pos.contiguous()}


def run_stack_decode(cfg: ArchConfig, groups: dict, x: torch.Tensor,
                     cache: dict, *, positions: torch.Tensor):
    """One decode step through every group; ``cache`` is updated in
    place and returned."""
    pattern = cfg.resolved_pattern
    for g in range(cfg.n_groups):
        gp, gc = group_slice(groups, g), group_slice(cache, g)
        for i, kind in enumerate(pattern):
            x = apply_block_decode(cfg, gp[f"pos{i}"], kind, x,
                                   gc[f"pos{i}"], positions=positions)
    return x, cache
