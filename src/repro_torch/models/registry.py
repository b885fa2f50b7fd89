"""Top-level model API: specs, init, and the forward modes.

Copy of ``repro.models.registry`` in PyTorch.  Batch dicts:
  prefill: {"tokens": (B, S)}                                 (+frontend)
  decode:  tokens (B,), positions (B,) + cache
Frontend stubs, as in the JAX package (a modality frontend provides
precomputed embeddings): a vision-language model (``embed_frontend =
"patch"``, llava) adds {"patch_embeds": (B, S_img, 1024)}, projected and
placed before the token embeddings; an audio encoder-decoder model
(``"frame"``, whisper) adds {"frames": (B, T, 128)}, the encoder's input,
whose output every decoder block reads through cross attention.  Both
inputs are rounded to bf16 before their projection, whatever the model's
dtype, as the JAX package does.
Every architecture family runs: dense attention (phi3; gemma3 with its
sliding-window layers, qk-norm and scaled embedding; stablelm with
LayerNorm and partial rotary; command-r with parallel blocks), MoE
(deepseek-moe with shared experts; mixtral with sliding-window layers;
``moe_impl`` picks the dispatch or dense form of ``models/moe.py``),
Mamba-2 (mamba2), the hybrid Mamba/attention/MoE stack (jamba), the
encoder-decoder (whisper) and the patch frontend (llava).
A model with tied embeddings (gemma3, command-r) has no ``unembed``
entry: the logits read the embedding table.
Everything runs where the parameters lie: on the card through the CUDA
attention and SSD kernels, on the CPU through their plain versions.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ENC_ATTN, ArchConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models import param as P
from repro_torch.models import transformer as T
from repro_torch.models.layers import (apply_norm, embed_specs, embed_tokens,
                                       matmul, norm_specs, unembed)
from repro_torch.models.param import Spec

#: the width of each frontend stub's precomputed embeddings
FRONTEND_DIMS = {"patch": 1024, "frame": 128}
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def model_specs(cfg: ArchConfig) -> dict:
    specs: dict = {"embed": embed_specs(cfg)}
    if cfg.embed_frontend:
        din = FRONTEND_DIMS[cfg.embed_frontend]
        specs["frontend"] = {"proj": Spec((din, cfg.d_model),
                                          (None, "embed"))}
    if cfg.enc_dec:
        specs["enc_groups"] = T.stack_block_specs(
            cfg, (ENC_ATTN,), cfg.num_encoder_layers)
        specs["enc_norm"] = norm_specs(cfg)
    specs["groups"] = T.stack_block_specs(cfg, cfg.resolved_pattern,
                                          cfg.n_groups, cross=cfg.enc_dec)
    specs["final_norm"] = norm_specs(cfg)
    if not cfg.tie_embeddings:
        specs["unembed"] = {"kernel": Spec((cfg.vocab_size, cfg.d_model),
                                           ("vocab", "embed"))}
    return specs


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                enc_len: Optional[int] = None) -> dict:
    """The decode cache, stacked by group; an encoder-decoder model's
    every position adds the encoder's K/V, ``ek``/``ev`` of ``(batch,
    enc_len, KV, hd)`` in bf16."""
    specs = T.stack_cache_specs(cfg, batch, max_len)
    if cfg.enc_dec:
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        enc = Spec((cfg.n_groups, batch, enc_len, kv, hd),
                   ("layer", "batch", "kv_seq", "kv_heads", "head_dim"),
                   BF16, "zeros")
        specs = {name: dict(c, ek=enc, ev=enc) for name, c in specs.items()}
    return specs


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> dict:
    """Seeded parameters (see ``param.init_tree``: the draws follow the
    generator's device)."""
    return P.init_tree(model_specs(cfg), generator, device)


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as ``meta`` tensors (the dry-run's: shapes and
    dtypes, no storage)."""
    return P.abstract_tree(model_specs(cfg))


def param_axes(cfg: ArchConfig) -> dict:
    """The parameter tree's logical axes (a tuple of names per leaf)."""
    return P.axes_tree(model_specs(cfg))


def count_params(cfg: ArchConfig, active: bool = False) -> int:
    """Parameter count of ``model_specs`` (tied embeddings counted once),
    as the JAX package's; ``active=True`` counts those one token reads:
    each routed expert bank (``wi_0``, ``wi_1``, ``wo`` of a ``moe``
    block) as ``n * top_k // num_experts``; the router, the shared
    experts, the ``*_scale`` leaves and every dense parameter whole."""
    if not active or cfg.moe is None:
        return P.count_params_tree(model_specs(cfg))
    total = 0
    for path, s in P.leaves(model_specs(cfg)):
        n = math.prod(s.shape)
        if "moe" in path and "shared" not in path \
                and path[-1] in ("wi_0", "wi_1", "wo"):
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        total += n
    return total


# ---------------------------------------------------------------------------
# Forward modes
# ---------------------------------------------------------------------------
def _embed_input(cfg: ArchConfig, params: dict, batch: dict):
    """-> (x (B, S, D), positions (S,)): the token embeddings, after the
    projected image prefix where the batch has ``patch_embeds``; the
    positions run over the whole sequence."""
    x = embed_tokens(cfg, params["embed"], batch["tokens"])
    if "patch_embeds" in batch:
        pe = matmul(batch["patch_embeds"].to(BF16),
                    params["frontend"]["proj"])
        x = torch.cat([pe, x], dim=1)          # promotes as jnp.concatenate
    return (shard(x, "batch", "res_seq", "embed"),
            torch.arange(x.shape[1], device=x.device))


def _encode(cfg: ArchConfig, params: dict, frames: torch.Tensor, *,
            remat: bool = False):
    """The encoder: ``frames (B, T, 128)`` rounded to bf16, projected,
    through the ``enc_groups`` stack (bidirectional attention, positions
    ``0..T-1``) and ``enc_norm`` -> ``(B, T, D)``."""
    x = matmul(frames.to(BF16), params["frontend"]["proj"])
    x = T.run_stack_seq(cfg, params["enc_groups"], x,
                        positions=torch.arange(x.shape[1], device=x.device),
                        remat=remat, pattern=(ENC_ATTN,))
    return apply_norm(cfg, params["enc_norm"], x)


def _enc_out(cfg: ArchConfig, params: dict, batch: dict):
    return _encode(cfg, params, batch["frames"]) if cfg.enc_dec else None


def lm_hidden(cfg: ArchConfig, params: dict, batch: dict, *,
              moe_impl: str = "dispatch",
              remat: bool = False) -> torch.Tensor:
    """Training/eval forward -> final hidden states (B, S, D).  ``remat``
    recomputes each group's forward in the backward (training); serving
    keeps it off.  The reference defaults to ``remat=True``, which only a
    backward can tell apart."""
    enc_out = (_encode(cfg, params, batch["frames"], remat=remat)
               if cfg.enc_dec else None)
    x, positions = _embed_input(cfg, params, batch)
    x = T.run_stack_seq(cfg, params["groups"], x, positions=positions,
                        moe_impl=moe_impl, remat=remat, enc_out=enc_out)
    return apply_norm(cfg, params["final_norm"], x)


def lm_logits(cfg: ArchConfig, params: dict, batch: dict, *,
              moe_impl: str = "dispatch") -> torch.Tensor:
    return unembed(cfg, params, lm_hidden(cfg, params, batch,
                                          moe_impl=moe_impl))


def prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int, *,
            moe_impl: str = "dispatch",
            lengths: Optional[torch.Tensor] = None):
    """-> (last-position logits (B, V), decode cache, next positions (B,)).

    ``lengths`` (B,) supports right-padded ragged prompts: logits are taken
    at ``lengths-1``; pad K/V slots carry positions >= length so decode
    masks them out.  A Mamba layer's state would absorb the pads, so a
    model with Mamba layers is prefilled at the prompt's exact length
    (the engine's ``_exact_prefill``), as in the JAX package.  In an MoE
    layer the pads are routed like tokens and take expert capacity, as
    in the JAX package.
    """
    enc_out = _enc_out(cfg, params, batch)
    x, positions = _embed_input(cfg, params, batch)
    x, cache = T.run_stack_prefill(cfg, params["groups"], x,
                                   positions=positions, max_len=max_len,
                                   moe_impl=moe_impl, enc_out=enc_out)
    x = apply_norm(cfg, params["final_norm"], x)
    b, s = x.shape[0], x.shape[1]
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
        x_last = x[:, -1, :]
    else:
        lengths = lengths.to(device=x.device, dtype=torch.int32)
        x_last = x[torch.arange(b, device=x.device), (lengths - 1).long()]
    return unembed(cfg, params, x_last), cache, lengths


def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                tokens: torch.Tensor, positions: torch.Tensor, *,
                moe_impl: str = "dispatch",
                enc_lengths: Optional[torch.Tensor] = None):
    """tokens: (B,), positions: (B,) -> (logits (B, V), cache).  The cache
    is updated in place (the JAX package returns a new one).  An
    encoder-decoder model's cross attention reads the first
    ``enc_lengths`` (B,) encoder positions of each row, by default all
    of the cache's."""
    x = embed_tokens(cfg, params["embed"], tokens)
    if cfg.enc_dec and enc_lengths is None:
        enc_lengths = torch.full((tokens.shape[0],),
                                 cache["pos0"]["ek"].shape[2],
                                 dtype=torch.int32, device=x.device)
    x, cache = T.run_stack_decode(cfg, params["groups"], x, cache,
                                  positions=positions, moe_impl=moe_impl,
                                  enc_lengths=enc_lengths)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params, x), cache
