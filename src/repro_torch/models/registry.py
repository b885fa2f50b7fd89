"""Top-level model API: specs, init, and the forward modes.

Copy of ``repro.models.registry`` in PyTorch.  Batch dicts:
  prefill: {"tokens": (B, S)}
  decode:  tokens (B,), positions (B,) + cache
The dense attention family (phi3; gemma3 with its sliding-window
layers, qk-norm and scaled embedding; stablelm with LayerNorm and
partial rotary; command-r with parallel blocks), the MoE family
(deepseek-moe with shared experts; mixtral with sliding-window layers;
``moe_impl`` picks the dispatch or dense form of ``models/moe.py``) and
the Mamba-2 family (mamba2) run; modality frontends and encoder-decoder
models are not ported yet.
A model with tied embeddings (gemma3, command-r) has no ``unembed``
entry: the logits read the embedding table.
Everything runs where the parameters lie: on the card through the CUDA
attention and SSD kernels, on the CPU through their plain versions.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import param as P
from repro_torch.models import transformer as T
from repro_torch.models.layers import (apply_norm, embed_specs, embed_tokens,
                                       norm_specs, unembed)
from repro_torch.models.param import Spec


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.embed_frontend:
        raise NotImplementedError(f"the {cfg.embed_frontend!r} frontend "
                                  f"({cfg.name}) is not ported yet")
    if cfg.enc_dec:
        raise NotImplementedError(f"encoder-decoder models ({cfg.name}) are "
                                  f"not ported yet")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def model_specs(cfg: ArchConfig) -> dict:
    _check_ported(cfg)
    specs: dict = {
        "embed": embed_specs(cfg),
        "groups": T.stack_block_specs(cfg, cfg.resolved_pattern,
                                      cfg.n_groups),
        "final_norm": norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = {"kernel": Spec((cfg.vocab_size, cfg.d_model),
                                           ("vocab", "embed"))}
    return specs


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    _check_ported(cfg)
    return T.stack_cache_specs(cfg, batch, max_len)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> dict:
    """Seeded parameters (see ``param.init_tree``: the draws follow the
    generator's device)."""
    return P.init_tree(model_specs(cfg), generator, device)


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
    """-> (x (B, S, D), positions (S,))."""
    if "patch_embeds" in batch or "frames" in batch:
        raise NotImplementedError("modality frontends are not ported yet")
    x = embed_tokens(cfg, params["embed"], batch["tokens"])
    return x, torch.arange(x.shape[1], device=x.device)


def lm_hidden(cfg: ArchConfig, params: dict, batch: dict, *,
              moe_impl: str = "dispatch") -> torch.Tensor:
    """Full forward -> final hidden states (B, S, D)."""
    x, positions = _embed_input(cfg, params, batch)
    x = T.run_stack_seq(cfg, params["groups"], x, positions=positions,
                        moe_impl=moe_impl)
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
    x, positions = _embed_input(cfg, params, batch)
    x, cache = T.run_stack_prefill(cfg, params["groups"], x,
                                   positions=positions, max_len=max_len,
                                   moe_impl=moe_impl)
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
                moe_impl: str = "dispatch"):
    """tokens: (B,), positions: (B,) -> (logits (B, V), cache).  The cache
    is updated in place (the JAX package returns a new one)."""
    x = embed_tokens(cfg, params["embed"], tokens)
    x, cache = T.run_stack_decode(cfg, params["groups"], x, cache,
                                  positions=positions, moe_impl=moe_impl)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params, x), cache
