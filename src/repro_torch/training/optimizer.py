"""AdamW with memory-frugal moment dtypes (bf16 m / fp32 v by default).

Copy of ``repro.training.optimizer`` in PyTorch: ``OptConfig``,
``init_opt_state``, ``lr_at``, ``global_norm`` and ``adamw_update`` over
nested dict trees, walked in the order ``jax.tree_util`` flattens them
(sorted keys at every level, ``param.leaves``), with the reference's
operation order.  The first moment tolerates bf16 (magnitude tracking);
the second needs fp32 (tiny values squared).

``adamw_update`` writes the parameters and both moments in place, leaf
by leaf and slice by slice (``UPDATE_SLICE`` elements at a time), under
``torch.no_grad()``: every step is element-wise, so the slices give the
same bits as whole leaves, and the f32 temporaries stay a few slices
big where phi3-mini-3.8b's stacked MLP leaves hold 805 M values each.
The JAX package returns new trees instead (its jitted step donates the
old ones).  ``abstract_opt_state`` gives the state as ``meta`` tensors
for the dry-run (``launch.dryrun``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.param import leaves, tree_map

F32 = torch.float32

#: elements of one leaf updated at a time (a 256 MB f32 temporary)
UPDATE_SLICE = 1 << 26


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    m_dtype: str = "bfloat16"      # bf16 first moment (ZeRO-friendly)
    v_dtype: str = "float32"
    schedule: str = "cosine"       # cosine | constant (post-warmup shape)


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _zeros_like_tree(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v, dtype) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=dtype, device=tree.device)


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    """Zero moments shaped as ``params`` (``cfg.m_dtype``, ``cfg.v_dtype``)
    and step 0, on the parameters' device."""
    device = next(leaves(params))[1].device
    return {"m": _zeros_like_tree(params, getattr(torch, cfg.m_dtype)),
            "v": _zeros_like_tree(params, getattr(torch, cfg.v_dtype)),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_opt_state(abstract_params: dict, cfg: OptConfig) -> dict:
    """``init_opt_state`` on ``meta`` parameters: the same builder, so the
    dry-run's state is the one training allocates; nothing is allocated."""
    return init_opt_state(abstract_params, cfg)


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    if cfg.schedule != "cosine":
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed leaf after leaf in
    ``jax.tree_util``'s order (sorted keys at every level)."""
    total = 0
    for _, t in leaves(tree):
        total = total + torch.sum(torch.square(t.to(F32)))
    return torch.sqrt(total)


def _local(t):
    """A DTensor's local tensor (a view of its storage); a plain tensor
    itself."""
    return t.to_local() if is_dtensor(t) else t


def _update_slice(p, g, m, v, scale, lr, bc1, bc2, cfg: OptConfig) -> None:
    """One slice of one leaf, in place: the reference's ``upd``."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.to(F32) * scale
    m32 = m.to(F32, copy=True)
    m32.mul_(b1).add_(g * (1 - b1))                 # b1 m + (1 - b1) g
    v32 = v.to(F32, copy=True)
    v32.mul_(b2).add_(g.square_().mul_(1 - b2))     # b2 v + (1 - b2) g^2
    m.copy_(m32)
    v.copy_(v32)
    delta = m32.div_(bc1)                           # mhat
    delta.div_(v32.div_(bc2).sqrt_().add_(cfg.eps))
    p32 = p.to(F32)
    delta.add_(g.copy_(p32).mul_(cfg.weight_decay))
    p.copy_(p32.sub_(delta.mul_(lr)))


def adamw_update(params: dict, grads: dict, opt_state: dict,
                 cfg: OptConfig) -> tuple:
    """-> (params, opt_state, metrics); ``params`` and the moments of
    ``opt_state`` are updated in place (the returned trees are the same
    tensors), the step is a new tensor."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, step)
    bc1 = 1 - cfg.b1 ** step.to(F32)
    bc2 = 1 - cfg.b2 ** step.to(F32)
    # DTensor leaves (a sharded step) update their local shards: the
    # update is element by element, the scalars are replicated
    scale, lr_l, bc1, bc2 = map(_local, (scale, lr, bc1, bc2))
    with torch.no_grad():
        for path, p in leaves(params):
            g = _local(_get(grads, path)).reshape(-1)
            m = _local(_get(opt_state["m"], path)).view(-1)
            v = _local(_get(opt_state["v"], path)).view(-1)
            flat = _local(p).view(-1)
            for i in range(0, flat.numel(), UPDATE_SLICE):
                sl = slice(i, i + UPDATE_SLICE)
                _update_slice(flat[sl], g[sl], m[sl], v[sl], scale, lr_l,
                              bc1, bc2, cfg)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, metrics
