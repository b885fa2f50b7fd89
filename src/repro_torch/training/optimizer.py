"""AdamW over a dict of parameter tensors.

Trimmed copy of ``repro.training.optimizer``: ``OptConfig``,
``init_opt_state``, ``lr_at``, ``global_norm`` and ``adamw_update``, in
the reference's operation order, on the device of the parameters.  It
keeps what the planner uses: both moments in f32, the reference's
default betas and epsilon as constants, and no weight decay.  Updates
carry no gradient (the caller runs them under ``torch.no_grad()``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

F32 = torch.float32

#: the reference ``OptConfig``'s default moment decays and epsilon
B1 = 0.9
B2 = 0.95
EPS = 1e-8


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # cosine | constant (post-warmup shape)


def init_opt_state(params: dict) -> dict:
    m = {k: torch.zeros(p.shape, dtype=F32, device=p.device)
         for k, p in params.items()}
    v = {k: torch.zeros(p.shape, dtype=F32, device=p.device)
         for k, p in params.items()}
    device = next(iter(params.values())).device if params else None
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


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
    """sqrt of the sum of squares of every leaf, summed in sorted key
    order (the order ``jax.tree_util`` flattens a dict in)."""
    total = 0
    for k in sorted(tree):
        total = total + torch.sum(torch.square(tree[k].to(F32)))
    return torch.sqrt(total)


def adamw_update(params: dict, grads: dict, opt_state: dict,
                 cfg: OptConfig) -> tuple:
    """-> (new_params, new_opt_state, metrics)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, step)
    bc1 = 1 - B1 ** step.to(F32)
    bc2 = 1 - B2 ** step.to(F32)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        m, v = opt_state["m"][k], opt_state["v"][k]
        g = grads[k].to(F32) * scale
        m_new = B1 * m + (1 - B1) * g
        v_new = B2 * v + (1 - B2) * torch.square(g)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + EPS)
        p_new = p.to(F32) - lr * delta
        new_p[k] = p_new.to(p.dtype)
        new_m[k] = m_new
        new_v[k] = v_new
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
