"""Mixture-of-Experts FFN.

Copy of ``repro.models.moe`` in PyTorch, with its two interchangeable
implementations of ``apply_moe``:

  * ``dispatch`` (the default of ``registry.prefill`` and
    ``decode_step``): each expert takes at most ``cap = max(1, int(top_k
    * s * capacity_factor / e))`` assignments of a batch row, in
    token-major then top-k order; the assignments past an expert's
    capacity are dropped, the same ones as in the reference.  The JAX
    package forms the dispatch and the combine as one-hot einsums; the
    port scatters and gathers the same values instead (each slot holds
    one token or zeros, so the dispatched tokens are bit-equal) and runs
    each expert product as one ``torch.bmm`` over an ``(e, b * cap, d)``
    layout: a batched ``torch.matmul`` of ``(b, e, cap, d)`` against an
    ``(e, d, f)`` bank would copy the bank once per batch row.
  * ``dense``: every expert on every token, combined in f32 under the
    routing mask; exact, the oracle of the tests.

deepseek-style shared experts are a dense MLP alongside the routed path.
The reference computes its experts with XLA einsums, outside any Pallas
kernel, so the expert products here are cuBLAS calls on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models.layers import _act, matmul
from repro_torch.models.param import Spec
from repro_torch.util import opt_flags

F32 = torch.float32


def moe_specs(cfg: ArchConfig) -> dict:
    """The router (f32), the expert banks (bf16 whatever the model's
    dtype; int8 with per-expert f32 scales under ``REPRO_OPTS=w8_experts``)
    and, where the config has them, the shared experts, one MLP
    ``expert_d_ff * num_shared_experts`` wide."""
    moe = cfg.moe
    d = cfg.d_model
    fe = moe.expert_d_ff or cfg.d_ff
    e = moe.num_experts
    wdt = torch.int8 if "w8_experts" in opt_flags() else torch.bfloat16
    out = {
        "router": Spec((d, e), ("embed", "expert"), torch.float32),
        "wi_0": Spec((e, d, fe), ("expert", "expert_embed", "expert_mlp"),
                     wdt),
        "wi_1": Spec((e, d, fe), ("expert", "expert_embed", "expert_mlp"),
                     wdt),
        "wo": Spec((e, fe, d), ("expert", "expert_mlp", "expert_embed"), wdt),
    }
    if wdt == torch.int8:
        for name in ("wi_0", "wi_1", "wo"):
            out[name + "_scale"] = Spec((e,), ("expert",), torch.float32,
                                        "ones")
    if moe.num_shared_experts:
        fs = fe * moe.num_shared_experts
        out["shared"] = {
            "wi_0": Spec((d, fs), ("embed", "mlp")),
            "wi_1": Spec((d, fs), ("embed", "mlp")),
            "wo": Spec((fs, d), ("mlp", "embed")),
        }
    return out


def _router(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """x: (..., d) -> top-k expert indices (..., k), their f32 weights
    renormalised to sum 1 (..., k), and the f32 probabilities (..., e).
    Equal probabilities rank the lower index first, as ``jax.lax.top_k``
    does (a stable descending sort; ``torch.topk`` orders ties
    arbitrarily, and a tied expert still takes a capacity slot)."""
    logits = torch.matmul(x.to(F32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    w, idx = w[..., :k], idx[..., :k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return idx, w, probs


def _dq(p: dict, name: str) -> torch.Tensor:
    """An expert bank in bf16: int8 banks are dequantised at use, the
    scale multiplied in f32 and rounded to bf16 before the product, as
    the reference does."""
    w = p[name]
    if w.dtype == torch.int8:
        # the int8 bank gathered over its FSDP dim, its d_ff shard kept
        w = shard(w, *((None, "expert_mlp", None) if name == "wo"
                       else (None, None, "expert_mlp")))
        scale = p[name + "_scale"] * (1.0 / 127.0)
        return (w.to(torch.bfloat16)
                * scale.to(torch.bfloat16)[:, None, None])
    return w


def _bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` in the promoted dtype of the two, as ``jnp.einsum``."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.bmm(x.to(dt), w.to(dt))


def _expert_ffn(cfg: ArchConfig, p: dict, xe: torch.Tensor) -> torch.Tensor:
    """xe: (e, n, d) tokens dispatched to each expert -> (e, n, d), the
    experts' gated MLPs, one ``torch.bmm`` a product."""
    h = _act(cfg, _bmm(xe, _dq(p, "wi_0"))) * _bmm(xe, _dq(p, "wi_1"))
    h = shard(h, "expert", None, "expert_mlp")
    return _bmm(h, _dq(p, "wo"))


def _capacity(cfg: ArchConfig, s: int) -> int:
    moe = cfg.moe
    return max(1, int(moe.top_k * s * moe.capacity_factor
                      / moe.num_experts))


def _queue_slots(idx: torch.Tensor, e: int, cap: int):
    """idx: (b, s, k) -> (slot, keep), both (b, s * k): each assignment's
    place in its expert's queue, counted over the batch row's assignments
    token-major and then in top-k order, and whether it is within the
    expert's capacity ``cap``.  Each batch row has queues of its own."""
    b = idx.shape[0]
    flat = idx.reshape(b, -1)
    seen = F.one_hot(flat, e).cumsum(dim=1)             # (b, s * k, e)
    slot = seen.gather(2, flat[..., None])[..., 0] - 1
    return slot, slot < cap


def _dispatch(cfg: ArchConfig, p: dict, x: torch.Tensor, idx: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """The capacity-bounded routed experts of x (b, s, d)."""
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = _capacity(cfg, s)
    slot, keep = _queue_slots(idx, e, cap)
    flat = idx.reshape(b, s * k)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    # dropped assignments land in a spare slot `cap`, cut off below; no
    # host sync on the mask
    put = torch.where(keep, slot, cap)
    xe = x.new_zeros((e, b, cap + 1, d))
    xe[flat, rows, put] = x.repeat_interleave(k, dim=1)
    xe = shard(xe, "expert", "batch", None, None)
    y = _expert_ffn(cfg, p, xe[:, :, :cap].reshape(e, b * cap, d))
    y = y.reshape(e, b, cap, d)[flat, rows, put.clamp(max=cap - 1)]
    # the combine weights are rounded to x's dtype, as the reference's
    # `comb.astype(x.dtype)`; a dropped assignment weighs 0
    comb = torch.where(keep, w.reshape(b, s * k), 0.0).to(x.dtype)
    out = (y.to(F32) * comb.to(F32)[..., None]).reshape(b, s, k, d).sum(2)
    return out.to(x.dtype)


def _dense(cfg: ArchConfig, p: dict, x: torch.Tensor, idx: torch.Tensor,
           w: torch.Tensor) -> torch.Tensor:
    """Every expert on every token of x (b, s, d), combined in f32."""
    b, s, d = x.shape
    e = cfg.moe.num_experts
    comb = torch.zeros((b, s, e), dtype=F32, device=x.device)
    comb.scatter_(-1, idx, w)
    y = _expert_ffn(cfg, p, x.reshape(1, b * s, d).expand(e, b * s, d))
    y = y.permute(1, 0, 2).reshape(b, s, e, d)
    return (y.to(F32) * comb[..., None]).sum(2).to(x.dtype)


def apply_moe(cfg: ArchConfig, p: dict, x: torch.Tensor,
              impl: str = "dispatch") -> torch.Tensor:
    """x: (B, S, d) or (B, d). Returns the same shape."""
    if impl not in ("dispatch", "dense"):
        raise ValueError(f"moe impl {impl!r}: expected 'dispatch' or "
                         f"'dense'")
    squeezed = x.ndim == 2
    if squeezed:
        x = x[:, None, :]
    idx, w, _ = _router(cfg, p, x)                       # (b, s, k)
    route = _dense if impl == "dense" else _dispatch
    out = route(cfg, p, x, idx, w)
    if cfg.moe.num_shared_experts:
        sp = p["shared"]
        h = _act(cfg, matmul(x, sp["wi_0"])) * matmul(x, sp["wi_1"])
        out = out + matmul(h, sp["wo"])
    out = shard(out, "batch", "res_seq", "embed")
    return out[:, 0, :] if squeezed else out


def aux_load_balance_loss(cfg: ArchConfig, probs: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss (for training): ``e * sum(f * P)``,
    f the share of tokens whose first choice is each expert and P the
    mean router probability of each expert."""
    e = cfg.moe.num_experts
    onehot = F.one_hot(idx[..., 0].long(), e).to(F32).reshape(-1, e)
    frac_tokens = onehot.mean(dim=0)
    frac_probs = probs.reshape(-1, e).mean(dim=0)
    return e * torch.sum(frac_tokens * frac_probs)
