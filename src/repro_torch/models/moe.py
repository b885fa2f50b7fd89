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

Under a mesh (DTensor arguments, ``distributed.sharding.mesh_context``)
the routed experts run on each rank's local tensors (``_sharded_moe``),
as ``layers._sharded_matmul`` runs the products: only gathers,
reductions and slices see a DTensor, so the layout is the same on every
torch release.  Per mesh dim: a batch shard of ``x`` stays (the banks
gathered there, FSDP's just-in-time gather of ``expert_embed``); where
the banks' ``expert`` dim is sharded (expert parallel, the reference's
"experts on model when divisible") each rank runs its slice of the
experts on its rows' assignments to them; where their ``expert_mlp`` dim
is (the reference's "else per-expert d_ff TP") every rank runs every
expert on its slice of ``d_ff``.  Every rank routes its rows over all
the experts, so it computes the same choices, queue slots and drops as
one device does.  Its f32 partial output is summed by one all-reduce
and cast to ``x``'s dtype.  An int8 bank is gathered in int8 and
dequantised after the gather.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (from_local_as, is_dtensor,
                                              mesh_chunk, reduce_partial,
                                              shard, to_local_as)
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
    experts' gated MLPs, one ``torch.bmm`` a product (``p``'s banks: all
    the experts, or a rank's slice of them or of their ``d_ff``)."""
    h = _act(cfg, _bmm(xe, _dq(p, "wi_0"))) * _bmm(xe, _dq(p, "wi_1"))
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
              w: torch.Tensor, e0: int = 0) -> torch.Tensor:
    """The capacity-bounded routed experts of x (b, s, d), in f32; ``p``'s
    banks hold experts ``e0 ..`` (all of them off a mesh), and only the
    assignments to those are computed: the others weigh 0."""
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    el = p["wi_0"].shape[0]
    cap = _capacity(cfg, s)
    slot, keep = _queue_slots(idx, e, cap)
    flat = idx.reshape(b, s * k)
    if el < e:                    # a rank's slice of the experts
        keep = keep & (flat >= e0) & (flat < e0 + el)
        flat = (flat - e0).clamp(0, el - 1)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    # dropped assignments land in a spare slot `cap`, cut off below; no
    # host sync on the mask
    put = torch.where(keep, slot, cap)
    xe = x.new_zeros((el, b, cap + 1, d))
    xe[flat, rows, put] = x.repeat_interleave(k, dim=1)
    y = _expert_ffn(cfg, p, xe[:, :, :cap].reshape(el, b * cap, d))
    y = y.reshape(el, b, cap, d)[flat, rows, put.clamp(max=cap - 1)]
    # the combine weights are rounded to x's dtype, as the reference's
    # `comb.astype(x.dtype)`; a dropped assignment weighs 0
    comb = torch.where(keep, w.reshape(b, s * k), 0.0).to(x.dtype)
    return (y.to(F32) * comb.to(F32)[..., None]).reshape(b, s, k, d).sum(2)


def _dense(cfg: ArchConfig, p: dict, x: torch.Tensor, idx: torch.Tensor,
           w: torch.Tensor, e0: int = 0) -> torch.Tensor:
    """Every expert of ``p``'s banks (experts ``e0 ..``) on every token of
    x (b, s, d), combined in f32."""
    b, s, d = x.shape
    e, el = cfg.moe.num_experts, p["wi_0"].shape[0]
    comb = torch.zeros((b, s, e), dtype=F32, device=x.device)
    comb.scatter_(-1, idx, w)
    if el < e:
        comb = comb[..., e0:e0 + el]
    y = _expert_ffn(cfg, p, x.reshape(1, b * s, d).expand(el, b * s, d))
    y = y.permute(1, 0, 2).reshape(b, s, el, d)
    return (y.to(F32) * comb[..., None]).sum(2)


def _sharded_moe(cfg: ArchConfig, p: dict, x: torch.Tensor,
                 route) -> torch.Tensor:
    """The routed experts of DTensor arguments on each rank's local
    tensors (the module docstring's layout), x (B, S, d) or (B, d) ->
    the f32 output of the same shape, summed over the ranks."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    bank = p["wi_0"]
    mesh = (x if is_dtensor(x) else bank).device_mesh
    x = reduce_partial(x)
    rep = [Replicate()] * mesh.ndim
    xp = list(x.placements) if is_dtensor(x) else rep
    wp = list(bank.placements) if is_dtensor(bank) else rep
    x_pl, out_pl, ep, ff = [], [], [], []
    for d, (a, b) in enumerate(zip(xp, wp)):
        if a.is_shard() and a.dim == 0:          # batch: banks gathered
            x_pl.append(a), out_pl.append(a)
            continue
        x_pl.append(Replicate())
        if b.is_shard() and b.dim in (0, 2):     # experts or their d_ff
            (ep if b.dim == 0 else ff).append(d)
            out_pl.append(Partial())
        else:
            out_pl.append(Replicate())

    def bank_pl(f_dim):
        return [Shard(0) if d in ep else Shard(f_dim) if d in ff
                else Replicate() for d in range(mesh.ndim)]
    lp = {"router": to_local_as(p["router"], mesh, rep, out_pl)}
    for name, f_dim in (("wi_0", 2), ("wi_1", 2), ("wo", 1)):
        # an int8 bank is gathered in int8 and dequantised by `_dq`
        lp[name] = to_local_as(p[name], mesh, bank_pl(f_dim), out_pl)
        if name + "_scale" in p:
            lp[name + "_scale"] = to_local_as(
                p[name + "_scale"], mesh,
                [Shard(0) if d in ep else Replicate()
                 for d in range(mesh.ndim)], out_pl)
    xl = to_local_as(x, mesh, x_pl, out_pl)
    squeezed = xl.ndim == 2
    if squeezed:
        xl = xl[:, None, :]
    idx, w, _ = _router(cfg, lp, xl)
    c, n = mesh_chunk(mesh, ep)
    out = route(cfg, lp, xl, idx, w, c * (cfg.moe.num_experts // n))
    if squeezed:
        out = out[:, 0, :]
    return reduce_partial(from_local_as(out, mesh, out_pl, x.shape))


def apply_moe(cfg: ArchConfig, p: dict, x: torch.Tensor,
              impl: str = "dispatch") -> torch.Tensor:
    """x: (B, S, d) or (B, d). Returns the same shape."""
    if impl not in ("dispatch", "dense"):
        raise ValueError(f"moe impl {impl!r}: expected 'dispatch' or "
                         f"'dense'")
    route = _dense if impl == "dense" else _dispatch
    sharded = is_dtensor(x) or is_dtensor(p["wi_0"])
    squeezed = x.ndim == 2 and not sharded
    if squeezed:
        x = x[:, None, :]
    if sharded:
        out = _sharded_moe(cfg, p, x, route).to(x.dtype)
    else:
        idx, w, _ = _router(cfg, p, x)                   # (b, s, k)
        out = route(cfg, p, x, idx, w).to(x.dtype)
    if cfg.moe.num_shared_experts:
        sp = p["shared"]
        h = _act(cfg, matmul(x, sp["wi_0"])) * matmul(x, sp["wi_1"])
        out = out + matmul(h, sp["wo"])
    out = shard(out, *(("batch", "res_seq", "embed") if out.ndim == 3
                       else ("batch", "embed")))
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
