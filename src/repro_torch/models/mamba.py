"""Mamba-2 (SSD) mixer block.

Copy of ``repro.models.mamba`` in PyTorch, with the same parameter
leaves, order of operations and dtypes.  Projections are split per
component (z/x/B/C/dt).  The SSD core is ``kernels.ops.ssd_scan``: the
CUDA kernel on the card, its plain version (``ref.ssd_chunked``) on the
CPU.  ``apply_mamba`` also returns the decode cache of the prompt (the
final SSD state of that same scan and the last ``d_conv - 1``
pre-activation projections), where the JAX package runs the scan a
second time to get the state.  Decode is the O(1) recurrent update in
plain PyTorch, as the JAX package computes it outside any kernel; it
updates the cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import pad_dim, shard
from repro_torch.kernels import ops
from repro_torch.models.layers import matmul, rms_norm, silu
from repro_torch.models.param import Spec

F32 = torch.float32
BF16 = torch.bfloat16
G = 1  # B/C groups (single group = multi-value-attention analogue)


def _dims(cfg: ArchConfig):
    m = cfg.mamba
    d_inner = m.d_inner(cfg.d_model)
    n_heads = m.n_heads(cfg.d_model)
    return m, d_inner, n_heads, m.head_dim, m.d_state


def mamba_specs(cfg: ArchConfig) -> dict:
    m, di, h, p_, n = _dims(cfg)
    d = cfg.d_model
    return {
        "wz": Spec((d, di), ("embed", "mamba_inner")),
        "wx": Spec((d, di), ("embed", "mamba_inner")),
        "wB": Spec((d, G, n), ("embed", None, "mamba_state")),
        "wC": Spec((d, G, n), ("embed", None, "mamba_state")),
        "wdt": Spec((d, h), ("embed", "mamba_heads")),
        "conv_x": Spec((m.d_conv, di), (None, "mamba_inner"), BF16, "normal",
                       0.2),
        "conv_B": Spec((m.d_conv, G * n), (None, None), BF16, "normal", 0.2),
        "conv_C": Spec((m.d_conv, G * n), (None, None), BF16, "normal", 0.2),
        "conv_bx": Spec((di,), ("mamba_inner",), F32, "zeros"),
        "conv_bB": Spec((G * n,), (None,), F32, "zeros"),
        "conv_bC": Spec((G * n,), (None,), F32, "zeros"),
        "A_log": Spec((h,), ("mamba_heads",), F32, "constant", 1.386),
        "dt_bias": Spec((h,), ("mamba_heads",), F32, "constant", -4.6),
        "D": Spec((h,), ("mamba_heads",), F32, "ones"),
        "gate_norm": Spec((di,), ("mamba_inner",), F32, "ones"),
        "wo": Spec((di, d), ("mamba_inner", "embed")),
    }


def mamba_cache_specs(cfg: ArchConfig, batch: int) -> dict:
    m, di, h, p_, n = _dims(cfg)
    return {
        "h": Spec((batch, h, p_, n), ("batch", "mamba_heads", None, None),
                  F32, "zeros"),
        "conv_x": Spec((batch, m.d_conv - 1, di),
                       ("batch", None, "mamba_inner"), BF16, "zeros"),
        "conv_B": Spec((batch, m.d_conv - 1, G * n), ("batch", None, None),
                       BF16, "zeros"),
        "conv_C": Spec((batch, m.d_conv - 1, G * n), ("batch", None, None),
                       BF16, "zeros"),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``jnp.logaddexp(x, 0)``: ``max(x, 0) + log1p(exp(-|x|))``)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C); w: (K, C).  The sum of
    shifted products runs in x's dtype, as in the JAX package."""
    k, s = w.shape[0], x.shape[1]
    pad = pad_dim(x, 1, k - 1, 0)
    out = pad[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s, :] * w[i]
    return silu(out + b.to(out.dtype))


def _conv_step(cache: torch.Tensor, xt: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """Single-token conv: cache (B, K-1, C), xt (B, C) -> (out, window):
    the conv output in xt's dtype and the (B, K, C) window whose last
    K - 1 rows are the new cache.  In f32, as in the JAX package."""
    window = torch.cat([cache, xt[:, None, :]], dim=1)
    out = torch.einsum("bkc,kc->bc", window.to(F32), w.to(F32))
    return silu(out + b).to(xt.dtype), window


def _project(cfg: ArchConfig, p: dict, u: torch.Tensor):
    z = matmul(u, p["wz"])
    x = matmul(u, p["wx"])
    Bm = matmul(u, p["wB"].flatten(1)).unflatten(-1, (G, -1))
    Cm = matmul(u, p["wC"].flatten(1)).unflatten(-1, (G, -1))
    dt = matmul(u.to(F32), p["wdt"].to(F32))
    return z, x, Bm, Cm, dt


def _out(cfg: ArchConfig, p: dict, y: torch.Tensor, xh: torch.Tensor,
         z: torch.Tensor, dtype) -> torch.Tensor:
    """D skip, gate, gate norm and output projection of the SSD output
    ``y`` (f32, heads split)."""
    di = xh.shape[-2] * xh.shape[-1]
    y = y + xh.to(F32) * p["D"][:, None]
    y = y.reshape(*y.shape[:-2], di).to(dtype)
    y = y * silu(z)
    y = rms_norm(y, p["gate_norm"])
    return matmul(y, p["wo"])


def apply_mamba(cfg: ArchConfig, p: dict, u: torch.Tensor):
    """Full-sequence SSD.  u: (B, S, D) -> (out (B, S, D), decode cache):
    the cache holds the final SSD state of this scan and the last
    ``d_conv - 1`` pre-activation projections of x, B and C in bf16
    (zero rows in front when S is shorter, the conv's own padding)."""
    m, di, h, pd, n = _dims(cfg)
    b, s, _ = u.shape
    z, x0, B0, C0, dt = _project(cfg, p, u)
    x = _causal_conv(x0, p["conv_x"], p["conv_bx"])
    Bm = _causal_conv(B0.reshape(b, s, G * n), p["conv_B"],
                      p["conv_bB"]).reshape(b, s, G, n)
    Cm = _causal_conv(C0.reshape(b, s, G * n), p["conv_C"],
                      p["conv_bC"]).reshape(b, s, G, n)
    dt = _softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = shard(x.reshape(b, s, h, pd), "batch", "res_seq", "mamba_heads",
               None)
    y, state = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=m.chunk)
    out = _out(cfg, p, y, xh, z, u.dtype)

    k = m.d_conv - 1

    def tail(a: torch.Tensor) -> torch.Tensor:
        a = a.reshape(b, s, -1)[:, -k:]
        if a.shape[1] < k:
            a = pad_dim(a, 1, k - a.shape[1], 0)
        return a.to(BF16)
    cache = {"h": state, "conv_x": tail(x0), "conv_B": tail(B0),
             "conv_C": tail(C0)}
    return out, cache


def decode_mamba(cfg: ArchConfig, p: dict, u: torch.Tensor,
                 cache: dict) -> torch.Tensor:
    """One-token recurrent step.  u: (B, D) -> (B, D); ``cache`` is
    updated in place (the JAX package returns a new one)."""
    m, di, h, pd, n = _dims(cfg)
    b = u.shape[0]
    z, x, Bm, Cm, dt = _project(cfg, p, u)
    x, wx = _conv_step(cache["conv_x"], x, p["conv_x"], p["conv_bx"])
    Bf, wB = _conv_step(cache["conv_B"], Bm.reshape(b, G * n), p["conv_B"],
                        p["conv_bB"])
    Cf, wC = _conv_step(cache["conv_C"], Cm.reshape(b, G * n), p["conv_C"],
                        p["conv_bC"])
    dt = _softplus(dt + p["dt_bias"])                         # (B, H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(A * dt)                                 # (B, H)
    xh = x.reshape(b, h, pd).to(F32)
    # h_new = decay*h + dt * B (x) x    (G=1 group broadcast over heads)
    hb = cache["h"] * decay[..., None, None]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bf.to(F32))
    hn = hb + upd
    y = torch.einsum("bhpn,bn->bhp", hn, Cf.to(F32))
    out = _out(cfg, p, y, xh, z, u.dtype)
    cache["h"].copy_(hn)
    cache["conv_x"].copy_(wx[:, 1:])
    cache["conv_B"].copy_(wB[:, 1:])
    cache["conv_C"].copy_(wC[:, 1:])
    return out
