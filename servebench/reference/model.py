"""Plain f32 forward pass of the served decoders (Phi-3-mini and
Mistral-7B, both a pre-norm Llama-style stack).

Per layer: ``x += Wo attn(rope(Wq h), rope(Wk h), Wv h)`` with ``h =
rmsnorm(x)`` and causal softmax attention (query head ``i`` reads KV
head ``i // (H / KV)``), then ``x += W2 (silu(W1 h') * W3 h')`` with
``h' = rmsnorm(x)``; then ``rmsnorm`` and the untied unembedding.  RoPE
rotates the two halves of each head (``x1 cos - x2 sin, x2 cos + x1
sin``, frequencies ``theta^(-i / (hd / 2))``).  The sizes, theta and the
norm's epsilon are the configuration file's.

Weights are the ones the benchmark drew, read in the program's layout
(``groups.pos0.attn.q`` of ``(layers, d, H, hd)`` and so on) and
widened to f32 a layer at a time; TF32 is off.  Imports torch alone.

``quant="fp8"`` is the check's control: the same pass with every
product's weight (per output channel) and input (per row) rounded to
float8 e4m3, as an fp8 serving path would compute.
"""
from __future__ import annotations

import torch

F32 = torch.float32
FP8_MAX = 448.0


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


class Linear:
    """``x @ w`` in f32, or with both rounded to fp8 (``quant``)."""

    def __init__(self, quant):
        self.quant = quant

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.to(F32)
        return _fp8(w, dim=0) if self.quant == "fp8" else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant == "fp8":
            x = _fp8(x, dim=-1)
        return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.to(F32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x (S, H, hd), pos (S,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=F32, device=x.device)
                     / half)
    ang = pos.to(F32)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, block: int):
    """Causal attention, q (S, H, hd), k, v (S, KV, hd), query rows in
    blocks of ``block``."""
    s, h, hd = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)     # (H, S, hd)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, s, block):
        b = min(a + block, s)
        qb = q[a:b].transpose(0, 1)                          # (H, n, hd)
        sc = (qb @ k[:, :b].transpose(1, 2)) * hd ** -0.5    # (H, n, b)
        i = torch.arange(a, b, device=q.device)[:, None]
        j = torch.arange(b, device=q.device)[None, :]
        sc = sc.masked_fill(j > i, float("-inf"))
        out[a:b] = (torch.softmax(sc, dim=-1) @ v[:, :b]).transpose(0, 1)
    return out


@torch.no_grad()
def logits(cfg: dict, params: dict, tokens: torch.Tensor, start: int, *,
           quant=None, block: int = 1024) -> torch.Tensor:
    """Logits ``(S - start, vocab)`` at positions ``start..S-1`` of the
    token sequence ``tokens (S,)``."""
    _no_tf32()
    d, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    kv, hd = cfg["num_key_value_heads"], cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    lin = Linear(quant)
    tokens = tokens.long()
    s = tokens.shape[0]
    pos = torch.arange(s, device=tokens.device)
    x = params["embed"]["tokens"][tokens].to(F32)
    groups = params["groups"]["pos0"]
    for layer in range(cfg["num_hidden_layers"]):
        a, m = groups["attn"], groups["mlp"]
        h = rms_norm(x, groups["norm1"]["scale"][layer], eps)
        q = lin(h, lin.weight(a["q"][layer].reshape(d, nh * hd)))
        k = lin(h, lin.weight(a["k"][layer].reshape(d, kv * hd)))
        v = lin(h, lin.weight(a["v"][layer].reshape(d, kv * hd)))
        q = rope(q.view(s, nh, hd), pos, theta)
        k = rope(k.view(s, kv, hd), pos, theta)
        o = attention(q, k, v.view(s, kv, hd), block).reshape(s, nh * hd)
        x = x + lin(o, lin.weight(a["o"][layer].reshape(nh * hd, d)))
        h = rms_norm(x, groups["norm2"]["scale"][layer], eps)
        up = lin(h, lin.weight(m["wi_0"][layer]))
        up = up * torch.sigmoid(up) * lin(h, lin.weight(m["wi_1"][layer]))
        x = x + lin(up, lin.weight(m["wo"][layer]))
    x = rms_norm(x[start:], params["final_norm"]["scale"], eps)
    return lin(x, lin.weight(params["unembed"]["kernel"].t()))


def gaps(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each chosen token's
    logit lies, per position."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, chosen.long()[:, None])[:, 0]
