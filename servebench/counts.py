"""Operations and bytes of the served work, and the H100's peaks.

Frozen copies: the peaks of ``repro_torch.launch.mesh`` (NVIDIA's data
sheet, SXM part, 700 W, dense bf16), the model-FLOP form of
``repro_torch.launch.roofline`` (``2 N`` a token for the products plus
``4 H hd`` a (query, key) pair for attention), and ``chip_smoke.py``'s
attention bounds (the larger of bytes over the memory rate and
operations over the bf16 rate; each input byte read once, each output
byte written once).  ``N`` counts the parameters of the products a token
passes through (every layer's projections and MLP and the
unembedding), not the embedding table, which is a lookup.

Every count is of useful work: a prompt's own length, not the bucket the
engine pads it to; a decode step's live slots, not the idle ones the
engine also computes.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12        # FLOP/s
HBM_BYTES_PER_S = 3.35e12       # B/s
BF16 = 2                        # bytes


def product_params(cfg: dict) -> int:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    layer = d * (h + 2 * kv) * hd + h * hd * d + 3 * d * f
    return cfg["num_hidden_layers"] * layer + cfg["vocab_size"] * d


def _pairs_causal(n: int) -> int:
    return n * (n + 1) // 2


def prefill_flops(cfg: dict, n: int) -> float:
    """A prompt of ``n`` tokens: the products at every position (the
    logits at the last alone) and causal attention."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    per_token = product_params(cfg) - v * d
    attn = (4.0 * cfg["num_attention_heads"] * cfg["head_dim"]
            * _pairs_causal(n) * cfg["num_hidden_layers"])
    return 2.0 * per_token * n + 2.0 * v * d + attn


def decode_flops(cfg: dict, keys: int) -> float:
    """One decode token attending over ``keys`` cached positions."""
    return (2.0 * product_params(cfg)
            + 4.0 * cfg["num_attention_heads"] * cfg["head_dim"] * keys
            * cfg["num_hidden_layers"])


def bound_s(bytes_moved: float, flops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS_BF16)


def flash_call(cfg: dict, n: int) -> tuple:
    """(bytes, FLOPs) of one layer's causal prefill attention over a
    prompt of ``n`` tokens: q, k, v read and the output written in
    bf16, ``4 hd`` a (query, key) pair and head."""
    h, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    moved = BF16 * n * hd * (2 * h + 2 * kv)
    return moved, 4.0 * hd * h * _pairs_causal(n)


def decode_call(cfg: dict, keys) -> tuple:
    """(bytes, FLOPs) of one layer's decode attention for the live
    slots, ``keys`` the cached positions each attends over: each key and
    value read once, the query read and the output written."""
    h, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    total = sum(keys)
    moved = BF16 * (2 * kv * hd * total + 2 * h * hd * len(keys))
    return moved, 4.0 * hd * h * total
