"""whisper-small [audio]: enc-dec; conv frontend is a stub supplying frame
embeddings (B, T, 128).  12 encoder + 12 decoder layers, plain GELU MLP,
LayerNorm, biases.  Adaptation: RoPE replaces learned/sinusoidal positions.

[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ATTN, ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    norm="layernorm", use_bias=True, act="gelu", glu=False,
    enc_dec=True, num_encoder_layers=12,
    embed_frontend="frame",
    sub_quadratic=False,
    notes="shape cells: seq_len = stubbed frame length for encoder shapes; "
          "decode cells use decoder self-KV at seq_len + cross-KV at enc len.",
))
