"""command-r-35b [dense]: parallel attn/MLP blocks, LayerNorm, no bias,
tied embeddings, 256k vocab.

[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000, head_dim=128,
    norm="layernorm", parallel_block=True, tie_embeddings=True,
    rope_theta=8_000_000.0,
    sub_quadratic=False,
))
