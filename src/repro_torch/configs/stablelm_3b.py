"""stablelm-3b [dense]: LayerNorm + partial rotary (25%) GQA(kv=H)=MHA.

[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304, head_dim=80,
    norm="layernorm", rope_fraction=0.25,
    sub_quadratic=False,
))
