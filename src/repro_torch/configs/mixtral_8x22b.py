"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ATTN_SWA, ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    pattern=(ATTN_SWA,),
    sliding_window=4096,
    moe_positions=(0,),
    moe=MoEConfig(num_experts=8, top_k=2),
    rope_theta=1_000_000.0,
    sub_quadratic=True,   # SWA bounds the KV working set
    notes="experts are d_ff-TP sharded (8 experts don't divide model=16)",
))
