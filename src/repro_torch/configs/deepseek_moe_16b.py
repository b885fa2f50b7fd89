"""deepseek-moe-16b [moe]: fine-grained 64 routed experts top-6 + 2 shared.

[arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    moe_positions=(0,),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  expert_d_ff=1408),
    sub_quadratic=False,
    notes="experts EP-sharded over model (64/16 = 4 experts per chip)",
))
