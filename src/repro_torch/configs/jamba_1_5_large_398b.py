"""jamba-1.5-large-398b [hybrid]: Mamba+attn 1:7 interleave, MoE 16e top-2
on every other layer.  Pattern group of 8: attn at index 4, mamba elsewhere;
MoE FFN at odd indices (matches 398B total / ~94B active).

[arXiv:2403.19887; hf]  Adaptation: mamba layers use the Mamba-2 SSD form
(TPU-idiomatic chunked scan) rather than Mamba-1's sequential selective scan.
"""
from repro_torch.configs.base import ATTN, MAMBA, ArchConfig, MambaConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128,
    pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    moe_positions=(1, 3, 5, 7),
    moe=MoEConfig(num_experts=16, top_k=2),
    mamba=MambaConfig(d_state=128, head_dim=128, expand=2, chunk=256),
    sub_quadratic=True,
))
