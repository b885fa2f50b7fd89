"""mamba2-1.3b [ssm]: pure SSD stack (attn-free, no FFN), d_state=128.

[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import MAMBA, ArchConfig, MambaConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    pattern=(MAMBA,),
    mamba=MambaConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    sub_quadratic=True,
))
