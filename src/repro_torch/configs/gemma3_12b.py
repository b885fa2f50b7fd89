"""gemma3-12b [dense]: 5:1 local(SWA-1024):global pattern, 262k vocab,
head_dim 256, qk-norm, tied embeddings, GeGLU.

[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ATTN, ATTN_SWA, ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    d_ff=15360, vocab_size=262144, head_dim=256,
    pattern=(ATTN_SWA,) * 5 + (ATTN,),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    qk_norm=True, tie_embeddings=True, act="gelu",
    sub_quadratic=True,   # 5/6 layers SWA; global-layer KV shards over model
    notes="long_500k runs: local layers ring-buffer to 1024, global layers "
          "hold full KV sharded over (data, model).",
))
