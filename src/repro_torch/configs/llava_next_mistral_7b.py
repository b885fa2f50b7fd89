"""llava-next-mistral-7b [vlm]: Mistral-7B backbone + anyres patch-embed stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    rope_theta=1_000_000.0,
    embed_frontend="patch",
    sub_quadratic=False,
    notes="anyres tiling lives in the stubbed frontend; backbone sees "
          "precomputed patch embeddings (B, S_img, 1024).",
))
