"""Import all architecture configs (populates the registry)."""
from repro_torch.configs import (  # noqa: F401
    command_r_35b,
    deepseek_moe_16b,
    gemma3_12b,
    jamba_1_5_large_398b,
    llava_next_mistral_7b,
    mamba2_1_3b,
    mixtral_8x22b,
    phi3_mini_3_8b,
    stablelm_3b,
    whisper_small,
)
