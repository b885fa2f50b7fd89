"""Abstract inputs for every (arch x shape) cell: ``meta`` tensors.

Copy of ``repro.launch.specs``: tensors on the ``meta`` device stand in
for JAX's ``ShapeDtypeStruct``s, with the reference's shapes and dtypes,
so nothing is allocated.  Frontend stubs follow the reference: [vlm]
and [audio] cells feed precomputed patch or frame embeddings for part of
the sequence.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import registry as R
from repro_torch.models.param import abstract_tree

I32 = torch.int32

# share of a [vlm] prefill sequence carried by image patch embeddings
VLM_IMG_FRACTION = 0.25
# whisper decoder length cap for *training/prefill* cells (its decoder is
# short; the encoder carries the cell's seq_len)
WHISPER_DEC_LEN = 448
# encoder context for whisper decode cells
WHISPER_ENC_LEN = 4096


def sds(shape, dtype) -> torch.Tensor:
    """An empty ``meta`` tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """Abstract batch for train/prefill cells."""
    b, s = cell.global_batch, cell.seq_len
    if cfg.enc_dec:
        out = {"frames": sds((b, s, 128), torch.bfloat16),
               "tokens": sds((b, WHISPER_DEC_LEN), I32)}
        if cell.kind == "train":
            out["targets"] = sds((b, WHISPER_DEC_LEN), I32)
        return out
    if cfg.embed_frontend == "patch":
        s_img = int(s * VLM_IMG_FRACTION)
        out = {"patch_embeds": sds((b, s_img, 1024), torch.bfloat16),
               "tokens": sds((b, s - s_img), I32)}
        if cell.kind == "train":
            out["targets"] = sds((b, s), I32)   # image positions masked (-1)
        return out
    out = {"tokens": sds((b, s), I32)}
    if cell.kind == "train":
        out["targets"] = sds((b, s), I32)
    return out


def decode_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """Abstract (cache, tokens, positions) for decode cells."""
    b, s = cell.global_batch, cell.seq_len
    enc_len = WHISPER_ENC_LEN if cfg.enc_dec else None
    cache = abstract_tree(R.cache_specs(cfg, b, s, enc_len=enc_len))
    return {"cache": cache,
            "tokens": sds((b,), I32),
            "positions": sds((b,), I32)}
