"""Device resolution for the port's entry points.

Everything runs on the CUDA card unless the caller asks for the CPU.
Asking for CUDA where there is none is an error: the port never carries
on silently on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"`` (the default) or ``"cpu"`` -> a ``torch.device``;
    raises ``RuntimeError`` when CUDA is asked for and absent."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or "
                         f"'cpu')")
    return dev
