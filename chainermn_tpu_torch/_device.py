"""The port's device rule: entry points run on CUDA unless the caller
asks for the CPU by name.  A missing card is an error, never a quiet
fall back to the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a usable card
    raises; ``"cpu"`` is honoured only when named explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "chainermn_tpu_torch runs on CUDA and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    return dev
