"""Hand-written Hopper kernels with their plain PyTorch versions."""

from .flash_attention import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_attention_supported,
)

__all__ = ["flash_attention", "flash_attention_bwd_reference",
           "flash_attention_reference", "flash_attention_supported"]
