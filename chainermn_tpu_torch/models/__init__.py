"""The flagship transformer's inference path."""

from .convert import init_numpy_params, params_from_jax
from .decoding import make_generate_fn
from .transformer import (
    TransformerConfig,
    apply_rope,
    make_forward_fn,
    transformer_backbone,
    transformer_forward,
)

__all__ = [
    "TransformerConfig",
    "apply_rope",
    "init_numpy_params",
    "make_forward_fn",
    "make_generate_fn",
    "params_from_jax",
    "transformer_backbone",
    "transformer_forward",
]
