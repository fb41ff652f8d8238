"""The flagship transformer: scoring, generation and training."""

from .convert import init_numpy_params, params_from_jax, params_to_numpy
from .decoding import make_generate_fn
from .transformer import (
    TransformerConfig,
    apply_rope,
    lm_loss,
    make_forward_fn,
    make_train_step,
    make_value_and_grad_fn,
    transformer_backbone,
    transformer_forward,
)

__all__ = [
    "TransformerConfig",
    "apply_rope",
    "init_numpy_params",
    "lm_loss",
    "make_forward_fn",
    "make_generate_fn",
    "make_train_step",
    "make_value_and_grad_fn",
    "params_from_jax",
    "params_to_numpy",
    "transformer_backbone",
    "transformer_forward",
]
