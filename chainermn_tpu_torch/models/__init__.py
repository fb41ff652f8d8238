"""The flagship transformer (scoring, training, and decoding: greedy,
speculative, prompt lookup and beam search, with int8 weights and an
int8 KV cache as options) and the data-parallel models: ResNet with synchronised BN, and the MNIST MLP."""

from .convert import (
    chain_params_from_jax,
    init_mlp_numpy,
    init_numpy_params,
    init_resnet_numpy,
    init_transformer,
    mlp_params_from_jax,
    params_from_jax,
    params_to_numpy,
    resnet_params_from_jax,
    resnet_to_numpy,
)
from .mlp import MLP, accuracy, mlp_apply, softmax_cross_entropy
from .resnet import ResNet, ResNetConfig, resnet_apply
from .decoding import (
    make_beam_search_fn,
    make_generate_fn,
    make_lookup_generate_fn,
    make_speculative_generate_fn,
)
from .quantization import quantize_params_int8
from .transformer import (
    TransformerConfig,
    apply_rope,
    gather_params,
    lm_loss,
    make_forward_fn,
    make_train_step,
    make_value_and_grad_fn,
    regroup_blocks,
    reshard_train_state,
    shard_params,
    transformer_backbone,
    transformer_forward,
)

__all__ = [
    "MLP",
    "ResNet",
    "ResNetConfig",
    "TransformerConfig",
    "accuracy",
    "chain_params_from_jax",
    "init_mlp_numpy",
    "init_resnet_numpy",
    "mlp_apply",
    "mlp_params_from_jax",
    "resnet_apply",
    "resnet_params_from_jax",
    "resnet_to_numpy",
    "softmax_cross_entropy",
    "apply_rope",
    "gather_params",
    "init_numpy_params",
    "init_transformer",
    "lm_loss",
    "make_beam_search_fn",
    "make_forward_fn",
    "make_generate_fn",
    "make_lookup_generate_fn",
    "make_speculative_generate_fn",
    "make_train_step",
    "make_value_and_grad_fn",
    "params_from_jax",
    "params_to_numpy",
    "quantize_params_int8",
    "regroup_blocks",
    "reshard_train_state",
    "shard_params",
    "transformer_backbone",
    "transformer_forward",
]
