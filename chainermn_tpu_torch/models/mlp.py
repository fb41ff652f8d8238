"""MLP — the ``examples/mnist`` model (the JAX package's
``models/mlp.py``): a ReLU dense stack over a list of ``{"w" (in, out),
"b" (out,)}`` layers, as a function and as a module."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MLP", "accuracy", "mlp_apply", "softmax_cross_entropy"]


def mlp_apply(params, x):
    h = x.reshape(x.shape[0], -1)
    for layer in params[:-1]:
        h = F.relu(h @ layer["w"] + layer["b"])
    return h @ params[-1]["w"] + params[-1]["b"]


def softmax_cross_entropy(logits, labels):
    """Mean over the batch of ``-log softmax(logits)[label]``."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def accuracy(logits, labels):
    return (logits.argmax(dim=1) == labels).float().mean()


class MLP(nn.Module):
    """:func:`mlp_apply` over a parameter list (``models/convert.py``'s
    ``mlp_params_from_jax`` or ``init_mlp_numpy``) held as parameters;
    ``self.params`` is the list the function takes."""

    def __init__(self, params):
        super().__init__()
        self.layers = nn.ModuleList()
        self.params = []
        for layer in params:
            m = nn.Module()
            m.w, m.b = nn.Parameter(layer["w"]), nn.Parameter(layer["b"])
            self.layers.append(m)
            self.params.append({"w": m.w, "b": m.b})

    def forward(self, x):
        return mlp_apply(self.params, x)
