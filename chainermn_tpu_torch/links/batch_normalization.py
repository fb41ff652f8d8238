"""Synchronised (cross-rank) batch normalisation — the JAX package's
``links/batch_normalization.py`` (ChainerMN's
``MultiNodeBatchNormalization``).

The batch statistics are the mean over the ranks of each rank's
moments, through the differentiable
:func:`~chainermn_tpu_torch.ops.collectives.pmean`; its backward
carries every rank's cotangents, so the gradient is that of the
normalisation over the global batch.  The arithmetic is the JAX
package's, which ``torch.nn.SyncBatchNorm`` and ``F.batch_norm`` do
not share (their variance formula, momentum and running-variance
conventions differ):

- statistics in fp32, ``var = E[x²] − E[x]²`` from the averaged
  moments, ``y = x·inv + (β − mean·inv)`` with ``inv = γ/√(var + eps)``,
  cast back to ``x.dtype``;
- running statistics ``r ← decay·r + (1 − decay)·s``, the variance
  unbiased with ``m = local rows × world size``; ``n`` counts calls.

Activations are channels-first here (``(batch, channels, ...)``, the
NCHW of the port's convolutions); the JAX package's are channels-last.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from chainermn_tpu_torch.ops.collectives import pmean

__all__ = [
    "BatchNormState",
    "MultiNodeBatchNormalization",
    "init_batch_norm",
    "multi_node_batch_normalization",
]


class BatchNormState(NamedTuple):
    """Running statistics and the count of updates."""

    mean: torch.Tensor
    var: torch.Tensor
    n: torch.Tensor


def init_batch_norm(size: int, dtype=torch.float32, device=None):
    """``(params, state)`` of a ``size``-channel layer: γ one, β zero,
    running mean zero, running variance one, ``n`` zero."""
    params = {"gamma": torch.ones(size, dtype=dtype, device=device),
              "beta": torch.zeros(size, dtype=dtype, device=device)}
    state = BatchNormState(torch.zeros(size, dtype=dtype, device=device),
                           torch.ones(size, dtype=dtype, device=device),
                           torch.zeros((), dtype=torch.int32, device=device))
    return params, state


def multi_node_batch_normalization(params, state: BatchNormState, x,
                                   comm=None, *, eps: float = 2e-5,
                                   decay: float = 0.9, train: bool = True):
    """Normalise ``x`` (``(batch, channels, ...)``) over every dim but
    the channels, with statistics averaged over ``comm``'s ranks
    (``None``: this rank's batch only).  Returns ``(y, new_state)``;
    ``new_state is state`` when ``train`` is False, which uses the
    running statistics and no collective."""
    gamma, beta = params["gamma"], params["beta"]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    x32 = x.float()
    if not train:
        inv = torch.rsqrt(state.var + eps) * gamma
        y = x32 * inv.view(shape) + (beta - state.mean * inv).view(shape)
        return y.to(x.dtype), state

    dims = (0,) + tuple(range(2, x.dim()))
    mean = x32.mean(dims)
    sq_mean = x32.square().mean(dims)
    if comm is not None:
        # one all-reduce for both moments (every rank holds the same
        # local batch size, so the mean of means is the global mean)
        mean, sq_mean = pmean(torch.stack([mean, sq_mean]), comm).unbind(0)
    var = sq_mean - mean.square()
    inv = torch.rsqrt(var + eps) * gamma
    y = (x32 * inv.view(shape) + (beta - mean * inv).view(shape)).to(x.dtype)

    m = x.numel() // x.shape[1] * (comm.size if comm is not None else 1)
    adjust = m / max(m - 1.0, 1.0)
    with torch.no_grad():
        new_state = BatchNormState(
            decay * state.mean + (1.0 - decay) * mean,
            decay * state.var + (1.0 - decay) * var * adjust,
            state.n + 1)
    return y, new_state


class MultiNodeBatchNormalization(nn.Module):
    """The layer form: γ and β as parameters, the running statistics as
    buffers updated in place while ``self.training``."""

    def __init__(self, size: int, comm=None, eps: float = 2e-5,
                 decay: float = 0.9, device=None):
        super().__init__()
        params, state = init_batch_norm(size, device=device)
        self.gamma = nn.Parameter(params["gamma"])
        self.beta = nn.Parameter(params["beta"])
        for name, t in state._asdict().items():
            self.register_buffer(f"avg_{name}", t)
        self.comm, self.eps, self.decay = comm, eps, decay

    def forward(self, x):
        state = BatchNormState(self.avg_mean, self.avg_var, self.avg_n)
        y, new = multi_node_batch_normalization(
            {"gamma": self.gamma, "beta": self.beta}, state, x, self.comm,
            eps=self.eps, decay=self.decay, train=self.training)
        if self.training:
            with torch.no_grad():
                for old, t in zip(state, new):
                    old.copy_(t)
        return y

