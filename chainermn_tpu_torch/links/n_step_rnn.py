"""Multi-node stacked RNN — ``create_multi_node_n_step_rnn`` (the JAX
package's ``links/n_step_rnn.py``; ChainerMN's
``chainermn/links/n_step_rnn.py``).

An ``n_layers``-deep LSTM, GRU or tanh RNN whose layers are dealt
contiguously over ``n_stages`` ranks (the early stages take the
remainder), built on the port's per-rank
:class:`~chainermn_tpu_torch.links.MultiNodeChainList`: stage ``s``
runs its layers over the whole sequence on rank ``s`` and sends its
top layer's outputs to rank ``s + 1`` with the differentiable
transfers, whose backward sends the gradients back.

Ragged batches enter as pad + mask, as in the JAX package: a masked
step leaves a layer's ``h`` and ``c`` as they were, and the carried
``h`` is that step's output, so the final states equal the ragged
computation's.  The cells are the JAX package's: LSTM (``i, f, g, o``,
no forget-gate offset, unlike :mod:`~chainermn_tpu_torch.models.
seq2seq`'s), GRU (the reset gate multiplies ``h·u``'s slice, which
has no bias) and tanh.  Each layer's input product runs once over the
sequence; each step adds ``h·u``.

The chain transfers one tensor a message, so the port packs what the
JAX package passes as tuples: the first stage reads ``xs`` and the
mask as one ``(B, T, d_in + 1)`` tensor, each hand-off is ``(ys,
mask)`` as ``(B, T, H + 1)``, and the last stage's ``(ys, hy, cy)``
travel flattened; :meth:`MultiNodeNStepRNN.apply` packs and unpacks
them, so ``chain((xs, mask))`` returns ``(ys, hy, cy)`` as the JAX
``chain.apply(params, (xs, mask))`` does.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .multi_node_chain_list import MultiNodeChainList

__all__ = ["MultiNodeNStepRNN", "create_multi_node_n_step_rnn"]

_CELLS = ("lstm", "gru", "tanh")
_GATES = {"lstm": 4, "gru": 3, "tanh": 1}


def _init_layer(rng, d_in: int, d_hidden: int, cell: str) -> dict:
    """The JAX ``_init_layer``'s shapes and scales, numpy's numbers."""
    n = _GATES[cell] * d_hidden
    return {"b": np.zeros((n,), np.float32),
            "u": rng.standard_normal((d_hidden, n), dtype=np.float32)
            * np.float32(d_hidden ** -0.5),
            "w": rng.standard_normal((d_in, n), dtype=np.float32)
            * np.float32(d_in ** -0.5)}


def _cell_step(cell: str, xw, h, c, u):
    """One step from the input's product ``xw = x·w + b``: ``(h2, c2)``;
    GRU and tanh pass ``c`` through."""
    if cell == "lstm":
        i, f, g, o = torch.addmm(xw, h, u).chunk(4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c2), c2
    if cell == "gru":
        xr, xu, xn = xw.chunk(3, dim=-1)
        hr, hu, hn = (h @ u).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xu + hu)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, c
    return torch.tanh(torch.addmm(xw, h, u)), c


def stage_apply(layers, xs, mask, cell: str):
    """The JAX ``_stage_apply``: this stage's layers over ``xs (B, T,
    d_in)`` with ``mask (B, T)`` (nonzero = real step).  Returns ``(ys
    (B, T, H), hy (L, B, H), cy (L, B, H))``."""
    B, T, _ = xs.shape
    keep = (mask != 0).T[:, :, None]                      # (T, B, 1)
    seq = xs.transpose(0, 1)                             # (T, B, d_in)
    hys, cys = [], []
    for p in layers:
        H = p["u"].shape[0]
        xw = torch.addmm(p["b"], seq.reshape(T * B, -1),
                         p["w"]).reshape(T, B, -1)
        h = c = xs.new_zeros((B, H))
        ys = []
        for t in range(T):
            h2, c2 = _cell_step(cell, xw[t], h, c, p["u"])
            h = torch.where(keep[t], h2, h)
            c = torch.where(keep[t], c2, c)
            ys.append(h)
        seq = torch.stack(ys)
        hys.append(h)
        cys.append(c)
    return seq.transpose(0, 1), torch.stack(hys), torch.stack(cys)


class MultiNodeNStepRNN(MultiNodeChainList):
    """The chain :func:`create_multi_node_n_step_rnn` returns:
    ``apply(params_list, (xs, mask))`` → ``(ys, hy, cy)``, the last
    stage's top-layer outputs ``(B, T, H)`` and its layers' final
    states ``(L_last, B, H)``; every rank receives them with
    ``broadcast_output=True``, zeros off the last stage's rank
    without."""

    def __init__(self, comm, d_hidden: int, last_layers: int,
                 broadcast_output: bool = True):
        super().__init__(comm, broadcast_output=broadcast_output)
        self.d_hidden = int(d_hidden)
        self.last_layers = int(last_layers)

    def apply(self, params_list, x):
        xs, mask = x
        xs = torch.as_tensor(xs, device=self.comm.device)
        mask = torch.as_tensor(mask, device=self.comm.device,
                               dtype=xs.dtype)
        B, T, _ = xs.shape
        H, L = self.d_hidden, self.last_layers
        flat = super().apply(params_list,
                             torch.cat([xs, mask[..., None]], dim=-1))
        n_ys = B * T * H
        ys = flat[:n_ys].reshape(B, T, H)
        hy, cy = flat[n_ys:].reshape(2, L, B, H).unbind(0)
        return ys, hy, cy


def create_multi_node_n_step_rnn(
    n_layers: int,
    d_in: int,
    d_hidden: int,
    n_stages: int,
    *,
    comm,
    cell: str = "lstm",
    broadcast_output: bool = True,
) -> MultiNodeNStepRNN:
    """Split an ``n_layers``-deep stacked RNN over ranks ``0 ..
    n_stages - 1`` of ``comm`` (the JAX function's ``axis_name``).

    The chain's ``init(seed)`` gives each owned stage's list of layers
    (``{"w" (d_in, G·H), "u" (H, G·H), "b" (G·H,)}``, G the cell's gate
    count; numpy's numbers at the JAX scales); load it with
    ``load_params`` (or a JAX ``chain.init`` list through
    :func:`~chainermn_tpu_torch.models.chain_params_from_jax`).  Every
    rank of ``comm`` calls ``chain((xs, mask))``, with ``xs (B, T,
    d_in)`` and ``mask (B, T)`` (ones for a dense batch), and
    back-propagates a loss of its output; ``chain.reduce_grads`` gives
    the JAX package's gradients."""
    if cell not in _CELLS:
        raise ValueError(f"cell must be one of {_CELLS}, got {cell!r}")
    if not 1 <= n_stages <= n_layers:
        raise ValueError(
            f"need 1 <= n_stages ({n_stages}) <= n_layers ({n_layers})")
    base, rem = divmod(n_layers, n_stages)
    sizes = [base + (1 if s < rem else 0) for s in range(n_stages)]

    mn = MultiNodeNStepRNN(comm, d_hidden, sizes[-1],
                           broadcast_output=broadcast_output)
    layer_idx = 0
    for s, size in enumerate(sizes):
        dims = [(d_in if layer_idx + i == 0 else d_hidden)
                for i in range(size)]
        layer_idx += size

        def init_fn(seed, dims=dims) -> List[dict]:
            rng = np.random.default_rng(seed)
            return [_init_layer(rng, di, d_hidden, cell) for di in dims]

        def apply_fn(p, msg, last=s == n_stages - 1):
            ys, hy, cy = stage_apply(p, msg[..., :-1], msg[..., -1], cell)
            if not last:
                return torch.cat([ys, msg[..., -1:]], dim=-1)
            return torch.cat([ys.reshape(-1), hy.reshape(-1),
                              cy.reshape(-1)])

        mn.add_link(init_fn, apply_fn, owner=s,
                    rank_in=None if s == 0 else s - 1,
                    rank_out=None if s == n_stages - 1 else s + 1,
                    name=f"rnn_stage{s}")
    return mn
