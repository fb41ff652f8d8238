"""Seq2seq NMT — the JAX package's ``models/seq2seq.py`` (ChainerMN's
``examples/seq2seq`` encoder-decoder LSTM).

Sequences are padded to one static shape with ``PAD`` and carried by
length masks, as in the JAX package: a pad step leaves an LSTM's ``h``
and ``c`` as they were, so the encoder's final state is the ragged
computation's, and the loss is the mean over real target tokens only.

The same functions on the same parameter tree (``src_embed (Vs, E)``,
``tgt_embed (Vt, E)``, ``encoder``/``decoder`` lists of ``{"w" (d_in,
4H), "u" (H, 4H), "b" (4H,)}``, ``proj {"w" (H, Vt), "b" (Vt,)}``),
with these choices for the card:

- the time loop is plain products, one layer at a time over the whole
  sequence: a layer's input product ``x·w + b`` is one product over
  every timestep, and each step adds ``h·u`` to its row
  (``torch.addmm``), then the gates (``i, f, g, o``; the forget gate
  takes ``+1``, as the JAX cell does).  Layer by layer computes what
  the JAX package's time-major loop over the stack computes: layer
  ``l`` at step ``t`` reads layer ``l-1`` at ``t`` and itself at
  ``t-1``.  ``torch.nn.LSTM`` (cuDNN) has no forget-gate offset and
  zeroes the pad outputs where this carries the state, so it is not
  used;
- the projection, the log-softmax and the loss are fp32;
- :func:`seq2seq_translate` runs ``max_len`` steps and writes ``PAD``
  after a row's ``EOS``; ``torch.argmax`` returns the first maximum, as
  ``jnp.argmax`` does.

Parameters come from :func:`~chainermn_tpu_torch.models.convert.
seq2seq_params_from_jax` or :func:`init_seq2seq` (numpy's seeded
numbers in the JAX layout, on CUDA unless ``device="cpu"`` is named).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from chainermn_tpu_torch._device import resolve_device

__all__ = ["BOS", "EOS", "PAD", "Seq2seqConfig", "init_seq2seq",
           "seq2seq_loss", "seq2seq_translate"]

PAD, BOS, EOS = 0, 1, 2  # reserved token ids (the reference's)


@dataclass(frozen=True)
class Seq2seqConfig:
    src_vocab: int = 8000
    tgt_vocab: int = 8000
    d_embed: int = 256
    d_hidden: int = 256
    n_layers: int = 2
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_seq2seq(cfg: Seq2seqConfig, seed: int = 0, device=None) -> dict:
    """Seeded parameters at ``init_seq2seq``'s scales (numpy's numbers,
    :func:`~chainermn_tpu_torch.models.convert.init_seq2seq_numpy`) as
    fp32 tensors on ``device`` (CUDA unless ``"cpu"`` is named)."""
    from .convert import init_seq2seq_numpy, seq2seq_params_from_jax

    return seq2seq_params_from_jax(init_seq2seq_numpy(cfg, seed), cfg,
                                   device=resolve_device(device))


def _gates(z, c):
    """The JAX ``_lstm_cell`` from its pre-activation ``z`` (``i, f, g,
    o``; the forget gate's ``+1``)."""
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _layer(p, xs, h, c, mask):
    """One LSTM layer over ``xs (T, B, d_in)`` from ``(h, c)``; pad steps
    (``mask[t]`` false) carry the state.  Returns ``(ys (T, B, H), h,
    c)``: ``ys[t]`` is the state after step ``t``, the next layer's
    input."""
    cd = xs.dtype
    T, B, _ = xs.shape
    xw = torch.addmm(p["b"].to(cd), xs.reshape(T * B, -1),
                     p["w"].to(cd)).reshape(T, B, -1)
    u = p["u"].to(cd)
    ys = []
    for t in range(T):
        h2, c2 = _gates(torch.addmm(xw[t], h, u), c)
        m = mask[t]
        h = torch.where(m, h2, h)
        c = torch.where(m, c2, c)
        ys.append(h)
    return torch.stack(ys), h, c


def _run_stack(layers, hs, cs, xs, mask):
    """The JAX ``_run_stack``: ``xs (T, B, E)``, ``mask (T, B, 1)``
    bool; returns ``(top (T, B, H), (hs, cs))``."""
    new_hs, new_cs = [], []
    for p, h, c in zip(layers, hs, cs):
        xs, h, c = _layer(p, xs, h, c, mask)
        new_hs.append(h)
        new_cs.append(c)
    return xs, (new_hs, new_cs)


def _tokens(a, device):
    return torch.as_tensor(a, device=device).long()


def _encode(cfg, params, src):
    """``src (B, Ts)`` padded with PAD → the final ``(hs, cs)``."""
    cd = cfg.compute_dtype
    mask = (src != PAD).T[:, :, None]                       # (Ts, B, 1)
    xs = params["src_embed"][src].to(cd).transpose(0, 1)
    zero = xs.new_zeros((src.shape[0], cfg.d_hidden))
    hs = [zero] * cfg.n_layers
    _, state = _run_stack(params["encoder"], hs, hs, xs, mask)
    return state


def seq2seq_loss(cfg: Seq2seqConfig, params, src, tgt):
    """Masked mean cross-entropy of teacher-forced decoding (the JAX
    ``seq2seq_loss``).  ``src (B, Ts)``, ``tgt (B, Tt)``, PAD-padded;
    ``tgt`` ends each sequence with ``EOS`` and has no ``BOS`` (the
    decoder's input is ``tgt`` shifted right behind ``BOS``, PAD where
    ``tgt`` is PAD).  Token arrays may be numpy; they move to the
    parameters' device."""
    dev = params["proj"]["w"].device
    src, tgt = _tokens(src, dev), _tokens(tgt, dev)
    cd = cfg.compute_dtype
    B = tgt.shape[0]
    hs, cs = _encode(cfg, params, src)
    bos = torch.full((B, 1), BOS, dtype=tgt.dtype, device=dev)
    dec_in = torch.cat([bos, tgt[:, :-1]], dim=1)
    real = tgt != PAD
    dec_in = torch.where(real, dec_in, PAD)
    xs = params["tgt_embed"][dec_in].to(cd).transpose(0, 1)
    top, _ = _run_stack(params["decoder"], hs, cs, xs, real.T[:, :, None])
    logits = top.transpose(0, 1).float() @ params["proj"]["w"] \
        + params["proj"]["b"]
    nll = -torch.log_softmax(logits, dim=-1).gather(
        -1, tgt[..., None]).squeeze(-1)
    mask = real.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@torch.no_grad()
def seq2seq_translate(cfg: Seq2seqConfig, params, src, max_len: int = 32):
    """Greedy decoding (the JAX ``seq2seq_translate``): ``(B, max_len)``
    int32 tokens on the parameters' device, PAD after each row's
    ``EOS``; always ``max_len`` steps."""
    dev = params["proj"]["w"].device
    src = _tokens(src, dev)
    cd = cfg.compute_dtype
    B = src.shape[0]
    hs, cs = _encode(cfg, params, src)
    tok = torch.full((B,), BOS, dtype=torch.long, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    dec = [(p["w"].to(cd), p["u"].to(cd), p["b"].to(cd))
           for p in params["decoder"]]
    outs = []
    for _ in range(max_len):
        x = params["tgt_embed"][tok].to(cd)
        new_hs, new_cs = [], []
        for (w, u, b), h, c in zip(dec, hs, cs):
            h, c = _gates(torch.addmm(torch.addmm(b, x, w), h, u), c)
            new_hs.append(h)
            new_cs.append(c)
            x = h
        hs, cs = new_hs, new_cs
        logits = x.float() @ params["proj"]["w"] + params["proj"]["b"]
        nxt = logits.argmax(-1)
        tok = torch.where(alive, nxt, PAD)    # PAD feeds a finished row
        outs.append(tok)
        alive = alive & (nxt != EOS)
    return torch.stack(outs, dim=1).to(torch.int32)
