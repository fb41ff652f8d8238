"""ResNet-50/101/152 with synchronised BN — the JAX package's
``models/resnet.py`` (ChainerMN's ``examples/imagenet`` model), the
headline benchmark's model.

The same function on the same parameter tree, with these choices for
the card:

- images arrive NHWC, as in the JAX package; ``x.permute(0, 3, 1, 2)``
  of a contiguous NHWC tensor is an NCHW tensor in
  ``torch.channels_last`` memory format, which cuDNN runs with its NHWC
  tensor-core kernels; the conv weights are OIHW in the same format;
- parameters stay fp32 and each call casts the conv weights to the
  compute dtype (the JAX package's ``w.astype(x.dtype)``), with no
  ``torch.autocast``; BN statistics are fp32; the logits are fp32
  (``h.float() @ w + b`` after the global average pool);
- ``padding="SAME"`` is asymmetric where the stride is 2 (pad ``total //
  2`` before and the rest after), which ``F.conv2d(padding=k // 2)``
  does not reproduce: such convolutions and the max-pool pad explicitly
  (the max-pool with ``-inf``); 7x7/2 on 224 pads (2, 3), 3x3/2 on an
  even size (0, 1);
- the last BN's γ of each bottleneck starts at zero (in the
  initialisers of ``models/convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch.links.batch_normalization import (
    BatchNormState,
    multi_node_batch_normalization,
)

__all__ = ["ResNet", "ResNetConfig", "resnet_apply"]

_STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    width: int = 64            # stem channels; stage i has width * 2**i
    dtype: str = "bfloat16"    # compute dtype (params and stats fp32)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def stage_sizes(self) -> Tuple[int, ...]:
        return _STAGES[self.depth]


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"``: ``ceil(size / stride)`` outputs, the padding
    split with the odd element after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    (top, bottom), (left, right) = (
        _same_pads(x.shape[2], w.shape[2], stride),
        _same_pads(x.shape[3], w.shape[3], stride))
    w = w.to(x.dtype)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _max_pool(x, k: int = 3, stride: int = 2):
    (top, bottom), (left, right) = (_same_pads(x.shape[2], k, stride),
                                    _same_pads(x.shape[3], k, stride))
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def _bn(p, s, x, comm, train, relu=True):
    y, new_s = multi_node_batch_normalization(p, s, x, comm, train=train)
    return (F.relu(y) if relu else y), new_s


def _bottleneck(p, s, x, stride, comm, train):
    ns = {}
    h, ns["bn1"] = _bn(p["bn1"], s["bn1"], _conv(x, p["conv1"]), comm, train)
    h, ns["bn2"] = _bn(p["bn2"], s["bn2"], _conv(h, p["conv2"], stride),
                       comm, train)
    h, ns["bn3"] = _bn(p["bn3"], s["bn3"], _conv(h, p["conv3"]), comm, train,
                       relu=False)
    if "proj" in p:
        x, ns["bn_proj"] = _bn(p["bn_proj"], s["bn_proj"],
                               _conv(x, p["proj"], stride), comm, train,
                               relu=False)
    return F.relu(h + x), ns


def resnet_apply(cfg: ResNetConfig, params, state, x, *, train: bool = True,
                 comm=None):
    """Forward pass.

    Args:
      x: ``(B, H, W, 3)`` images, any float dtype (cast to the compute
        dtype).
      comm: the communicator whose ranks the BN statistics are averaged
        over (the JAX package's ``axis_name``); ``None`` is local BN.

    Returns ``(logits_fp32, new_state)``.
    """
    x = x.permute(0, 3, 1, 2).to(cfg.compute_dtype)     # channels_last
    new_state = {}
    h = _conv(x, params["conv1"], stride=2)
    h, new_state["bn1"] = _bn(params["bn1"], state["bn1"], h, comm, train)
    h = _max_pool(h)
    for i, n_blocks in enumerate(cfg.stage_sizes):
        for j in range(n_blocks):
            name = f"stage{i + 1}_block{j + 1}"
            stride = 2 if (j == 0 and i > 0) else 1
            h, new_state[name] = _bottleneck(params[name], state[name], h,
                                             stride, comm, train)
    # global average pool, accumulated in fp32 and rounded to the compute
    # dtype as jnp.mean of a bf16 array is
    h = h.float().mean((2, 3)).to(h.dtype)
    logits = h.float() @ params["fc"]["w"] + params["fc"]["b"]
    return logits, new_state


def _paths(tree, prefix=""):
    """``(path, leaf)`` of a nested dict of tensors / BatchNormStates."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        elif isinstance(v, BatchNormState):
            for f, t in v._asdict().items():
                yield f"{prefix}{k}/{f}", t
        else:
            yield f"{prefix}{k}", v


class ResNet(nn.Module):
    """:func:`resnet_apply` as a module: the parameter tree's leaves are
    its parameters (named by their path, ``stage1_block1/conv1``), the
    BN running statistics its buffers, updated in place while
    ``self.training``.  ``self.params`` and ``self.state`` are the trees
    :func:`resnet_apply` and the updater take."""

    def __init__(self, cfg: ResNetConfig, params, state,
                 comm: Optional[object] = None):
        super().__init__()
        self.cfg, self.comm = cfg, comm
        self.weights = nn.ParameterDict(
            {p: nn.Parameter(t) for p, t in _paths(params)})
        for p, t in _paths(state):
            self.register_buffer(p.replace("/", "__"), t)

        def rebuild(tree, prefix=""):
            out = {}
            for k, v in tree.items():
                path = f"{prefix}{k}"
                if isinstance(v, dict):
                    out[k] = rebuild(v, path + "/")
                elif isinstance(v, BatchNormState):
                    out[k] = BatchNormState(*(
                        getattr(self, f"{path}/{f}".replace("/", "__"))
                        for f in BatchNormState._fields))
                else:
                    out[k] = self.weights[path]
            return out

        self.params, self.state = rebuild(params), rebuild(state)

    def forward(self, x):
        logits, new_state = resnet_apply(self.cfg, self.params, self.state,
                                         x, train=self.training,
                                         comm=self.comm)
        if self.training:
            with torch.no_grad():
                for (_, old), (_, new) in zip(_paths(self.state),
                                              _paths(new_state)):
                    old.copy_(new)
        return logits
