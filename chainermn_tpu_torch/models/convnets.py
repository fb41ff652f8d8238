"""The classic ImageNet convnets — AlexNet, NiN, VGG-16 and GoogLeNet
(the JAX package's ``models/convnets.py``; ChainerMN's
``examples/imagenet/models``, the ``--arch`` choices of
``train_imagenet.py``).

The same functions on the same parameter trees.  ``head="flatten"`` is
the reference's geometry: explicit conv paddings (AlexNet's and NiN's
first conv VALID), ceil-mode max pools (Chainer's ``cover_all=True``)
and the flatten → FC heads (AlexNet 9216 → 4096 at 227 px, VGG 25088 →
4096 at 224 px, GoogLeNet's aux heads 2048 → 1024 at 224 px).
``head="gap"`` is the JAX package's size-robust variant: every conv and
pool ``SAME``, a global-average-pool head.  GoogLeNet carries its two
auxiliary classifiers (after 4a and 4d; ``with_aux=True``).

As :mod:`~chainermn_tpu_torch.models.resnet` does for the card:

- images arrive NHWC; ``x.permute(0, 3, 1, 2)`` is an NCHW tensor in
  ``channels_last`` format, which cuDNN runs with its NHWC kernels; the
  conv weights are OIHW in the same format (HWIO in the JAX tree:
  :func:`~chainermn_tpu_torch.models.convert.convnet_params_from_jax`);
- the conv weights and biases are cast to the compute dtype at each
  call (``F.conv2d`` adds the bias); the dense layers run in fp32
  (``h.float() @ w + b``), ReLU, then back to the compute dtype; the
  logits are fp32;
- XLA's ``SAME`` puts an odd pad's extra row on the high side, which
  ``F.conv2d(padding=)`` and ``F.max_pool2d(padding=)`` (symmetric)
  cannot: such a conv pads explicitly with zeros and such a pool with
  ``-inf``; a ceil-mode pool pads its high edge with ``-inf`` just far
  enough that every input row is covered, as the JAX package does;
- the flatten heads flatten ``(h, w, c)``, the JAX package's NHWC
  order, so the FC weights carry over unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from chainermn_tpu_torch._device import resolve_device

__all__ = ["ConvNetConfig", "convnet_apply", "init_convnet"]

_ARCHS = ("alex", "nin", "vgg16", "googlenet")
_NATIVE_SIZE = {"alex": 227, "nin": 227, "vgg16": 224, "googlenet": 224}


@dataclass(frozen=True)
class ConvNetConfig:
    arch: str = "alex"          # "alex" | "nin" | "vgg16" | "googlenet"
    num_classes: int = 1000
    dtype: str = "bfloat16"
    head: str = "flatten"       # "flatten" (reference geometry) | "gap"
    image_size: Optional[int] = None  # default: the arch's native size

    def __post_init__(self):
        if self.arch not in _ARCHS:
            raise ValueError(f"arch {self.arch!r} not in {_ARCHS}")
        if self.head not in ("flatten", "gap"):
            raise ValueError(f"head {self.head!r} not in (flatten, gap)")

    @property
    def insize(self) -> int:
        return self.image_size or _NATIVE_SIZE[self.arch]

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


# (kind, *spec) rows build each arch, the JAX package's rows:
#   c  kh kw cin cout stride pad — conv + ReLU (pad: int or "SAME")
#   cl kh kw cin cout stride pad — conv, no ReLU (NiN's last 1x1)
#   p  window stride             — max pool (ceil-mode in the reference
#                                  geometry; SAME in the gap variant)
#   g                            — global average pool
#   flat cin                     — flatten (fin from the geometry)
#   f  fin fout                  — dense + ReLU (fin -1: from flatten)
#   fl fin fout                  — dense, no ReLU (logits)
def _rows(cfg: ConvNetConfig) -> Sequence[Tuple]:
    n = cfg.num_classes
    ref = cfg.head == "flatten"

    def pad(p):
        return p if ref else "SAME"

    if cfg.arch == "alex":
        return [
            ("c", 11, 11, 3, 96, 4, pad(0)), ("p", 3, 2),
            ("c", 5, 5, 96, 256, 1, pad(2)), ("p", 3, 2),
            ("c", 3, 3, 256, 384, 1, pad(1)),
            ("c", 3, 3, 384, 384, 1, pad(1)),
            ("c", 3, 3, 384, 256, 1, pad(1)), ("p", 3, 2),
            ("flat", 256) if ref else ("g",),
            ("f", -1 if ref else 256, 4096),
            ("f", 4096, 4096), ("fl", 4096, n),
        ]
    if cfg.arch == "nin":
        return [
            ("c", 11, 11, 3, 96, 4, pad(0)),
            ("c", 1, 1, 96, 96, 1, 0), ("c", 1, 1, 96, 96, 1, 0),
            ("p", 3, 2),
            ("c", 5, 5, 96, 256, 1, pad(2)),
            ("c", 1, 1, 256, 256, 1, 0), ("c", 1, 1, 256, 256, 1, 0),
            ("p", 3, 2),
            ("c", 3, 3, 256, 384, 1, pad(1)),
            ("c", 1, 1, 384, 384, 1, 0), ("c", 1, 1, 384, 384, 1, 0),
            ("p", 3, 2),
            ("c", 3, 3, 384, 1024, 1, pad(1)),
            ("c", 1, 1, 1024, 1024, 1, 0), ("cl", 1, 1, 1024, n, 1, 0),
            ("g",),
        ]
    rows = []
    cin = 3
    for cout, reps in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        for _ in range(reps):
            rows.append(("c", 3, 3, cin, cout, 1, pad(1)))
            cin = cout
        rows.append(("p", 2, 2))
    return rows + [("flat", 512) if ref else ("g",),
                   ("f", -1 if ref else 512, 4096),
                   ("f", 4096, 4096), ("fl", 4096, n)]


def _pool_out(size: int, k: int, stride: int, ceil_mode: bool) -> int:
    if ceil_mode:  # Chainer cover_all=True
        return max(-(-(size - k) // stride) + 1, 0)
    return -(-size // stride)  # SAME


def _conv_out(size: int, k: int, stride: int, pad) -> int:
    if pad == "SAME":
        return -(-size // stride)
    return (size + 2 * pad - k) // stride + 1


def _flatten_fin(cfg: ConvNetConfig) -> Optional[int]:
    """The flatten head's fan-in at ``cfg.insize``, from the geometry."""
    size = cfg.insize
    fin = None
    for row in _rows(cfg):
        kind = row[0]
        if kind in ("c", "cl"):
            size = _conv_out(size, row[1], row[5], row[6])
        elif kind == "p":
            size = _pool_out(size, row[1], row[2], cfg.head == "flatten")
        elif kind == "flat":
            if size <= 0:
                raise ValueError(
                    f"image_size {cfg.insize} collapses to {size}px before "
                    f"the {cfg.arch!r} flatten head — use the arch's native "
                    f"size ({_NATIVE_SIZE[cfg.arch]}) or head='gap'")
            fin = row[1] * size * size
    return fin


# GoogLeNet (Inception v1): (name, cin, b1, b3r, b3, b5r, b5, pool_proj);
# a 3/2 max pool precedes 4a and 5a
_INCEPTION = [
    ("3a", 192, 64, 96, 128, 16, 32, 32),
    ("3b", 256, 128, 128, 192, 32, 96, 64),
    ("4a", 480, 192, 96, 208, 16, 48, 64),
    ("4b", 512, 160, 112, 224, 24, 64, 64),
    ("4c", 512, 128, 128, 256, 24, 64, 64),
    ("4d", 512, 112, 144, 288, 32, 64, 64),
    ("4e", 528, 256, 160, 320, 32, 128, 128),
    ("5a", 832, 256, 160, 320, 32, 128, 128),
    ("5b", 832, 384, 192, 384, 48, 128, 128),
]
_POOL_BEFORE = ("4a", "5a")
_AUX_AFTER = ("4a", "4d")


def init_convnet(cfg: ConvNetConfig, seed: int = 0, device=None):
    """Seeded parameters at ``init_convnet``'s scales (numpy's numbers,
    :func:`~chainermn_tpu_torch.models.convert.init_convnet_numpy`) on
    ``device`` (CUDA unless ``"cpu"`` is named)."""
    from .convert import convnet_params_from_jax, init_convnet_numpy

    return convnet_params_from_jax(init_convnet_numpy(cfg, seed), cfg,
                                   device=resolve_device(device))


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(h, p, stride: int, pad, relu: bool = True):
    w, b = p["w"].to(h.dtype), p["b"].to(h.dtype)
    k = w.shape[2]
    if pad == "SAME":
        lo, hi = _same_pads(h.shape[2], k, stride)
        lo2, hi2 = _same_pads(h.shape[3], k, stride)
        if (lo, lo2) != (hi, hi2):
            h = F.pad(h, (lo2, hi2, lo, hi))
            lo = lo2 = 0
        h = F.conv2d(h, w, b, stride=stride, padding=(lo, lo2))
    else:
        h = F.conv2d(h, w, b, stride=stride, padding=pad)
    return F.relu(h) if relu else h


def _max_pool(h, k: int, stride: int, ceil: bool):
    """A ceil-mode pool (the high edge padded with ``-inf`` so every row
    is covered) or XLA's ``SAME`` pool."""
    if ceil:
        size = h.shape[2]
        extra = max((_pool_out(size, k, stride, True) - 1) * stride + k
                    - size, 0)
        pads = (0, extra, 0, extra)
    else:
        (t, b), (l, r) = (_same_pads(h.shape[2], k, stride),
                          _same_pads(h.shape[3], k, stride))
        pads = (l, r, t, b)
    if any(pads):
        h = F.pad(h, pads, value=float("-inf"))
    return F.max_pool2d(h, k, stride)


def _gap(h):
    """The spatial mean, accumulated in fp32 and rounded to the compute
    dtype, as ``jnp.mean`` of a bf16 array is."""
    return h.float().mean((2, 3)).to(h.dtype)


def _flatten(h):
    """NCHW → ``(B, H·W·C)`` in the JAX package's ``(h, w, c)`` order."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def _dense(h, p, relu: bool, cd):
    h = h.float() @ p["w"] + p["b"]
    return F.relu(h).to(cd) if relu else h


def _googlenet_apply(cfg: ConvNetConfig, params, h, with_aux: bool):
    cd = cfg.compute_dtype
    ceil = cfg.head == "flatten"

    def inception(p, h):
        # a 3x3/1 max pool: ceil mode pads (1, 1) with -inf, and SAME
        # pads the same
        pool = F.max_pool2d(h, 3, 1, padding=1)
        return torch.cat([
            _conv(h, p["b1"], 1, "SAME"),
            _conv(_conv(h, p["b3r"], 1, "SAME"), p["b3"], 1, "SAME"),
            _conv(_conv(h, p["b5r"], 1, "SAME"), p["b5"], 1, "SAME"),
            _conv(pool, p["pp"], 1, "SAME"),
        ], dim=1)

    def aux_head(p, h):
        if ceil:
            # a 5x5/3 VALID average pool (14 → 4), a 1x1 conv, the
            # flatten of 4·4·128 = 2048
            a = F.avg_pool2d(h, 5, 3)
            a = _flatten(_conv(a, p["conv"], 1, "SAME"))
        else:
            a = _gap(_conv(h, p["conv"], 1, "SAME"))
        return _dense(F.relu(_dense(a, p["fc1"], False, cd)), p["fc2"],
                      False, cd)

    h = _conv(h, params["stem"][0], 2, 3)
    h = _max_pool(h, 3, 2, ceil)
    h = _conv(h, params["stem"][1], 1, 0)
    h = _conv(h, params["stem"][2], 1, 1)
    h = _max_pool(h, 3, 2, ceil)
    aux = []
    for row in _INCEPTION:
        name = row[0]
        if name in _POOL_BEFORE:
            h = _max_pool(h, 3, 2, ceil)
        h = inception(params["inc"][name], h)
        if with_aux and name in _AUX_AFTER:
            aux.append(aux_head(params[f"aux_{name}"], h))
    logits = _dense(_gap(h), params["fc"], False, cd)
    return (logits, *aux) if with_aux else logits


def convnet_apply(cfg: ConvNetConfig, params, x, with_aux: bool = False):
    """``(B, H, W, 3)`` images → ``(B, num_classes)`` fp32 logits.

    ``with_aux=True`` (GoogLeNet only) also returns the two auxiliary
    classifiers' logits, ``(logits, aux_4a, aux_4d)``: train with
    ``main + 0.3·(aux_4a + aux_4d)``."""
    h = x.permute(0, 3, 1, 2).to(cfg.compute_dtype)     # channels_last
    if cfg.arch == "googlenet":
        return _googlenet_apply(cfg, params, h, with_aux)
    if with_aux:
        raise ValueError(
            f"with_aux: arch {cfg.arch!r} has no auxiliary classifiers "
            "(googlenet only)")
    cd = cfg.compute_dtype
    for row, p in zip(_rows(cfg), params):
        kind = row[0]
        if kind in ("c", "cl"):
            h = _conv(h, p, row[5], row[6], relu=kind == "c")
        elif kind == "p":
            h = _max_pool(h, row[1], row[2], cfg.head == "flatten")
        elif kind == "g":
            h = _gap(h)
        elif kind == "flat":
            h = _flatten(h)
        else:
            h = _dense(h, p, kind == "f", cd)
    return h.float()
