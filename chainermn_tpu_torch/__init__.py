"""chainermn_tpu_torch — the PyTorch/CUDA port of ``chainermn_tpu`` for
NVIDIA Hopper (H100).

It imports neither JAX nor ``chainermn_tpu``.  The port grows slice by
slice (ROADMAP.md); this package holds the flagship transformer on one
card: scoring through :func:`models.make_forward_fn`, whose attention
runs a hand-written flash-attention forward kernel
(``csrc/flash_fwd.cu``), greedy KV-cache generation through
:func:`models.make_generate_fn`, and training through
:func:`models.make_train_step` with the :mod:`training` optimizers,
whose backward runs the hand-written flash-attention dq and dk/dv
kernels (``csrc/flash_bwd.cu``).  Entry points run on CUDA unless the
caller passes ``device="cpu"`` (see :func:`resolve_device`).
"""

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch import models, ops, parallel, training

__all__ = ["models", "ops", "parallel", "resolve_device", "training"]
