"""Megatron-style dense layers of ``chainermn_tpu/parallel/tensor.py`` at
model-axis size 1: the column- and row-parallel products are plain
``x @ w`` (the all-reduce after the row product is the identity on one
device).  The products go to ``torch.matmul``, as the JAX package leaves
them to XLA.  Sharding over a model axis comes with the parallel slice.
"""

from __future__ import annotations

__all__ = ["column_parallel_dense", "row_parallel_dense"]


def column_parallel_dense(x, w, b=None):
    """``x (..., d_in) @ w (d_in, d_out)`` (+ ``b``)."""
    y = x @ w
    return y if b is None else y + b


def row_parallel_dense(x, w, b=None):
    """``x (..., d_in) @ w (d_in, d_out)`` (+ ``b``); no collective at
    model-axis size 1."""
    y = x @ w
    return y if b is None else y + b
