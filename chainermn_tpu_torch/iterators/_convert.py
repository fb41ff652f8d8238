"""Batch → columns, and the world-size divisibility policy (the JAX
package's ``iterators/prefetch.py:60 default_converter`` and ``:173
apply_batch_policy``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["GlobalBatchConverter", "apply_batch_policy",
           "default_converter", "local_rows"]


def default_converter(batch):
    """Batch → tuple of stacked columns (Chainer's ``concat_examples``).

    - a ``list`` of examples: each example an array or scalar (one
      stacked column) or a tuple/list of fields (one column a field);
    - an ``np.ndarray`` or a tensor: an already-stacked batch (the
      :class:`~chainermn_tpu_torch.iterators.SerialIterator` numpy fast
      path), passed through as one column;
    - a ``tuple`` of arrays or tensors only: already-stacked columns,
      passed through.  Any other tuple is a batch of examples.
    """
    if not len(batch):
        raise ValueError("empty batch")
    stacked = (np.ndarray, torch.Tensor)
    if isinstance(batch, stacked):
        return (batch,)
    if isinstance(batch, tuple) and all(isinstance(c, stacked)
                                        for c in batch):
        return batch
    if isinstance(batch[0], (tuple, list)):
        return tuple(np.stack(col) for col in zip(*batch))
    return (np.stack(batch),)


def apply_batch_policy(arrays, world_size: int, drop_remainder: bool):
    """A batch that is split over ``world_size`` ranks must divide by
    it: drop the remainder rows, or raise.

    The port's :class:`~chainermn_tpu_torch.training.StandardUpdater`
    is fed each rank's own batch, so it splits nothing; a feed that
    holds the global batch on every rank (the JAX package's model,
    where ``--batchsize`` is global) applies this before it takes its
    rank's rows with :func:`local_rows`."""
    n = arrays[0].shape[0]
    if n % world_size:
        if not drop_remainder:
            raise ValueError(f"global batch {n} not divisible by world "
                             f"size {world_size}")
        keep = (n // world_size) * world_size
        if keep == 0:
            raise ValueError(
                f"batch of {n} examples cannot be sharded over "
                f"{world_size} ranks — raise batch_size to at least the "
                "world size")
        arrays = tuple(a[:keep] for a in arrays)
    return arrays


def local_rows(arrays, rank: int, world_size: int):
    """Rank ``rank``'s contiguous share of a global batch that
    :func:`apply_batch_policy` made divisible — the rows the JAX
    package's batch sharding gives device ``rank``."""
    b = arrays[0].shape[0] // world_size
    return tuple(a[rank * b:(rank + 1) * b] for a in arrays)


class GlobalBatchConverter:
    """The global-batch feed's converter: every rank iterates the same
    seeded stream of global batches, and this takes the rank's rows
    (:func:`default_converter`, :func:`apply_batch_policy`, then
    :func:`local_rows`) with the rank and world read from ``comm`` when
    it is called — the JAX package's model, where one stream's batch is
    sharded over the mesh.  So the stream's position is the same on
    every rank and survives a live resize: ``StandardUpdater.rebind_world``
    re-points ``comm``.  The split policy is the updater's
    ``drop_remainder``, handed over when the updater adopts this
    converter."""

    def __init__(self, comm):
        self.comm = comm
        self.drop_remainder = True

    def __call__(self, batch):
        arrays = apply_batch_policy(default_converter(batch), self.comm.size,
                                    self.drop_remainder)
        return local_rows(arrays, self.comm.rank, self.comm.size)
