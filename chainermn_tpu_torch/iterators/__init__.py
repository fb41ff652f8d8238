"""Batch iterators and the multi-node wrappers (the JAX package's
``iterators/__init__.py``; ChainerMN's ``create_multi_node_iterator``
and ``create_synchronized_iterator``).

:class:`SerialIterator` draws its shuffles from numpy's ``RandomState``
exactly as the JAX package's does, so the same dataset, batch size and
seed give the same batches in the same order.  The multi-node wrappers
work over ranks (``comm.size``, ``comm.rank``) where the JAX package's
work over processes: a port process is one rank.

In the port each rank iterates its own shard (``scatter_dataset``), so
its batch size is the *local* batch: the JAX package's global
``batch_size`` divided by ``comm.size``.  The global-batch feed is the
JAX package's model instead: every rank iterates the same stream of
global batches and :class:`GlobalBatchConverter` takes its rows, so
the stream's position survives a live resize.

The prefetching feed (:class:`PrefetchIterator`,
:class:`StagingConverter`) is in :mod:`.prefetch`; the C++ batch loader
in :mod:`chainermn_tpu_torch.native`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ._convert import (
    GlobalBatchConverter,
    apply_batch_policy,
    default_converter,
    local_rows,
)
from .prefetch import (
    DeviceWindow,
    PrefetchIterator,
    StagingConverter,
    assemble_window,
    put_window,
)

__all__ = [
    "DeviceWindow",
    "GlobalBatchConverter",
    "PrefetchIterator",
    "SerialIterator",
    "StagingConverter",
    "apply_batch_policy",
    "assemble_window",
    "put_window",
    "create_multi_node_iterator",
    "create_synchronized_iterator",
    "default_converter",
    "local_rows",
]


def _array_columns(dataset):
    """A numpy-array dataset (rows are examples), or a tuple of numpy
    field arrays of one length: the column tuple; else None."""
    if isinstance(dataset, np.ndarray):
        return (dataset,)
    if isinstance(dataset, tuple) and dataset and all(
            isinstance(a, np.ndarray) and a.ndim >= 1 for a in dataset):
        n = len(dataset[0])
        if all(len(a) == n for a in dataset):
            return tuple(dataset)
    return None


class SerialIterator:
    """Sequential batch iterator with epoch bookkeeping.

    Indexable datasets yield lists of examples (the Chainer protocol).
    A numpy array, or a tuple of field arrays, takes the fast path: one
    fancy-index gather a field, the batch yielded already stacked."""

    def __init__(self, dataset, batch_size: int, repeat: bool = True,
                 shuffle: bool = False, seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self.reset()

    @property
    def dataset_length(self) -> int:
        return self._len

    def reset(self):
        self._columns = _array_columns(self.dataset)
        self._len = (len(self._columns[0]) if self._columns is not None
                     else len(self.dataset))
        self.epoch = 0
        self.is_new_epoch = False
        self._pos = 0
        self._exhausted = False
        self._order = np.arange(self._len)
        if self._shuffle:
            self._rng.shuffle(self._order)

    @property
    def repeat(self) -> bool:
        return self._repeat

    @property
    def epoch_detail(self) -> float:
        return self.epoch + self._pos / max(self._len, 1)

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        n, start = self._len, self._pos
        stop = min(start + self.batch_size, n)
        if self._columns is not None:
            idx = self._order[start:stop]
            cols = tuple(a[idx] for a in self._columns)
            batch = cols[0] if isinstance(self.dataset, np.ndarray) \
                else cols
        else:
            batch = [self.dataset[int(i)] for i in self._order[start:stop]]
        self._pos = stop
        if self._pos >= n:
            # the epoch completes with this batch (Chainer's contract)
            self.epoch += 1
            self.is_new_epoch = True
            self._pos = 0
            if self._repeat:
                if self._shuffle:
                    self._rng.shuffle(self._order)
            else:
                self._exhausted = True
        else:
            self.is_new_epoch = False
        return batch

    next = __next__

    def state_dict(self) -> dict:
        s = self._rng.get_state()
        return {
            "epoch": self.epoch,
            "is_new_epoch": self.is_new_epoch,
            "pos": self._pos,
            "exhausted": self._exhausted,
            "order": np.asarray(self._order).copy(),
            "rng_keys": np.asarray(s[1], np.uint32),
            "rng_pos": int(s[2]),
            "rng_has_gauss": int(s[3]),
            "rng_cached": float(s[4]),
        }

    def load_state_dict(self, st: dict) -> None:
        self.epoch = int(st["epoch"])
        self.is_new_epoch = bool(st["is_new_epoch"])
        self._pos = int(st["pos"])
        self._exhausted = bool(st["exhausted"])
        self._order = np.asarray(st["order"])
        self._rng.set_state((
            "MT19937", np.asarray(st["rng_keys"], np.uint32),
            int(st["rng_pos"]), int(st["rng_has_gauss"]),
            float(st["rng_cached"])))


class _BroadcastIterator:
    """Every rank yields the master rank's batches (``bcast_obj``)."""

    def __init__(self, iterator, comm, rank_master: int = 0):
        self._it = iterator
        self._comm = comm
        self._master = rank_master

    def __iter__(self):
        return self

    def __next__(self):
        comm, master = self._comm, self._master
        if comm.size == 1:
            return next(self._it)
        payload = None
        if comm.rank == master:
            try:
                payload = ("batch", next(self._it), self._it.epoch,
                           self._it.is_new_epoch)
            except StopIteration:
                payload = ("stop", None, None, None)
        kind, batch, epoch, new_epoch = comm.bcast_obj(payload, root=master)
        if kind == "stop":
            raise StopIteration
        self.epoch = epoch
        self.is_new_epoch = new_epoch
        return batch

    next = __next__

    def __getattr__(self, name):
        return getattr(self._it, name)

    def reset(self):
        self._it.reset()


def create_multi_node_iterator(iterator, comm, rank_master: int = 0):
    """Identical batches on every rank (the model-parallel
    requirement): the master runs the iterator and broadcasts each
    batch."""
    return _BroadcastIterator(iterator, comm, rank_master)


def create_synchronized_iterator(iterator, comm, seed: int = 0):
    """Reseed the iterator's RNG with rank 0's ``seed`` so every rank
    draws the same shuffle order, with no per-batch communication."""
    agreed = comm.bcast_obj(seed, root=0)
    if hasattr(iterator, "_rng"):
        iterator._rng = np.random.RandomState(agreed)
        iterator.reset()
    return iterator
