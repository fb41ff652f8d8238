"""Dataset scattering across ranks (the JAX package's
``datasets/__init__.py``; ChainerMN's ``scatter_dataset``,
``create_empty_dataset``, ``shuffle_data_blocks``).

Process model: the JAX package scatters over *processes*
(``comm.inter_size``, one controller a host feeding every local device).
A port process is one rank driving one GPU, so the port scatters over
``comm.size`` and takes ``comm.rank``'s shard — ChainerMN's own split.
Every rank derives the same partition from ``seed`` with numpy's
``RandomState``, so the shards equal the JAX package's ``_partition`` of
the same length bit for bit.  :mod:`.bpe` is the byte-level BPE
tokenizer of the LM example's real-text path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .bpe import BPETokenizer, train_bpe

__all__ = [
    "BPETokenizer",
    "EmptyDataset",
    "SubDataset",
    "create_empty_dataset",
    "scatter_dataset",
    "scatter_index",
    "shuffle_data_blocks",
    "train_bpe",
]


class SubDataset:
    """A view of ``dataset`` through an index list (order = iteration
    order)."""

    def __init__(self, dataset, indices: np.ndarray):
        self._dataset = dataset
        self._indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._dataset[int(j)] for j in self._indices[i]]
        return self._dataset[int(self._indices[i])]

    @property
    def indices(self) -> np.ndarray:
        return self._indices


def _partition(n: int, size: int, shuffle: bool, seed: Optional[int],
               force_equal_length: bool):
    order = np.arange(n)
    if shuffle:
        rng = np.random.RandomState(seed if seed is not None else 0)
        rng.shuffle(order)
    base, rem = divmod(n, size)
    parts, start = [], 0
    for r in range(size):
        stop = start + base + (1 if r < rem else 0)
        parts.append(order[start:stop])
        start = stop
    if force_equal_length and rem:
        # pad short shards by wrapping: every rank runs the same number
        # of iterations, or its collectives would wait forever
        target = base + 1
        parts = [p if len(p) == target
                 else np.concatenate([p, order[:target - len(p)]])
                 for p in parts]
    return parts


def scatter_dataset(dataset, comm, root: int = 0, shuffle: bool = False,
                    seed: Optional[int] = None,
                    force_equal_length: bool = True):
    """Split ``dataset`` into near-equal shards, one a rank.  Only the
    length travels (``bcast_obj`` from ``root``), so a rank whose local
    dataset object is a stub still agrees on the partition."""
    n = comm.bcast_obj(len(dataset), root=root)
    parts = _partition(n, comm.size, shuffle, seed, force_equal_length)
    return SubDataset(dataset, parts[comm.rank])


def scatter_index(n_total: int, comm, root: int = 0,
                  force_equal_length: bool = True):
    """This rank's indices of ``range(n_total)``, without touching
    data."""
    n_total = comm.bcast_obj(n_total, root=root)
    return _partition(n_total, comm.size, False, None,
                      force_equal_length)[comm.rank]


class EmptyDataset:
    """Length-preserving empty stand-in (ChainerMN's
    ``create_empty_dataset``): a rank that must iterate in lockstep but
    consumes no data."""

    def __init__(self, n: int):
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [()] * len(range(*i.indices(self._n)))
        if not -self._n <= i < self._n:
            raise IndexError(i)
        return ()


def create_empty_dataset(dataset) -> EmptyDataset:
    return EmptyDataset(len(dataset))


def shuffle_data_blocks(comm, local_block: Sequence, seed: int = 0):
    """Globally shuffle examples held as per-rank blocks: every rank
    ends with a near-equal, globally shuffled share.  A shared ``seed``
    gives every rank the same permutation; each example's permuted
    position picks its destination from a balanced contiguous split,
    the exchange rides ``alltoall_obj``, and receivers re-order by
    position, so the result is the permuted concatenation of all
    blocks."""
    rows = comm.allgather_obj((comm.rank, len(local_block)))
    sizes = [n for _, n in rows]
    me = [r for r, _ in rows].index(comm.rank)
    total = sum(sizes)
    n_members = len(rows)

    rng = np.random.RandomState(seed)
    inv = np.empty(total, np.int64)
    inv[rng.permutation(total)] = np.arange(total)
    bounds = [total * j // n_members for j in range(n_members + 1)]

    offset = sum(sizes[:me])
    my_pos = inv[offset:offset + len(local_block)]
    dests = np.searchsorted(bounds, my_pos, side="right") - 1
    send = [[] for _ in range(n_members)]
    for i, example in enumerate(local_block):
        send[int(dests[i])].append((int(my_pos[i]), example))

    received = comm.alltoall_obj(send)
    merged = sorted((item for row in received for item in row),
                    key=lambda t: t[0])
    return [example for _, example in merged]
