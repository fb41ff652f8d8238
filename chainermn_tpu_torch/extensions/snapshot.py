"""One logical snapshot — ChainerMN's ``multi_node_snapshot`` (the JAX
package's ``extensions/snapshot.py``): one writer rank writes the
snapshot and every rank waits at a barrier, so nobody races ahead of
the write.

Unlike the checkpointer's per-rank files, this is one file of the
replicated state: for export, or a resume at another world size (the
iterator's order is then kept fresh, see ``training/_resume.py``).
"""

from __future__ import annotations

import os
from typing import Optional

from chainermn_tpu_torch.training._resume import (
    restore_updater,
    updater_state,
)
from chainermn_tpu_torch.utils.serialization import load_state, save_state

__all__ = ["load_snapshot", "multi_node_snapshot"]


class _MultiNodeSnapshot:
    priority = 30  # after the log writers (it saves their state)

    def __init__(self, comm, filename: str, writer_rank: int):
        self.comm = comm
        self.filename = filename
        self.writer_rank = writer_rank

    def __call__(self, trainer) -> None:
        if self.comm.rank == self.writer_rank:
            state = updater_state(trainer.updater, trainer)
            path = os.path.join(
                trainer.out,
                self.filename.format(iteration=trainer.updater.iteration))
            save_state(path, state)
        # nobody goes on until the writer is done
        self.comm.barrier()


def multi_node_snapshot(comm, filename: str = "snapshot_iter_{iteration}",
                        writer_rank: int = 0) -> _MultiNodeSnapshot:
    """Trainer extension: rank ``writer_rank`` writes, every rank waits."""
    return _MultiNodeSnapshot(comm, filename, writer_rank)


def load_snapshot(updater, path: str, trainer=None) -> Optional[int]:
    """Restore a :func:`multi_node_snapshot` file into ``updater`` (and
    ``trainer``); returns the restored iteration."""
    restore_updater(load_state(path), updater, trainer)
    return updater.iteration
