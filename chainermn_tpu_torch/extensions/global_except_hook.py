"""Global except hook — one rank's crash ends the whole job (ChainerMN's
``global_except_hook``, which called ``MPI_Abort``; the JAX package's
``extensions/global_except_hook.py``).

Without it, an uncaught exception on one rank leaves the others blocked
in their next collective until its timeout.  The hook prints the
traceback tagged with the rank, dumps every thread's stack next to it,
then ``os._exit(1)``: no cleanup that could hang, and a non-zero exit
that makes ``torchrun``'s agent tear the other ranks down.  It does not
call ``destroy_process_group()``, which can block behind a peer stuck in
a collective.  In a one-rank world it defers to the previous hook.

Not ported: the flight recorder's timeline in the crash dump (ROADMAP
Queue A item 10); the dump holds the threads' stacks.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import traceback

import torch.distributed as dist

__all__ = ["add_global_except_hook"]

_installed = False
_trace_dir: str = "."


def _world():
    """``(rank, size)`` of the default process group, ``(0, 1)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _dump_trace(rank: int) -> str:
    """Every thread's stack, as ``faulthandler`` prints it, into
    ``trace_crash.rank<r>.txt`` under the trace directory (env
    ``CHAINERMN_TPU_TRACE_DIR``, else the one ``add_global_except_hook``
    was given, else the working directory)."""
    out_dir = os.environ.get("CHAINERMN_TPU_TRACE_DIR", _trace_dir)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_crash.rank{rank}.txt")
    with open(path, "w") as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
    return path


def _make_hook(prev_hook):
    def _global_except_hook(exc_type, exc_value, exc_traceback):
        rank, size = _world()
        if size <= 1:
            # one rank: nobody waits for it, the previous hook ends it
            sys.stderr.write(f"\nUncaught exception on rank {rank}/{size} "
                             "(global except hook):\n")
            traceback.print_exception(
                exc_type, exc_value, exc_traceback, file=sys.stderr)
            prev_hook(exc_type, exc_value, exc_traceback)
            return
        try:
            sys.stderr.write(
                f"\nUncaught exception on rank {rank}/{size}: aborting "
                "the whole job (global except hook):\n")
            traceback.print_exception(
                exc_type, exc_value, exc_traceback, file=sys.stderr)
            path = _dump_trace(rank)
            sys.stderr.write(f"[chainermn_tpu_torch] rank {rank}: every "
                             f"thread's stack dumped to {path}\n")
            sys.stderr.flush()
        finally:
            os._exit(1)     # MPI_Abort: no cleanup, no hang

    return _global_except_hook


def add_global_except_hook(trace_dir=None) -> None:
    """Install the hook once (ChainerMN installed it on import; here it
    is explicit).  ``trace_dir`` is where the crash dump goes; ``None``
    keeps the directory an earlier call set."""
    global _installed, _trace_dir
    if trace_dir is not None:
        _trace_dir = trace_dir
    if _installed:
        return
    sys.excepthook = _make_hook(sys.excepthook)
    _installed = True
