"""ChainerMN's trainer extensions and fault tolerance (the JAX
package's ``extensions/``; ChainerMN's layer L5):

- :func:`create_multi_node_checkpointer`: per-rank snapshots with
  CRC-checked resume from the latest set every rank holds, quarantine
  and fallback, ``history=N`` GC and async writes.
- :func:`multi_node_snapshot`: one logical snapshot (a writer rank and
  a barrier) and :func:`load_snapshot`.
- :class:`AllreducePersistentValues`: the mean over ranks of persistent
  state (BN running statistics).
- :class:`ObservationAggregator`: the mean over ranks of logged scalars.
- :class:`FailOnNonNumber`: raise on a non-finite loss.
- :class:`PreemptionCheckpointer`: save and stop on ``SIGTERM``.
- :func:`add_global_except_hook`: one rank's uncaught exception ends
  the whole job.
- :class:`TrainingWatchdog`: stall reports from step heartbeats, across
  ranks through the world's store.

Not ported: ``GoodputReport``, ``MetricsTextfile``, ``MetricsExport``
and ``StragglerReport`` (the observability plane, ROADMAP Queue A item
10).
"""

from chainermn_tpu_torch.extensions.allreduce_persistent import (
    AllreducePersistentValues,
)
from chainermn_tpu_torch.extensions.checkpoint import (
    MultiNodeCheckpointer,
    create_multi_node_checkpointer,
)
from chainermn_tpu_torch.extensions.fail_on_non_number import (
    FailOnNonNumber,
)
from chainermn_tpu_torch.extensions.global_except_hook import (
    add_global_except_hook,
)
from chainermn_tpu_torch.extensions.observation_aggregator import (
    ObservationAggregator,
)
from chainermn_tpu_torch.extensions.preemption import PreemptionCheckpointer
from chainermn_tpu_torch.extensions.snapshot import (
    load_snapshot,
    multi_node_snapshot,
)
from chainermn_tpu_torch.extensions.watchdog import TrainingWatchdog

__all__ = [
    "AllreducePersistentValues",
    "FailOnNonNumber",
    "MultiNodeCheckpointer",
    "ObservationAggregator",
    "PreemptionCheckpointer",
    "TrainingWatchdog",
    "add_global_except_hook",
    "create_multi_node_checkpointer",
    "load_snapshot",
    "multi_node_snapshot",
]
