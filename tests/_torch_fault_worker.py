"""One phase of the port's kill → resume drill, in a process of its own:

    python tests/_torch_fault_worker.py <phase> <workdir> <plan_json>

``train`` runs ``test_torch_world.linear_job`` (sync checkpoints every 3
iterations, ``history=2``) with the fault plan armed, so a kill plan
ends this process mid-run; ``resume`` runs ``maybe_load`` and finishes
the 6 epochs.  Each phase that finishes writes its final parameters and
loss log to ``<workdir>/<phase>.npz``.  Imports the port only.
"""

import os
import sys
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

from chainermn_tpu_torch.communicators import (  # noqa: E402
    LoopbackCommunicator,
)
from chainermn_tpu_torch.testing import FaultInjector, FaultPlan  # noqa: E402
from chainermn_tpu_torch.utils import save_state  # noqa: E402
from test_torch_world import linear_job  # noqa: E402


def main():
    phase, workdir, plan_json = sys.argv[1], Path(sys.argv[2]), sys.argv[3]
    comm = LoopbackCommunicator(device="cpu")
    trainer, up, cp, log = linear_job(comm, workdir, history=2)
    if phase == "train":
        trainer.extend(FaultInjector(FaultPlan.from_json(plan_json), comm,
                                     checkpointer=cp))
    else:
        print(f"RESUMED_AT {cp.maybe_load(up, trainer)}", flush=True)
    trainer.run()
    save_state(str(workdir / f"{phase}.npz"), {
        "params": up.params, "iteration": up.iteration,
        "log_losses": np.asarray([e["main/loss"] for e in log.log],
                                 np.float64)})
    print(f"PHASE_OK {phase} iter={up.iteration}", flush=True)


if __name__ == "__main__":
    main()
