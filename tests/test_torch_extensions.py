"""ChainerMN's trainer extensions in the port, against the JAX package:
one 2-process gloo world for the module runs the cross-rank drills
(fallback resume with a quarantine on one rank and the agreed
``history`` GC, SIGTERM on one rank, the persistent-value and
observation means, the watchdog's heartbeats through the world's store,
and last the global except hook ending both processes); the
single-process cases run here."""

import json
import os
import signal
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chainermn_tpu.extensions import (
    AllreducePersistentValues as JaxAllreducePersistentValues,
    ObservationAggregator as JaxObservationAggregator,
)
from chainermn_tpu_torch import training
from chainermn_tpu_torch.communicators import LoopbackCommunicator
from chainermn_tpu_torch.extensions import (
    FailOnNonNumber,
    PreemptionCheckpointer,
    TrainingWatchdog,
    add_global_except_hook,
    create_multi_node_checkpointer,
)
from chainermn_tpu_torch.extensions import global_except_hook as geh
from chainermn_tpu_torch.testing import FaultInjector, FaultPlan
from test_torch_world import linear_job, run_world

N = 2
# the except hook must end both processes this soon after the raise
ABORT_BOUND_S = 30


@pytest.fixture()
def comm():
    return LoopbackCommunicator(device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("ext")
    rng = np.random.RandomState(0)
    payload = dict(root=str(root),
                   bn_mean=rng.randn(N, 5).astype(np.float32),
                   bn_var=rng.rand(N, 5).astype(np.float32) + 0.5,
                   obs_loss=rng.rand(N).astype(np.float32).tolist(),
                   obs_time=rng.rand(N).tolist())
    info = {}
    got = run_world(root, N, "battery_extensions", payload, info=info)
    return payload, got, info, root


# --------------------------------------------------------------------- #
# across ranks
# --------------------------------------------------------------------- #

def test_fallback_resume_agrees_across_ranks(world):
    _, got, _, _ = world
    for r in range(N):
        assert got[r]["fallback_resumed"] == 10
        assert got[r]["fallback_w"] == [10.0] * 3
        # rank 1's bad file is quarantined, never deleted; rank 0's
        # clean file of the same set is left alone
        assert got[r]["fallback_files"] == [
            "snapshot_iter_10.0", "snapshot_iter_10.1",
            "snapshot_iter_15.0", "snapshot_iter_15.1.corrupt",
            "snapshot_iter_5.0", "snapshot_iter_5.1"]
        assert got[r]["twice_resumed"] == 5
        assert got[r]["twice_w"] == [5.0] * 3


def test_history_gc_protects_agreed_sets(world):
    _, got, _, _ = world
    # 15 is complete on rank 0 only: no history slot, so {20, 10} stay
    want = ["snapshot_iter_10.0", "snapshot_iter_10.1",
            "snapshot_iter_15.1.corrupt", "snapshot_iter_20.0",
            "snapshot_iter_20.1"]
    assert got[1]["gc_files"] == want
    assert [got[r]["second_resume"] for r in range(N)] == [20, 20]


def test_sigterm_on_one_rank_saves_the_same_iteration(world):
    _, got, _, _ = world
    for r in range(N):
        s = got[r]["sigterm"]
        assert s["iteration"] == 3 and s["resumed"] == 3 and s["same_w"]
        assert "preemption" in s["stop_reason"]
        assert s["files"] == ["snapshot_iter_3.0", "snapshot_iter_3.1"]
        assert s["handler_restored"]
    assert [got[r]["sigterm"]["signaled"] for r in range(N)] \
        == [False, True]


class _FakeJaxComm:
    """Rank ``r`` of a 2-process JAX world whose object collectives
    return both ranks' values."""

    def __init__(self, r, rows):
        self.inter_size, self.inter_rank, self._rows = N, r, rows

    def allreduce_obj(self, obj, op="sum"):
        import jax

        return jax.tree.map(lambda *xs: sum(xs[1:], xs[0]), *self._rows)

    def allgather_obj(self, obj):
        return [obj if i == self.inter_rank else row
                for i, row in enumerate(self._rows)]


def test_allreduce_persistent_matches_jax(world):
    p, got, _, _ = world
    rows = [{"mean": p["bn_mean"][r], "var": p["bn_var"][r]}
            for r in range(N)]
    for r in range(N):
        holder = SimpleNamespace(s=rows[r])
        JaxAllreducePersistentValues(
            _FakeJaxComm(r, rows), get_state=lambda up: up.s,
            set_state=lambda up, v: setattr(up, "s", v)
        ).allreduce_persistent(holder)
        mean, var, n = got[r]["persistent"]
        np.testing.assert_array_equal(mean, holder.s["mean"])
        np.testing.assert_array_equal(var, holder.s["var"])
        assert mean.dtype == np.float32 and n == 3    # the count kept


def test_observation_aggregator_matches_jax(world):
    p, got, _, _ = world
    rows = [{"main/loss": p["obs_loss"][r], "main/host_time":
             p["obs_time"][r], f"only{r}": float(r + 7)} for r in range(N)]
    for r in range(N):
        tr = SimpleNamespace(observation=dict(rows[r]))
        JaxObservationAggregator(_FakeJaxComm(r, rows)).observe(tr)
        assert got[r]["observation"] == pytest.approx(tr.observation,
                                                      rel=1e-6)
        assert got[r]["observation"]["only1"] == 8.0


def test_watchdog_heartbeats_cross_ranks(world):
    _, got, _, _ = world
    kinds0 = [k for k, _, _ in got[0]["watchdog"]]
    assert ("peer-stall", [1], True) in got[0]["watchdog"]
    assert "local-stall" not in kinds0
    assert "local-stall" in [k for k, _, _ in got[1]["watchdog"]]


def test_watchdog_reports_when_the_store_host_dies(tmp_path):
    """Rank 0 hosts the world's store and exits; rank 1, stalled, still
    reports rank 0 (store unreachable) and then its own stall."""
    got = run_world(tmp_path, N, "battery_watchdog_store_host_exit",
                    dict(root=str(tmp_path), stall_timeout=1.0, wait_s=15),
                    tcp=True)
    assert got[0] == []
    gone = [rep for rep in got[1] if rep[2] is not None]
    assert gone and gone[0][1] == [0], got[1]
    assert "local-stall" in [k for k, _, _ in got[1]], got[1]


def test_except_hook_ends_both_ranks(world):
    _, _, info, root = world
    assert info["exitcodes"] == [1] * N
    ends = [float((root / f"finale.{r}").read_text()) for r in range(N)]
    assert info["ended_at"] - min(ends) < ABORT_BOUND_S
    for r in range(N):
        dump = (root / f"trace_crash.rank{r}.txt").read_text()
        assert "Thread" in dump or "Current thread" in dump


# --------------------------------------------------------------------- #
# one process
# --------------------------------------------------------------------- #

def test_fail_on_non_number(comm, tmp_path):
    t, _, _, _ = linear_job(comm, tmp_path, ckpt_every=None)
    t.extend(FailOnNonNumber())
    t.extend(FaultInjector(FaultPlan(nan_at_iteration=2), comm))
    with pytest.raises(RuntimeError, match="non-finite main/loss"):
        t.run()
    assert t.updater.iteration == 3
    t2, up2, _, _ = linear_job(comm, tmp_path / "ok", ckpt_every=None,
                               epochs=1)
    t2.extend(FailOnNonNumber())
    t2.run()
    assert up2.iteration == 4


def _preempt_at(it, sig):
    @training.make_extension(trigger=(1, "iteration"), priority=999)
    def fake_preemption(tr):
        if tr.updater.iteration == it:
            os.kill(os.getpid(), sig)
    return fake_preemption


@pytest.mark.parametrize("async_write", [False, True],
                         ids=["sync", "async"])
def test_preemption_checkpoints_and_stops(comm, tmp_path, async_write):
    # extended with a trigger that never fires, so the trainer's
    # finalize joins an async write
    t, up, cp, _ = linear_job(comm, tmp_path, ckpt_every=10**6, epochs=50,
                              async_write=async_write)
    pre = PreemptionCheckpointer(cp, comm, signals=(signal.SIGUSR1,))
    t.extend(pre)
    t.extend(_preempt_at(4, signal.SIGUSR1))
    t.run()
    assert up.iteration == 4 and "preemption" in t.stop_reason
    assert pre.signaled
    # written and loadable now: finalize joined an async write
    t2, up2, cp2, _ = linear_job(comm, tmp_path, ckpt_every=None, epochs=50)
    assert cp2.maybe_load(up2, t2) == 4
    assert torch.equal(up2.params["w"], up.params["w"])


def test_preemption_check_interval_and_handler_chain(comm, tmp_path):
    hits = []
    prev = signal.signal(signal.SIGUSR2, lambda s, f: hits.append(s))
    try:
        t, up, cp, _ = linear_job(comm, tmp_path, ckpt_every=None,
                                  epochs=50)
        pre = PreemptionCheckpointer(cp, comm, signals=(signal.SIGUSR2,),
                                     check_interval=3)
        t.extend(pre)
        t.extend(_preempt_at(1, signal.SIGUSR2))
        t.run()
        assert up.iteration == 3                 # the shared cadence
        assert hits == [signal.SIGUSR2]          # chained, not replaced
        assert signal.getsignal(signal.SIGUSR2) is not pre._handler
        assert cp._agreed_inventory()[0] == [3]
    finally:
        signal.signal(signal.SIGUSR2, prev)


def test_except_hook_install_and_single_process_delegates(capsys):
    prev = sys.excepthook
    calls = []
    try:
        sys.excepthook = lambda *a: calls.append(a)
        geh._installed = False
        add_global_except_hook()
        first = sys.excepthook
        add_global_except_hook()
        assert sys.excepthook is first
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        assert len(calls) == 1          # the previous hook, no exit
        err = capsys.readouterr().err
        assert "Uncaught exception on rank 0" in err and "boom" in err
    finally:
        sys.excepthook = prev
        geh._installed = False


def test_watchdog_reports_a_stall(tmp_path):
    """Within a generous bound: a 0.5 s threshold, up to 10 s."""
    reports = []
    wd = TrainingWatchdog(stall_timeout=0.5, check_interval=0.1,
                          on_stall=reports.append,
                          report_path=str(tmp_path / "s.json"))
    wd.start()
    try:
        wd.heartbeat(iteration=7)
        deadline = time.monotonic() + 10
        while not reports and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        wd.stop()
    assert reports and reports[0]["kind"] == "local-stall"
    assert reports[0]["iteration"] == 7
    assert reports[0]["seconds_since_heartbeat"] > 0.5
    on_disk = json.loads((tmp_path / "s.json").read_text())
    assert on_disk["not_ported"]["trace_tail"].endswith("item 10")
    assert not on_disk["peer_heartbeats"]
    assert any("MainThread" in k for k in on_disk["threads"])
    assert wd.stall_count == 1            # one report an episode


def test_watchdog_on_stall_exception_swallowed(tmp_path):
    def boom(report):
        raise RuntimeError("metrics push failed")

    wd = TrainingWatchdog(stall_timeout=0.2, check_interval=0.05,
                          on_stall=boom,
                          report_path=str(tmp_path / "s.json"))
    wd.start()
    try:
        wd.heartbeat()
        deadline = time.monotonic() + 10
        while not wd.stall_count and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        wd.stop()
    assert wd.stall_count >= 1 and wd._thread is None


def test_watchdog_in_trainer(comm, tmp_path):
    before = {t.ident for t in threading.enumerate()}
    t, _, _, _ = linear_job(comm, tmp_path, ckpt_every=None, epochs=1)
    reports = []
    wd = TrainingWatchdog(stall_timeout=0.5, check_interval=0.1,
                          on_stall=reports.append)
    t.extend(wd)

    @training.make_extension(trigger=(1, "iteration"), priority=5)
    def stall(tr):
        if tr.updater.iteration == 3:
            time.sleep(2.0)

    t.extend(stall)
    t.run()
    assert wd.report_path == str(tmp_path / "out" / "stall_report.json")
    assert [r["iteration"] for r in reports] == [3]
    assert not [th for th in threading.enumerate()
                if th.ident not in before and th.name == "training-watchdog"]


def test_watchdog_bad_config():
    with pytest.raises(ValueError):
        TrainingWatchdog(stall_timeout=0)
    with pytest.raises(ValueError):
        TrainingWatchdog(stall_timeout=10, check_interval=-1)


def test_checkpointer_priority_after_log_report():
    cp = create_multi_node_checkpointer(LoopbackCommunicator(device="cpu"),
                                        "x")
    assert cp.priority < training.LogReport().priority
    assert PreemptionCheckpointer(cp).priority < cp.priority
