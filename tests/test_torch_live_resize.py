"""The live resize in the port (``training/elastic.py``'s
``ResizeController``, ``ElasticMembership`` and ``post_resize_intent``,
``StandardUpdater.rebind_world``, the checkpointers' ``rebind_world``,
``FaultPlan(resize_live_at_iteration=)``) against the JAX package's —
the counterparts of ``tests/extension_tests/test_live_resize.py``,
``TestMembershipSingleProcess`` of ``test_elastic_checkpoint.py`` and
the multiprocess scenarios ``elastic_membership`` and ``resize_live``.

A port process is one rank, so the JAX package's worlds of 8 and 4
devices are worlds of 4 and 2 processes here: one 4-rank gloo world
(``battery_live_resize`` in ``test_torch_world.py``) runs every case,
each building its worlds over the launch's ranks with
``create_communicator(ranks=)``; ranks 2 and 3 are PARKED inside the
controller while the world is 2.  The acceptance drill (the MLP,
``adam(5e-2)`` under ZeRO-1, 96 examples, a global batch of 16, live
4 → 2 → 4 through ``FaultPlan`` and a request back) is bitwise the
save/restart chain at the same boundaries — every loss, the final
parameters and each rank's optimizer rows — and its losses agree with
the JAX ``ResizeController`` run of the same schedule on
``jax.devices()[:4]`` and ``[:2]`` (tolerance below).  The control plane
runs on a 2-rank world over its store.
"""

import concurrent.futures
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu as cmn
from chainermn_tpu.models import mlp_apply as jax_mlp_apply
from chainermn_tpu.models import softmax_cross_entropy as jax_xent
from chainermn_tpu.testing import FaultInjector as JaxInjector
from chainermn_tpu.testing import FaultPlan as JaxPlan
from chainermn_tpu.training.elastic import ResizeController as JaxController
from chainermn_tpu_torch import training
from chainermn_tpu_torch.communicators import (
    KVObjectChannel,
    LoopbackCommunicator,
)
from chainermn_tpu_torch.testing import FaultInjector, FaultPlan
from chainermn_tpu_torch.training.elastic import (
    ElasticMembership,
    ResizeController,
    post_resize_intent,
)

from test_torch_world import (
    LIVE_BATCH,
    live_dataset,
    live_params,
    run_world,
)

# The port means the ranks' local losses and gradients over the gloo
# group where the JAX package means over the devices of one program;
# the same float32 sums in another order differ by a few ulps a step,
# which Adam's first steps (update ≈ lr·sign(g) where |g| is small)
# carry into the parameters.  Over 6 steps of adam(5e-2) on this MLP
# the losses stay within 1e-5 relative of each other (measured: below
# 1e-6); a resize that put a row in the wrong place, or a stale
# optimizer state, moves them by 1e-2 or more.
JAX_LOSS_RTOL = 1e-5


# --------------------------------------------------------------------- #
# the JAX run of the drill's schedule
# --------------------------------------------------------------------- #

def _jax_world(n):
    return cmn.create_communicator("tpu_xla", devices=jax.devices()[:n])


def _jax_opt(comm):
    return cmn.create_multi_node_optimizer(optax.adam(5e-2), comm,
                                           zero1=True)


def _jax_drill(out):
    """The JAX ``ResizeController`` on the drill's schedule: 4 devices,
    ``FaultPlan(resize_live_at_iteration=2, resize_live_to=2)``, a
    second plan back to 4 at iteration 4, stop at 6; the losses a
    step."""
    params = [{k: jax.numpy.asarray(v) for k, v in layer.items()}
              for layer in live_params()]
    comm = _jax_world(4)
    it = cmn.SerialIterator(live_dataset(), LIVE_BATCH, shuffle=True,
                            seed=7)

    def loss_fn(p, x, y):
        return jax_xent(jax_mlp_apply(p, x), y)

    upd = cmn.StandardUpdater(it, _jax_opt(comm), loss_fn, params, comm,
                              max_inflight=1)
    trainer = cmn.Trainer(upd, (6, "iteration"), out=str(out))
    ctrl = JaxController(_jax_world, _jax_opt)
    log = cmn.LogReport(trigger=(1, "iteration"))
    for ext in [log] + [JaxInjector(JaxPlan(resize_live_at_iteration=at,
                                            resize_live_to=to), comm,
                                    resize_controller=ctrl)
                        for at, to in ((2, 2), (4, 4))] + [ctrl]:
        trainer.extend(ext)
    trainer.run()
    return dict(losses={int(e["iteration"]): float(e["main/loss"])
                        for e in log.log},
                worlds=[r["world"] for r in ctrl.resizes])


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """Every rank's results of the 4-rank battery and of the 2-rank
    control plane (run in a thread), and the JAX drill (meanwhile)."""
    root = tmp_path_factory.mktemp("live")
    pool = concurrent.futures.ThreadPoolExecutor(1)

    def worlds():
        cases = run_world(root / "w4", 4, "battery_live_resize",
                          dict(root=str(root / "cases")))
        control = run_world(root / "w2", 2, "battery_live_control",
                            dict(root=str(root / "control")))
        return cases, control

    fut = pool.submit(worlds)
    jax_drill = _jax_drill(root / "jax")
    cases, control = fut.result()
    pool.shutdown(wait=True)
    return dict(cases=cases, control=control, jax=jax_drill)


def _rank(live, name):
    return [r[name] for r in live["cases"]]


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


# --------------------------------------------------------------------- #
# the acceptance drill: live 4 -> 2 -> 4 against save/restart
# --------------------------------------------------------------------- #

def test_drill_live_is_bitwise_the_save_restart_chain(live):
    chain = _rank(live, "drill")[0]["restart"]["losses"]
    assert sorted(chain) == [1, 2, 3, 4, 5, 6]
    for r, res in enumerate(_rank(live, "drill")):
        got, want = res["live"], res["restart"]
        # the global mean loss; ranks 2 and 3, parked for iterations 3
        # and 4, took the job's log from rank 0 when they joined
        assert got["losses"] == chain
        assert want["losses"] == {k: chain[k] for k in want["losses"]}
        _leaves_equal(got["state"]["params"], want["state"]["params"])
        _leaves_equal(got["state"]["opt"], want["state"]["opt"])
        assert got["state"]["iteration"] == 6 and got["state"]["world"] == 4
        assert want["resumed"][1] == (4, "relayout")
        assert want["resumed"][0] == ((2, "relayout") if r < 2 else None)


def test_drill_records_the_resizes_and_parks_ranks_2_and_3(live):
    for r, res in enumerate(_rank(live, "drill")):
        got = res["live"]
        assert got["fired"] == ([("resize_live", 2, 2),
                                  ("resize_live", 4, 4)] if r < 2
                                 else [("resize_live", 2, 2)])
        assert [(x["iteration"], x["world"], x["epoch"])
                for x in got["resizes"]] == [(2, 2, 1), (4, 4, 2)]
        assert all(x["pause_s"] > 0 and x["bytes_moved"] > 0
                   for x in got["resizes"])
        # the joiners' second record says they joined
        assert got["resizes"][1].get("joined", False) == (r >= 2)
        assert got["closed"] and got["stop"] is None


def test_drill_losses_agree_with_the_jax_controller(live):
    want = live["jax"]
    assert want["worlds"] == [2, 4]
    got = _rank(live, "drill")[0]["live"]["losses"]
    assert sorted(want["losses"]) == sorted(got)
    np.testing.assert_allclose(
        [got[k] for k in sorted(got)],
        [want["losses"][k] for k in sorted(got)], rtol=JAX_LOSS_RTOL)


# --------------------------------------------------------------------- #
# the JAX test_live_resize.py cases
# --------------------------------------------------------------------- #

def test_4_2_4_by_direct_resize_calls_is_bitwise_save_restart(live):
    for r, res in enumerate(_rank(live, "direct")):
        got, want = res["live"], res["restart"]
        assert got["grow"] == (4, 5)
        assert got["worlds"] == [2, 4] and all(
            p > 0 for p in got["pauses"])
        for k, loss in got["losses"].items():
            assert want["losses"][k] == loss
        assert len(got["losses"]) == (8 if r < 2 else 5)
        _leaves_equal(got["state"]["params"], want["state"]["params"])
        _leaves_equal(got["state"]["opt"], want["state"]["opt"])


def test_same_world_resize_is_epoch_only_and_bitwise(live):
    for res in _rank(live, "same_world"):
        assert res["epoch"] == 1 and res["closed"] and res["renewed"]
        assert res["got"] == res["ref"]


def test_request_fires_at_next_boundary_and_training_continues(live):
    for r, res in enumerate(_rank(live, "request")):
        assert res["resizes"] == [{"iteration": 1, "world": 2,
                                   "epoch": 1}]
        assert res["requested"] is None        # intent consumed
        if r < 2:
            assert res["iteration"] == 6 and res["world"] == 2
            assert not res["parked"] and res["stop"] is None
        else:
            # parked until the job's end, then stopped
            assert res["parked"] and res["iteration"] == 1
            assert "parked" in res["stop"]


def test_fault_plan_drill_arms_controller_same_tick(live):
    for r, res in enumerate(_rank(live, "fault_plan")):
        assert ("resize_live", 3, 2) in res["fired"]
        (rec,) = res["resizes"]
        assert {k: rec[k] for k in ("iteration", "world", "epoch")} == {
            "iteration": 3, "world": 2, "epoch": 1}
        assert (res["iteration"], res["world"]) == (
            (7, 2) if r < 2 else (3, None))


def test_drill_without_controller_is_a_loud_error(tmp_path):
    comm = LoopbackCommunicator(device="cpu")
    up = training.StandardUpdater(
        training_iterator(), training.create_multi_node_optimizer(
            training.adam(5e-2), comm), _loss, _params(), comm)
    trainer = training.Trainer(up, (4, "iteration"), out=str(tmp_path))
    trainer.extend(FaultInjector(FaultPlan(resize_live_at_iteration=2,
                                           resize_live_to=1), comm))
    with pytest.raises(RuntimeError, match="resize_controller"):
        trainer.run()


def test_resize_drops_captured_windows_and_closes_the_old_world(live):
    for r, res in enumerate(_rank(live, "windows")):
        assert res["old_closed"]
        if r < 2:
            assert res["windows"] == {} and res["renewed"]
            assert res["new_opt"] and res["after"] == 2
            # the hook ran last, under the new world and epoch
            assert res["calls"] == [("on_resize", 2, 1, True)]
        else:
            assert res["parked"] and res["calls"] == []


@pytest.mark.parametrize("kw", [dict(drain_engines=(object(),)),
                                dict(drain_timeout=1.5)],
                         ids=["engines", "timeout"])
def test_drain_engines_is_not_ported(kw):
    # the timeout bounds a serving engine's drain, so it is refused
    # with drain_engines rather than accepted and ignored
    with pytest.raises(NotImplementedError,
                       match=f"{next(iter(kw))}.*ROADMAP Queue A item 12"):
        ResizeController(lambda n: None, lambda c: None, **kw)


def test_request_validation():
    ctrl = ResizeController(lambda n: None, lambda c: None)
    with pytest.raises(ValueError, match="world_size"):
        ctrl.request(0)


def test_rebind_world_refuses_zero1_switch():
    comm = LoopbackCommunicator(device="cpu")
    up = training.StandardUpdater(
        training_iterator(), training.create_multi_node_optimizer(
            training.adam(5e-2), comm, zero1=True), _loss, _params(),
        comm)
    up.update()
    plain = training.create_multi_node_optimizer(training.adam(5e-2),
                                                 comm, zero1=False)
    with pytest.raises(ValueError, match="zero1"):
        up.rebind_world(LoopbackCommunicator(device="cpu"), plain)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_global_batch_converter_takes_the_updaters_split_policy(
        drop_remainder):
    # a batch of 6 over a world of 4: the updater's policy drops the 2
    # remainder rows or raises, as the JAX package's apply_batch_policy
    # does, and rank 1 takes the JAX batch sharding's row 1 (exact)
    from types import SimpleNamespace

    from chainermn_tpu.iterators.prefetch import (
        apply_batch_policy as jax_policy,
    )
    from chainermn_tpu_torch.iterators import (
        GlobalBatchConverter,
        default_converter,
    )

    comm = LoopbackCommunicator(device="cpu")
    conv = GlobalBatchConverter(comm)
    training.StandardUpdater(
        training_iterator(), training.create_multi_node_optimizer(
            training.adam(5e-2), comm, zero1=True), _loss, _params(),
        comm, converter=conv, drop_remainder=drop_remainder)
    assert conv.drop_remainder is drop_remainder
    conv.comm = SimpleNamespace(rank=1, size=4)
    batch = live_dataset()[:6]
    if not drop_remainder:
        with pytest.raises(ValueError, match="not divisible"):
            jax_policy(default_converter(batch), 4, False)
        with pytest.raises(ValueError, match="not divisible"):
            conv(batch)
        return
    want = jax_policy(default_converter(batch), 4, True)
    got = conv(batch)
    assert [g.shape[0] for g in got] == [1, 1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[1:2])


def test_post_resize_intent_needs_distributed_runtime(monkeypatch):
    from chainermn_tpu_torch import communicators

    monkeypatch.setattr(communicators, "_STORE", None)
    with pytest.raises(RuntimeError, match="distributed"):
        post_resize_intent(4)


def test_registered_checkpointer_follows_the_resize(live):
    for r, res in enumerate(_rank(live, "checkpointers")):
        if r >= 2:
            # parked: both checkpointers left the world
            assert res["parked"] and res["cp_comm"] and res["pc_comm"]
            continue
        assert res["world"] == 2 and res["stamped"] == 2
        assert res["parts"] == ["snapshot_iter_6.s0of2",
                                "snapshot_iter_6.s1of2"]
        assert res["at"] == 6 and res["mode"] == "exact"
        assert res["params"]


def test_preemption_checkpointer_follows_the_resize(live):
    for res in _rank(live, "checkpointers")[:2]:
        assert res["same"]


def test_watchdog_follows_the_resize_and_sleeps_while_parked(live):
    """The members' watchdog watches the new world; a parked rank's
    stops (it beats no heartbeat, and is not a stall)."""
    for r, res in enumerate(_rank(live, "checkpointers")):
        assert res["stalls"] == 0
        if r < 2:
            assert res["watchdog"] == dict(running=True, same=True)
        else:
            assert res["watchdog"] == {} and res["watchdog_stopped"]


def test_resize_rewraps_prefetch_feed_bitwise(live):
    for res in _rank(live, "prefetch")[:2]:
        ref, got = res["serial"], res["prefetch"]
        assert got["prefetch"] and not ref["prefetch"]
        assert got["losses"] == ref["losses"]
        _leaves_equal(got["params"], ref["params"])


def test_rebind_carries_prebuilt_prefetch_converter(live):
    for res in _rank(live, "prefetch")[:2]:
        assert res["prebuilt"] == dict(same=True, rebound=True, grew=True)


def test_per_rank_shard_feed_refuses_a_world_change(live):
    for res in _rank(live, "shard_feed"):
        assert "global-batch feed" in res["msg"]
        assert "elastic=True" in res["msg"]
        assert res["world"] == 4 and not res["closed"]


# --------------------------------------------------------------------- #
# TestMembershipSingleProcess (test_elastic_checkpoint.py:301-340)
# --------------------------------------------------------------------- #

@pytest.fixture()
def comm():
    return LoopbackCommunicator(device="cpu")


def test_membership_epochs_bump_and_persist(comm, tmp_path):
    m1 = ElasticMembership(comm, path=str(tmp_path))
    rec1 = m1.agree()
    assert rec1.epoch == 1 and rec1.members == [0]
    assert os.path.exists(tmp_path / "membership.json")
    # a later incarnation reads the persisted epoch and bumps past it
    m2 = ElasticMembership(comm, path=str(tmp_path))
    assert m2.stored_epoch() == 1
    rec2 = m2.agree()
    assert rec2.epoch == 2


def test_membership_note_stop_persists(comm, tmp_path):
    m = ElasticMembership(comm, path=str(tmp_path))
    m.agree()
    m.note_stop(reason="preemption", iteration=42)
    payload = json.loads((tmp_path / "membership.json").read_text())
    assert payload["stopped"]["reason"] == "preemption"
    assert payload["stopped"]["iteration"] == 42
    assert payload["epoch"] == 1


def test_membership_fence_before_agree_raises(comm, tmp_path):
    m = ElasticMembership(comm, path=str(tmp_path))
    with pytest.raises(RuntimeError, match="agree"):
        m.fence(comm)


def test_membership_fence_sets_channel_generation(comm, tmp_path):
    m = ElasticMembership(comm, path=str(tmp_path))
    rec = m.agree()
    chan = KVObjectChannel(tag="fence-test")
    assert m.fence(chan, comm) == rec.epoch
    assert chan.generation == rec.epoch
    assert comm._obj_channel.generation == rec.epoch


def test_membership_file_is_the_jax_record(comm, tmp_path):
    """The same record fields in ``membership.json`` as the JAX
    package's, so either package's relaunch bumps past the other's."""
    from chainermn_tpu.training.elastic import ElasticMembership as JaxM

    ElasticMembership(comm, path=str(tmp_path / "port")).agree()
    JaxM(_jax_world(1), path=str(tmp_path / "jax")).agree()
    port = json.loads((tmp_path / "port" / "membership.json").read_text())
    want = json.loads((tmp_path / "jax" / "membership.json").read_text())
    assert sorted(port) == sorted(want)
    assert {k: port[k] for k in ("epoch", "world_size", "members")} == \
        {k: want[k] for k in ("epoch", "world_size", "members")}


# --------------------------------------------------------------------- #
# the control plane on two processes (scenario_elastic_membership and
# scenario_resize_live)
# --------------------------------------------------------------------- #

def test_control_plane_on_two_processes(live):
    for me, res in enumerate(live["control"]):
        assert res["ok"]
        assert res["membership"] == dict(epoch=1, members=[0, 1], rank=me)
        assert res["relaunch_epochs"] == [(1, 2), (1, 2)]
        assert res["intent_before"] is None and res["intent_seen"] == 2
        assert res["agreed"] == 2 and res["resize_epoch"] == 1
        assert res["intent_after"] is None
    # rank 1 refused the message published before the fence, then got
    # the fenced world's own
    assert live["control"][1]["fence"] == (True, {"epoch": 1})
    assert live["control"][1]["resize_fence"] == (True, {"epoch": 1})


# --------------------------------------------------------------------- #
# helpers of the single-process cases
# --------------------------------------------------------------------- #

def training_iterator():
    from chainermn_tpu_torch.iterators import SerialIterator

    return SerialIterator(live_dataset(), LIVE_BATCH, shuffle=True, seed=7)


def _params():
    return [{k: torch.tensor(v) for k, v in layer.items()}
            for layer in live_params()]


def _loss(p, x, y):
    from chainermn_tpu_torch.models import mlp_apply, softmax_cross_entropy

    return softmax_cross_entropy(mlp_apply(p, x), y)

