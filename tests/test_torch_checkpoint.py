"""The port's snapshot container and checkpointer against the JAX
package: the same numpy tree gives the same file contents (leaf keys,
arrays, dtypes, CRCs, topology); corruption and foreign files raise the
typed error; an interrupted and resumed run equals the uninterrupted
one bitwise, sync and async, and follows the JAX package's curve; a
real SIGKILL in a child process resumes bitwise.  World size 1 on the
CPU (the loopback communicator); the 2-rank drills are in
``test_torch_extensions.py``."""

import os
import pickle
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu as jcmn
from chainermn_tpu.testing import corrupt_file as jax_corrupt_file
from chainermn_tpu.training import LogReport as JaxLogReport
from chainermn_tpu.utils import serialization as jser
from chainermn_tpu_torch import training
from chainermn_tpu_torch.communicators import LoopbackCommunicator
from chainermn_tpu_torch.extensions import (
    create_multi_node_checkpointer,
    load_snapshot,
    multi_node_snapshot,
)
from chainermn_tpu_torch.testing import FaultInjector, FaultPlan, corrupt_file
from chainermn_tpu_torch.training._resume import (
    collect_train_state,
    restore_train_state,
)
from chainermn_tpu_torch.utils import serialization as tser
from test_torch_world import FakeUpdater, linear_dataset, linear_job

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "_torch_fault_worker.py"
TOPOLOGY = {"format": 1, "world_size": 1, "inter_size": 1,
            "axis_names": None, "mesh_shape": None, "zero1": False}


@pytest.fixture()
def comm():
    return LoopbackCommunicator(device="cpu")


# --------------------------------------------------------------------- #
# the container
# --------------------------------------------------------------------- #

def _trees():
    rng = np.random.RandomState(0)
    return {
        "out_of_order": {
            "zeta": {"b": rng.randn(3, 2).astype(np.float32),
                     "a": (rng.randn(4).astype(np.float64),
                           [np.arange(5, dtype=np.int32),
                            rng.randn(2, 2).astype(np.float32)])},
            "alpha": [rng.randint(0, 9, (3,)).astype(np.int64),
                      (np.asarray([True, False]),)],
            "mid": rng.randn(1).astype(np.float16)},
        "none_int_bf16": {
            "n": None, "k": 7, "x": 2.5,
            "h": rng.randn(2, 3).astype(ml_dtypes.bfloat16),
            "t": (None, rng.randn(2).astype(np.float32), [None, 3])},
    }


def _port_tree(tree):
    """The numpy tree with its bf16 leaves as torch bf16 tensors (the
    form a port user holds them in; numpy has none)."""
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_port_tree(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16)).view(torch.bfloat16)
    return tree


def _contents(path):
    with np.load(path) as z:
        leaves = {k: (z[k].shape, z[k].tobytes()) for k in z.files
                  if k.startswith("leaf_")}
        meta = pickle.loads(z["__meta__"].tobytes())
    return leaves, meta


@pytest.mark.parametrize("name", sorted(_trees()))
def test_container_matches_jax(tmp_path, name):
    tree = _trees()[name]
    jser.save_state(str(tmp_path / "jax.npz"), tree, topology=TOPOLOGY)
    tser.save_state(str(tmp_path / "port.npz"), _port_tree(tree),
                    topology=TOPOLOGY)
    jl, jm = _contents(tmp_path / "jax.npz")
    pl, pm = _contents(tmp_path / "port.npz")
    assert sorted(jl) == sorted(pl)
    assert jl == pl                     # shapes and bytes, leaf by leaf
    for key in ("dtypes", "crcs", "topology", "meta_crc_excluded"):
        assert jm[key] == pm[key], key
    # and the port reads back the values it wrote
    got = tser.load_state(str(tmp_path / "port.npz"))
    want_leaves = jser.load_state(str(tmp_path / "jax.npz"))
    import jax

    flat_want = jax.tree.leaves(want_leaves)
    flat_got, _ = tser.tree_flatten(got)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        if torch.is_tensor(g):
            assert g.dtype == torch.bfloat16
            g = g.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


def test_flatten_follows_jax_rule():
    import jax

    tree = {"b": 1, "a": 2, "n": None, "t": (3, [4])}
    leaves, treedef = tser.tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree) == [2, 1, 3, 4]
    assert tser.tree_unflatten(treedef, leaves) == tree


def test_round_trip_tensors(tmp_path):
    from chainermn_tpu_torch.links import BatchNormState

    g = torch.Generator().manual_seed(0)
    wide = torch.randn(6, 8, generator=g)
    tree = {"f32": torch.randn(3, 4, generator=g),
            "bf16": torch.randn(5, generator=g).to(torch.bfloat16),
            "strided": wide[:, ::2],           # not contiguous
            "bn": BatchNormState(torch.zeros(2), torch.ones(2),
                                 torch.tensor(4, dtype=torch.int32)),
            "step": torch.tensor(3.0)}
    tser.save_state(str(tmp_path / "s.npz"), tree)
    got = tser.load_state(str(tmp_path / "s.npz"))
    for key in ("f32", "strided", "step"):
        assert torch.equal(torch.as_tensor(got[key]), tree[key])
    assert got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"], tree["bf16"])
    assert type(got["bn"]).__name__ == "BatchNormState"
    assert got["bn"]._fields == ("mean", "var", "n")
    assert int(got["bn"].n) == 4
    tser.verify_state(str(tmp_path / "s.npz"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corruption_raises_in_both_packages(tmp_path, seed):
    tree = {"w": np.random.RandomState(seed).randn(64, 64).astype(
        np.float32), "b": np.zeros(8, np.float32), "it": 3}
    jp, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jser.save_state(jp, tree)
    tser.save_state(pp, tree)
    shutil.copy(pp, pp + ".twin")
    # the port's corrupt_file flips the bytes the JAX package's does
    assert corrupt_file(pp, seed=seed) \
        == jax_corrupt_file(pp + ".twin", seed=seed)
    assert Path(pp).read_bytes() == Path(pp + ".twin").read_bytes()
    jax_corrupt_file(jp, seed=seed)
    for fn in (jser.verify_state, jser.load_state):
        with pytest.raises(jser.SnapshotCorruptError):
            fn(jp)
        with pytest.raises(jser.SnapshotCorruptError):
            fn(pp)                    # the JAX reader on the port's file
    for fn in (tser.verify_state, tser.load_state):
        with pytest.raises(tser.SnapshotCorruptError):
            fn(pp)


def test_torn_and_missing_files(tmp_path):
    p = tmp_path / "s.npz"
    tser.save_state(str(p), {"w": np.ones(1000, np.float32)})
    p.write_bytes(p.read_bytes()[:300])           # truncated
    with pytest.raises(tser.SnapshotCorruptError):
        tser.verify_state(str(p))
    with pytest.raises(FileNotFoundError):
        tser.load_state(str(tmp_path / "gone.npz"))


def test_jax_file_is_refused_as_foreign(tmp_path):
    p = str(tmp_path / "jax.npz")
    jser.save_state(p, {"w": np.ones(3, np.float32)}, topology=TOPOLOGY)
    for fn in (tser.verify_state, tser.load_state, tser.read_topology):
        with pytest.raises(tser.ForeignSnapshotError, match="JAX package"):
            fn(p)
    assert issubclass(tser.ForeignSnapshotError, tser.SnapshotCorruptError)


# --------------------------------------------------------------------- #
# the optimizer state as a tree
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("opt", ["adamw", "sgd_momentum"])
def test_optimizer_state_round_trip_is_bitwise(tmp_path, opt):
    make = {"adamw": lambda: training.adamw(1e-2),
            "sgd_momentum": lambda: training.sgd(0.1, momentum=0.9)}[opt]
    g = torch.Generator().manual_seed(1)
    grads = [{"a": torch.randn(3, generator=g),
              "b": torch.randn(2, 2, generator=g)} for _ in range(4)]
    o = make()
    p = {"a": torch.zeros(3), "b": torch.ones(2, 2)}
    st = o.init(p)
    for gr in grads[:2]:
        o.update({k: v.clone() for k, v in gr.items()}, st, p)
    tser.save_state(str(tmp_path / "o.npz"), {
        "params": p, "opt": training.optimizer_state_tree(st)})
    loaded = tser.load_state(str(tmp_path / "o.npz"))
    p2 = {k: torch.as_tensor(v).clone() for k, v in loaded["params"].items()}
    st2 = o.init(p2)
    training.load_optimizer_state_tree(st2, loaded["opt"])
    for gr in grads[2:]:
        o.update({k: v.clone() for k, v in gr.items()}, st, p)
        o.update({k: v.clone() for k, v in gr.items()}, st2, p2)
    for k in p:
        assert torch.equal(p[k], p2[k])


# --------------------------------------------------------------------- #
# kill-and-resume equivalence (twin of test_resume_equivalence.py)
# --------------------------------------------------------------------- #

def _jax_loss(params, x, y):
    pred = x @ params["w"] + params["b"]
    return jnp.mean((pred - y) ** 2)


@pytest.fixture(scope="module")
def jax_curve(tmp_path_factory):
    """The JAX package's uninterrupted 6-epoch curve of the same job."""
    comm = jcmn.create_communicator("tpu_xla")
    it = jcmn.SerialIterator(linear_dataset(), batch_size=16, shuffle=True,
                             seed=5)
    opt = jcmn.create_multi_node_optimizer(optax.sgd(0.05), comm)
    up = jcmn.StandardUpdater(it, opt, _jax_loss,
                              {"w": jnp.zeros(4), "b": jnp.zeros(())}, comm)
    trainer = jcmn.Trainer(up, stop_trigger=(6, "epoch"),
                           out=str(tmp_path_factory.mktemp("jax")))
    log = JaxLogReport(trigger=(1, "epoch"))
    trainer.extend(log)
    trainer.run()
    return ([(e["iteration"], e["main/loss"]) for e in log.log],
            np.asarray(up.params["w"]))


@pytest.fixture(scope="module")
def port_reference(tmp_path_factory):
    """The port's uninterrupted run of the same job."""
    t, up, _, log = linear_job(LoopbackCommunicator(device="cpu"),
                               tmp_path_factory.mktemp("ref"))
    t.run()
    return ([(e["iteration"], e["main/loss"]) for e in log.log],
            up.params["w"].clone(), up.params["b"].clone())


@pytest.mark.parametrize("async_write", [False, True],
                         ids=["sync", "async"])
def test_interrupted_equals_uninterrupted(comm, tmp_path, async_write,
                                          port_reference, jax_curve):
    ref_curve, ref_w, ref_b = port_reference
    t1, up1, cp1, _ = linear_job(comm, tmp_path, async_write=async_write)
    t1._stop_period = 2.5          # stops at iteration 10; last save 9
    t1.run()
    assert up1.iteration == 10
    t2, up2, cp2, log2 = linear_job(comm, tmp_path)
    assert cp2.maybe_load(up2, t2) == 9
    assert up2.iteration == 9 and 2.0 < up2.epoch_detail < 3.0
    t2.run()
    got = [(e["iteration"], e["main/loss"]) for e in log2.log]
    assert got == ref_curve                      # bitwise
    assert torch.equal(up2.params["w"], ref_w)
    assert torch.equal(up2.params["b"], ref_b)
    # and the JAX package's curve to its own test's tolerance
    want, want_w = jax_curve
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(up2.params["w"].detach().numpy(), want_w,
                               rtol=1e-6,
                               atol=1e-7)


def test_resume_at_aligned_epoch_trigger(comm, tmp_path, port_reference):
    """Checkpoint and LogReport on the same tick: the checkpointer runs
    after the log flushes, so no epoch entry is lost."""
    t1, _, _, _ = linear_job(comm, tmp_path, ckpt_every=4)
    t1._stop_period = 2.0
    t1.run()
    t2, up2, cp2, log2 = linear_job(comm, tmp_path, ckpt_every=4)
    assert cp2.maybe_load(up2, t2) == 8
    assert [e["iteration"] for e in log2.log] == [4, 8]
    t2.run()
    assert [(e["iteration"], e["main/loss"]) for e in log2.log] \
        == port_reference[0]


def test_resize_mismatch_skips_iterator_restore(comm, tmp_path):
    t, up, _, _ = linear_job(comm, tmp_path)
    state = collect_train_state(up, t)
    t2, up2, _, _ = linear_job(comm, tmp_path / "resized",
                               data=linear_dataset(32))
    before = up2.iterator.state_dict()
    restore_train_state(state, up2, t2)
    after = up2.iterator.state_dict()
    assert len(after["order"]) == 32
    np.testing.assert_array_equal(after["order"], before["order"])


def test_orphan_file_gc(comm, tmp_path):
    t, _, _, _ = linear_job(comm, tmp_path)
    (tmp_path / "ckpt").mkdir()
    orphan = tmp_path / "ckpt" / "snapshot_iter_1.0"
    orphan.write_bytes(b"stale")
    t._stop_period = 1.0
    t.run()                       # the checkpointer fires at iteration 3
    assert not orphan.exists()
    assert os.listdir(tmp_path / "ckpt") == ["snapshot_iter_3.0"]


# --------------------------------------------------------------------- #
# the async path (twins of test_extensions.py)
# --------------------------------------------------------------------- #

def test_async_snapshot_isolated_from_inplace_mutation(comm, tmp_path):
    cp = create_multi_node_checkpointer(comm, str(tmp_path),
                                        async_write=True)
    up = FakeUpdater(comm, 1.0, 8)
    cp.save(up)
    with torch.no_grad():
        up.params["w"].mul_(999.0)                # in place, after save
    cp.finalize()
    fresh = FakeUpdater(comm)
    assert create_multi_node_checkpointer(
        comm, str(tmp_path)).maybe_load(fresh) == 8
    assert fresh.params["w"].tolist() == [1.0, 1.0, 1.0]


def test_async_gc_and_resume_join(comm, tmp_path):
    cp = create_multi_node_checkpointer(comm, str(tmp_path),
                                        async_write=True)
    for it in (10, 20, 30):
        cp.save(FakeUpdater(comm, it, it))
    fresh = FakeUpdater(comm)
    assert cp.maybe_load(fresh) == 30          # joins the pending write
    assert fresh.params["w"].tolist() == [30.0] * 3
    cp.finalize()
    assert os.listdir(tmp_path) == ["snapshot_iter_30.0"]


def test_async_write_error_surfaces(comm, tmp_path):
    blocked = tmp_path / "blocked"
    blocked.write_text("a file where the directory should be")
    cp = create_multi_node_checkpointer(comm, str(blocked / "ckpt"),
                                        async_write=True)
    cp.save(FakeUpdater(comm, 1, 1))
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        cp.finalize()


def test_multi_node_snapshot_round_trip(comm, tmp_path):
    t, up, _, log = linear_job(comm, tmp_path, ckpt_every=None)
    t.extend(multi_node_snapshot(comm), trigger=(5, "iteration"))
    t._stop_period = 1.5                           # iteration 6
    t.run()
    t2, up2, _, log2 = linear_job(comm, tmp_path / "b", ckpt_every=None)
    assert load_snapshot(up2, str(tmp_path / "out" / "snapshot_iter_5"),
                         t2) == 5
    assert up2.iterator.state_dict()["pos"] == 80 % 64


# --------------------------------------------------------------------- #
# what is not ported raises, naming its ROADMAP item
# --------------------------------------------------------------------- #

def _unported():
    from chainermn_tpu_torch.training import elastic

    c = LoopbackCommunicator(device="cpu")
    return {
        "plan_serving": (lambda: FaultPlan(serve_raise_at_round=1), 12),
        "plan_fleet": (lambda: FaultPlan(fleet_kill_at_step=1), 12),
        "attach_engine": (
            lambda: FaultInjector(FaultPlan()).attach_engine(None), 12),
        # ported (test_torch_zero.py): the ZeRO-1 signature
        "zero1_signature": (lambda: elastic.topology_signature(
            c, zero1=True), None),
    }


@pytest.mark.parametrize("name", sorted(_unported()))
def test_unported_options_raise(name):
    call, item = _unported()[name]
    if item is None:
        assert call() == dict(TOPOLOGY, zero1=True, sharding="zero1")
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue A item {item}"):
        call()


def test_elastic_resume_onto_changed_topology_raises(comm, tmp_path):
    """A set saved at world 2 (a replicated optimizer): the default
    checkpointer refuses it, an ``elastic=True`` one re-lays it (the
    replicated state passes through) from rank 0's file."""
    up = FakeUpdater(comm, 1, 4)
    tser.save_state(str(tmp_path / "snapshot_iter_4.0"),
                    {"iteration": 4, "world_size": 2, "params": up.params,
                     "opt_state": training.optimizer_state_tree(
                         up.opt_state)},
                    topology=dict(TOPOLOGY, world_size=2, inter_size=2))
    with pytest.raises(RuntimeError, match="same world size"):
        create_multi_node_checkpointer(comm, str(tmp_path)).maybe_load(up)
    fresh = FakeUpdater(comm, 0, 0)
    cp = create_multi_node_checkpointer(comm, str(tmp_path), elastic=True)
    assert cp.maybe_load(fresh) == 4
    assert cp.last_resume_mode == "relayout"
    assert torch.equal(fresh.params["w"], up.params["w"])


# --------------------------------------------------------------------- #
# a real SIGKILL in a child process (twin of test_fault_injection.py)
# --------------------------------------------------------------------- #

def _phase(phase, workdir, plan):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, str(WORKER), phase, str(workdir), plan.to_json()],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)


def test_sigkill_then_resume_is_bitwise(tmp_path, port_reference):
    ref_curve, ref_w, ref_b = port_reference
    ref_losses = [v for _, v in ref_curve]
    kill = tmp_path / "kill"
    proc = _phase("train", kill, FaultPlan(kill_at_iteration=10))
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert "PHASE_OK" not in proc.stdout
    assert sorted(os.listdir(kill / "ckpt")) == [
        "snapshot_iter_6.0", "snapshot_iter_9.0"]
    # the corrupted-newest drill resumes a copy of the same directory
    bad = tmp_path / "bad"
    shutil.copytree(kill, bad)

    out = _phase("resume", kill, FaultPlan())
    assert out.returncode == 0, out.stderr
    assert "RESUMED_AT 9" in out.stdout
    got = tser.load_state(str(kill / "resume.npz"))
    assert int(got["iteration"]) == 24
    assert torch.equal(torch.as_tensor(got["params"]["w"]), ref_w)
    assert torch.equal(torch.as_tensor(got["params"]["b"]), ref_b)
    assert got["log_losses"].tolist() == ref_losses

    corrupt_file(str(bad / "ckpt" / "snapshot_iter_9.0"), seed=4)
    c = LoopbackCommunicator(device="cpu")
    t, up, cp, log = linear_job(c, bad, history=2)
    assert cp.maybe_load(up, t) == 6
    assert (bad / "ckpt" / "snapshot_iter_9.0.corrupt").exists()
    t.run()
    assert torch.equal(up.params["w"], ref_w)
    assert [e["main/loss"] for e in log.log] == ref_losses
