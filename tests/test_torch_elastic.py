"""Resume at another world size in the port against the JAX package's
(the counterparts of ``tests/extension_tests/test_elastic_checkpoint.py``,
``test_shard_only_checkpoint.py`` and the ``fsdp`` round trip of
``tests/parallel_tests/test_sharded_state.py``).

Units on the host: the port's ``relayout_state`` on the JAX test's
states, bitwise a from-scratch sharding and bitwise the JAX function's
result on the same arrays; its refusals with the JAX messages; the
shard-only part format (parts bitwise the JAX package's cut of the same
world-stacked state, a covering set assembled bitwise, a rank's own
rows cutting the same part, v1 records for ZeRO-1/2, v2 with ``fsdp``
leaves).

Drills in gloo worlds of 4, 2 and 4 processes and in this process at 1
(``battery_elastic_save``/``battery_elastic_resume`` in
``test_torch_world.py``; a ZeRO-1 ``adam`` job whose leaves do not
divide over the worlds): ``FaultPlan(resize_at_iteration=2,
resize_to=2)`` saves a full and a shard-only set at world 4 and stops;
resumed at 2 and at 1, every rank's optimizer state is bitwise row
``r`` of the JAX ``relayout_state`` of the stacked saved rows (and of
the from-scratch sharding); the shard-only resume is bitwise the full
one; a same-topology resume takes the exact path bitwise; a default
checkpointer refuses the change; a set saved at 2 resumes at 4 the
same way.
"""

import concurrent.futures
import os
import types

import jax
import numpy as np
import pytest
import torch

from chainermn_tpu.parallel import sharded_state as jss
from chainermn_tpu.training.elastic import RelayoutError as JaxRelayoutError
from chainermn_tpu.training.elastic import relayout_state as jax_relayout
from chainermn_tpu.utils import serialization as jser
from chainermn_tpu_torch.communicators import LoopbackCommunicator
from chainermn_tpu_torch.parallel import ShardedState
from chainermn_tpu_torch.parallel.fsdp import fsdp_shard
from chainermn_tpu_torch.training import elastic
from chainermn_tpu_torch.training.elastic import (
    RelayoutError,
    rank_state_row,
    relayout_state,
    same_topology,
    stack_rank_states,
)
from chainermn_tpu_torch.utils import serialization as tser

from test_torch_world import elastic_job, run_world


# --------------------------------------------------------------------- #
# relayout_state on the host (the JAX TestRelayoutUnit)
# --------------------------------------------------------------------- #

def _layouts():
    # the flattened order is the dict's sorted keys: count (stack), lr
    # (rep), mu (shard)
    return [{"kind": "stack"}, {"kind": "rep"},
            {"kind": "shard", "size": 10}]


def _state(world):
    s = -(-10 // world)
    flat = np.zeros(world * s, np.float32)
    flat[:10] = np.arange(10, dtype=np.float32) + 1
    return {"mu": flat.reshape(world, s),
            "count": np.full((world,), 7, np.int32),
            "lr": np.float32(0.5)}


@pytest.mark.parametrize("src,dst", [(8, 4), (8, 2), (2, 8), (4, 3),
                                     (3, 4), (8, 8)])
def test_roundtrip_matches_from_scratch_and_jax(src, dst):
    topo_s = {"zero1": True, "world_size": src, "opt_leaves": _layouts()}
    topo_d = {"zero1": True, "world_size": dst}
    state = {"opt_state": _state(src)}
    out = relayout_state(state, topo_s, topo_d)
    want = jax_relayout(state, topo_s, topo_d)
    expect = _state(dst)
    for k in ("mu", "count", "lr"):
        got = np.asarray(out["opt_state"][k])
        np.testing.assert_array_equal(got, expect[k])
        assert got.dtype == np.asarray(expect[k]).dtype
        assert got.tobytes() == np.asarray(want["opt_state"][k]).tobytes()


def test_unidentified_differing_stack_refuses():
    topo_s = {"zero1": True, "world_size": 4,
              "opt_leaves": [{"kind": "stack"}]}
    bad = {"opt_state": {"x": np.arange(4, dtype=np.float32)}}
    with pytest.raises(RelayoutError, match="rows differ"):
        relayout_state(bad, topo_s, {"zero1": True, "world_size": 2})


def test_mode_and_leaf_count_changes_refuse():
    with pytest.raises(RelayoutError, match="zero1"):
        relayout_state({}, {"zero1": True, "world_size": 8,
                            "opt_leaves": []},
                       {"zero1": False, "world_size": 4})
    topo_s = {"zero1": True, "world_size": 4,
              "opt_leaves": [{"kind": "rep"}]}
    state = {"opt_state": {"a": np.zeros(2), "b": np.zeros(2)}}
    with pytest.raises(RelayoutError, match="leaves"):
        relayout_state(state, topo_s, {"zero1": True, "world_size": 2})
    with pytest.raises(RelayoutError, match="per-leaf layout"):
        relayout_state(state, {"zero1": True, "world_size": 4},
                       {"zero1": True, "world_size": 2})


@pytest.mark.parametrize("spec,leaf", [
    ({"kind": "shard", "size": 3}, np.zeros(3, np.float32)),
    ({"kind": "shard", "size": 30}, np.zeros((2, 3), np.float32)),
    ({"kind": "mystery"}, np.zeros(3, np.float32)),
    ({"kind": "fsdp", "dim": 0, "len": 8}, np.zeros((4, 2), np.float32)),
])
def test_refusals_name_the_leaf_path_as_jax_does(spec, leaf):
    state = {"opt_state": {"mu": {"w1": leaf}}}
    topo_s = {"zero1": True, "world_size": 2, "opt_leaves": [spec]}
    topo_d = {"zero1": True, "world_size": 4}
    with pytest.raises(JaxRelayoutError) as want:
        jax_relayout(state, topo_s, topo_d)
    with pytest.raises(RelayoutError) as got:
        relayout_state(state, topo_s, topo_d)
    assert str(got.value) == str(want.value)
    assert "opt_state['mu']['w1']" in str(got.value)


def test_same_topology_comparisons():
    a = {"format": 1, "world_size": 8, "inter_size": 8,
         "axis_names": None, "mesh_shape": None, "zero1": True}
    assert same_topology(a, dict(a))
    assert not same_topology(a, dict(a, world_size=4))
    assert not same_topology(a, dict(a, zero1=False))
    assert not same_topology(a, None) and not same_topology(None, a)


def test_relayout_drops_the_exchange_plan_and_keeps_the_input():
    state = {"params": {"w": np.ones(3)},
             "train_state": {"exchange_plan": {"b": 1},
                             "updater": {"epoch_detail": 1.0}}}
    out = relayout_state(state, {"world_size": 8}, {"world_size": 4})
    assert "exchange_plan" not in out["train_state"]
    assert out["train_state"]["updater"] == {"epoch_detail": 1.0}
    assert "exchange_plan" in state["train_state"]
    assert out["params"] is state["params"]


def test_bf16_tensor_leaves_relay_by_their_bits():
    mu = torch.arange(10, dtype=torch.float32).to(torch.bfloat16)
    stacked = torch.cat([mu, torch.zeros(2, dtype=torch.bfloat16)]) \
        .reshape(4, 3)
    topo = {"zero1": True, "world_size": 4,
            "opt_leaves": [{"kind": "shard", "size": 10}]}
    out = relayout_state({"opt_state": {"mu": stacked}}, topo,
                         {"zero1": True, "world_size": 3})["opt_state"]
    assert out["mu"].dtype == torch.bfloat16 and out["mu"].shape == (3, 4)
    assert torch.equal(out["mu"].reshape(-1)[:10], mu)
    assert not out["mu"].reshape(-1)[10:].any()


def test_rank_rows_stack_and_split():
    rows = [{"count": np.int32(3), "mu": np.full(4, r, np.float32),
             "lr": np.float32(0.1)} for r in range(3)]
    recs = [{"kind": "stack"}, {"kind": "rep"},
            {"kind": "shard", "size": 11}]
    stacked = stack_rank_states(rows, recs)
    assert stacked["mu"].shape == (3, 4) and stacked["count"].shape == (3,)
    for r in range(3):
        back = rank_state_row(stacked, recs, r)
        for k in rows[r]:
            np.testing.assert_array_equal(back[k], rows[r][k])


def test_live_resize_still_raises():
    for call in (elastic.ElasticMembership, elastic.ResizeController,
                 elastic.MembershipRecord, elastic.post_resize_intent):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue A item 11"):
            call()


# --------------------------------------------------------------------- #
# the shard-only part format
# --------------------------------------------------------------------- #

def _stacked_zero_state(world=4):
    """A world-stacked ZeRO-1 state (shard, stack and rep leaves) with
    its replicated entries, and its topology."""
    rng = np.random.RandomState(0)
    recs = [{"kind": "stack"}, {"kind": "rep"},
            {"kind": "shard", "size": 10}, {"kind": "shard", "size": 7}]
    state = {
        "iteration": 5, "world_size": world,
        "params": {"w": rng.randn(10).astype(np.float32)},
        "opt_state": {
            "count": np.full((world,), 5, np.int32),
            "lr": np.float32(0.1),
            "mu": rng.randn(world, 3).astype(np.float32),
            "nu": rng.randn(world, 2).astype(np.float32)},
        "train_state": {"updater": {"epoch_detail": 0.5}}}
    topo = {"format": 1, "world_size": world, "inter_size": world,
            "axis_names": None, "mesh_shape": None, "zero1": True,
            "sharding": "zero1", "opt_leaves": recs}
    return state, topo


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_parts_are_the_jax_cut_and_assemble_bitwise(tmp_path):
    state, topo = _stacked_zero_state()
    parts = []
    for lo, hi in ((0, 1), (1, 3), (3, 4)):
        part, rec = tser.build_shard_part(state, topo, lo, hi,
                                          root=lo == 0)
        jpart, jrec = jser.build_shard_part(state, topo, lo, hi,
                                            root=lo == 0)
        assert rec == jrec and rec["format"] == 1     # ZeRO-1 keeps v1
        _leaves_equal(part, jpart)
        path = str(tmp_path / f"p{lo}")
        tser.save_state(path, part, topology=topo, shard_part=rec)
        assert tser.read_shard_part(path) == rec
        tree, got_topo, sp = tser.load_state_with_stamps(path)
        assert got_topo == topo and sp == rec
        parts.append((sp, tree))
    _leaves_equal(tser.assemble_shard_state(parts[::-1]), state)
    # a rank's own rows cut the same part as the stacked state
    own = dict(state, opt_state=dict(
        state["opt_state"], mu=state["opt_state"]["mu"][1:2],
        nu=state["opt_state"]["nu"][1:2]))
    _leaves_equal(tser.build_shard_part(own, topo, 1, 2, root=False)[0],
                  tser.build_shard_part(state, topo, 1, 2, root=False)[0])


def test_sets_that_do_not_cover_refuse():
    state, topo = _stacked_zero_state()
    p0 = tser.build_shard_part(state, topo, 0, 2, root=True)
    p2 = tser.build_shard_part(state, topo, 2, 4, root=False)
    p1 = tser.build_shard_part(state, topo, 1, 3, root=False)
    two = tser.build_shard_part(state, topo, 2, 4, root=True)
    for parts, match in (([], "no shard parts"),
                         ([p0[::-1]], "incomplete"),
                         ([p0[::-1], p1[::-1]], "tile"),
                         ([p0[::-1], two[::-1]], "one root")):
        with pytest.raises(tser.ShardSetError, match=match):
            tser.assemble_shard_state(parts)
    _, topo2 = _stacked_zero_state(2)
    with pytest.raises(tser.ShardSetError, match="disagree"):
        tser.assemble_shard_state([p0[::-1], p2[::-1],
                                   (dict(p2[1], world=2), p2[0])])
    with pytest.raises(ValueError, match="member range"):
        tser.build_shard_part(state, topo2, 1, 3, root=False)


def test_fsdp_round_trip_and_resume_at_smaller_world():
    """The ``fsdp`` kind: ZeRO-3 parameters and moments of the port's
    ``ShardedState`` table cut into a v2 set at world 4 and assembled
    bitwise, the cut the JAX package's; re-laid onto world 2 (a
    pass-through of the full-width leaves) and placed there, each
    member's slice is bitwise a fresh sharding at 2."""
    rng = np.random.RandomState(0)
    full = {"b1": rng.randn(16).astype(np.float32),
            "w1": rng.randn(8, 16).astype(np.float32),
            "w2": rng.randn(16, 4).astype(np.float32)}
    stub = types.SimpleNamespace(size=4, rank=0)
    ss = ShardedState({k: torch.tensor(v) for k, v in full.items()}, stub)
    mom = {k: rng.randn(*v.shape).astype(np.float32)
           for k, v in full.items()}
    opt_full = {"count": np.int32(2), "mu": mom, "nu": mom}
    table = ss.layouts({"count": np.int32(2),
                        "mu": {k: torch.empty(v.shape) for k, v in
                               full.items()},
                        "nu": {k: torch.empty(v.shape) for k, v in
                               full.items()}})
    topo4 = elastic.topology_signature(
        LoopbackCommunicator(device="cpu"), sharding="zero3", layouts=table)
    topo4 = dict(topo4, world_size=4, inter_size=4)
    assert any(r["kind"] == "fsdp" for r in topo4["param_leaves"])
    state = {"params": full, "opt_state": opt_full}
    parts = []
    for lo, hi, root in ((0, 2, True), (2, 4, False)):
        part, rec = tser.build_shard_part(state, topo4, lo, hi, root=root)
        jpart, jrec = jser.build_shard_part(state, topo4, lo, hi,
                                            root=root)
        assert rec == jrec and rec["format"] == tser.SHARD_PART_FORMAT == 2
        assert rec["fsdp_param_leaves"]
        _leaves_equal(part, jpart)
        parts.append((rec, part))
    assembled = tser.assemble_shard_state(parts)
    _leaves_equal(assembled, state)
    topo2 = dict(topo4, world_size=2, inter_size=2)
    relaid = relayout_state(assembled, topo4, topo2)
    _leaves_equal(relaid, jax_relayout(assembled, topo4, topo2))
    ss2 = ShardedState({k: torch.tensor(v) for k, v in full.items()},
                       types.SimpleNamespace(size=2, rank=0))
    for m in range(2):
        placed = fsdp_shard({k: torch.tensor(v) for k, v in
                             relaid["params"].items()}, ss2.dims, m, 2)
        fresh = fsdp_shard({k: torch.tensor(v) for k, v in full.items()},
                           ss2.dims, m, 2)
        for k in full:
            assert torch.equal(placed[k], fresh[k])


# --------------------------------------------------------------------- #
# the drills: worlds of 4, 2, 1 and the grow 2 -> 4
# --------------------------------------------------------------------- #

AT, TO = 2, 2


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    base = tmp_path_factory.mktemp("elastic_worlds")
    pool = concurrent.futures.ThreadPoolExecutor(1)

    def run():
        saved = run_world(base, 4, "battery_elastic_save",
                          dict(root=str(root), at=AT, to=TO))
        at2 = run_world(base, 2, "battery_elastic_resume",
                        dict(root=str(root), sets=["full", "shard"],
                             save_to=str(root / "grow")))
        grown = run_world(base / "g", 4, "battery_elastic_resume",
                          dict(root=str(root), sets=["grow"]))
        return saved, at2, grown

    fut = pool.submit(run)
    saved, at2, grown = fut.result()
    pool.shutdown(wait=True)
    # world 1, in this process
    at1 = {}
    for name in ("full", "shard"):
        _, up, cp = elastic_job(LoopbackCommunicator(device="cpu"),
                                root / name)
        at1[name] = dict(at=cp.maybe_load(up), mode=cp.last_resume_mode,
                         opt=_np_opt(up))
    return dict(root=root, saved=saved, at2=at2, at1=at1, grown=grown)


def _np_opt(up):
    from chainermn_tpu_torch import training
    from test_torch_world import np_tree

    return np_tree(training.optimizer_state_tree(up.opt_state))


def _saved_rows(ckpt, it, world):
    """Every rank's saved optimizer tree (read with the port's loader:
    the JAX package reads only its own files), stacked in numpy per the
    stamped records, and the stamp."""
    trees = [tser.load_state_with_topology(
        os.path.join(ckpt, f"snapshot_iter_{it}.{r}")) for r in range(world)]
    topo = trees[0][1]
    flat = [tser.tree_flatten(t["opt_state"])[0] for t, _ in trees]
    leaves, treedef = tser.tree_flatten(trees[0][0]["opt_state"])
    stacked = tser.tree_unflatten(treedef, [
        np.stack([np.asarray(f[i]) for f in flat])
        for i in range(len(leaves))])
    return stacked, topo


def _expected_row(stacked, topo, world, rank):
    """Row ``rank`` of the JAX ``relayout_state`` of the stack, checked
    against the from-scratch sharding of the gathered state."""
    new = dict(topo, world_size=world, inter_size=world)
    relaid = jax_relayout({"opt_state": stacked}, topo, new)["opt_state"]
    recs = topo["opt_leaves"]
    scratch = jss.shard_state_leaves(
        jss.gather_state_leaves(stacked, recs), recs, world)
    _leaves_equal(relaid, scratch)
    return jax.tree.map(lambda a: np.asarray(a)[rank], relaid)


def _assert_row(got_opt, want_row):
    g = tser.tree_flatten(got_opt)[0]
    w = jax.tree.leaves(want_row)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = np.asarray(a)
        assert a.shape == b.shape and a.tobytes() == b.astype(
            a.dtype).tobytes()


def test_drill_saves_at_4_and_stops(drills):
    for res in drills["saved"]:
        for name in ("full", "shard"):
            assert res[name]["fired"] == [("resize", AT, TO)]
            assert res[name]["saved"]["iteration"] == AT
    files = sorted(os.listdir(drills["root"] / "shard" / "ckpt"))
    assert files == [f"snapshot_iter_{AT}.s{m}of4" for m in range(4)]
    assert sorted(os.listdir(drills["root"] / "full" / "ckpt")) == [
        f"snapshot_iter_{AT}.{r}" for r in range(4)]


def test_same_topology_resume_stays_exact(drills):
    for res in drills["saved"]:
        for name in ("full", "shard"):
            r = res[name]
            assert r["resumed_at"] == AT and r["mode"] == "exact"
            _leaves_equal(r["again"]["opt"], r["saved"]["opt"])
            _leaves_equal(r["again"]["params"], r["saved"]["params"])


@pytest.mark.parametrize("world", [2, 1])
def test_resume_at_smaller_world_is_the_jax_relayout_row(drills, world):
    stacked, topo = _saved_rows(drills["root"] / "full" / "ckpt", AT, 4)
    ranks = drills["at2"] if world == 2 else [drills["at1"]]
    for r, res in enumerate(ranks):
        want = _expected_row(stacked, topo, world, r)
        for name in ("full", "shard"):
            got = res[name]
            assert got["at"] == AT and got["mode"] == "relayout"
            opt = got["state"]["opt"] if world == 2 else got["opt"]
            _assert_row(opt, want)
    # the replicated parameters are the saved ones
    for res in drills["at2"]:
        _leaves_equal(res["full"]["state"]["params"],
                      drills["saved"][0]["full"]["saved"]["params"])
        # and the job goes on: one more update at world 2
        assert res["full"]["after"]["iteration"] == AT + 1


def test_non_elastic_checkpointer_refuses_the_change(drills):
    for res in drills["at2"]:
        assert "elastic=True" in res["refused"]
        assert "same world size" in res["refused"]


def test_grow_2_to_4_is_the_jax_relayout_row(drills):
    stacked, topo = _saved_rows(drills["root"] / "grow" / "ckpt", AT + 1,
                                2)
    assert topo["world_size"] == 2
    for r, res in enumerate(drills["grown"]):
        got = res["grow"]
        assert got["at"] == AT + 1 and got["mode"] == "relayout"
        _assert_row(got["state"]["opt"], _expected_row(stacked, topo, 4, r))


def test_shard_only_set_bytes_fall_with_the_world(drills):
    """A part holds one member's rows; only the root holds the
    replicated entries, where every full file holds them."""
    full = drills["root"] / "full" / "ckpt"
    shard = drills["root"] / "shard" / "ckpt"
    f_bytes = [os.path.getsize(full / f"snapshot_iter_{AT}.{r}")
               for r in range(4)]
    s_bytes = [os.path.getsize(shard / f"snapshot_iter_{AT}.s{m}of4")
               for m in range(4)]
    assert s_bytes[0] <= f_bytes[0] + 4096
    assert all(b < f_bytes[m] for m, b in enumerate(s_bytes) if m)
    assert sum(s_bytes) < sum(f_bytes)


# --------------------------------------------------------------------- #
# shard-only sets at world 1 (the JAX test_shard_only_checkpoint cases)
# --------------------------------------------------------------------- #

def _job(root, **kw):
    return elastic_job(LoopbackCommunicator(device="cpu"), root, **kw)


def _state_of(up):
    return _np_opt(up), {k: v.detach().numpy().copy()
                         for k, v in up.params.items()}


def test_async_shard_only_is_bitwise_a_sync_full_save(tmp_path):
    runs = {}
    for name, kw in (("full", {}),
                     ("shard", dict(shard_only=True))):
        _, up, cp = _job(tmp_path / name, **kw)
        cp.async_write = name == "shard"
        for _ in range(3):
            up.update()
        cp.save(up)
        cp.finalize()
        _, again, cp2 = _job(tmp_path / name, **kw)
        assert cp2.maybe_load(again) == 3
        runs[name] = _state_of(again)
    _leaves_equal(runs["shard"], runs["full"])
    assert os.listdir(tmp_path / "shard" / "ckpt") == [
        "snapshot_iter_3.s0of1"]


def test_partial_and_corrupt_sets_fall_back(tmp_path):
    _, up, cp = _job(tmp_path, shard_only=True, history=2)
    for it in (2, 4):
        while up.iteration < it:
            up.update()
        cp.save(up)
    ckpt = tmp_path / "ckpt"
    # a partial set of a world-2 job (member 0 missing) never looks
    # complete
    (ckpt / "snapshot_iter_6.s1of2").write_bytes(b"x")
    _, got, cp2 = _job(tmp_path, shard_only=True)
    assert cp2.maybe_load(got) == 4
    # a damaged part of the newest set is quarantined; resume falls back
    from chainermn_tpu_torch.testing import corrupt_file

    corrupt_file(str(ckpt / "snapshot_iter_4.s0of1"))
    _, got, cp3 = _job(tmp_path, shard_only=True)
    assert cp3.maybe_load(got) == 2
    assert (ckpt / "snapshot_iter_4.s0of1.corrupt").exists()
    assert cp3._iteration_shards(2) == []          # parts are not files


def test_full_and_shard_sets_interoperate(tmp_path):
    _, up, full = _job(tmp_path, history=2)
    up.update()
    up.update()
    full.save(up)
    want = _state_of(up)
    up.update()
    up.update()
    _, _, shard = _job(tmp_path, shard_only=True, history=2)
    shard.save(up)
    _, got, cp = _job(tmp_path)
    assert cp.maybe_load(got) == 4 and cp.last_resume_mode == "exact"
    _leaves_equal(_state_of(got), _state_of(up))
    for fn in os.listdir(tmp_path / "ckpt"):
        if ".s0of1" in fn:
            os.remove(tmp_path / "ckpt" / fn)
    _, got, cp = _job(tmp_path, shard_only=True)
    assert cp.maybe_load(got) == 2
    _leaves_equal(_state_of(got), want)


def test_streaming_set_neither_counts_nor_evicts_nor_resumes(tmp_path):
    import threading

    _, up, cp = _job(tmp_path, shard_only=True, history=2)
    cp.async_write = True
    gate = threading.Event()
    real = cp._write_part

    def stalled(path, tree, topology, shard_part=None):
        gate.wait(timeout=30)
        real(path, tree, topology, shard_part)

    cp._write_part = stalled
    up.update()
    gate.set()
    cp.save(up)                      # set 1 completes
    cp._join_pending(barrier_and_gc=True)
    gate.clear()
    up.update()
    up.update()
    cp.save(up)                      # set 3: the writer stalls
    try:
        assert 3 in cp._streaming and 3 not in cp._local_iterations()
        common, streaming = cp._agreed_inventory()
        assert 3 in streaming and 3 not in common
        cp._cleanup(keep=3)
        assert (tmp_path / "ckpt" / "snapshot_iter_1.s0of1").exists()
        _, got, cp2 = _job(tmp_path, shard_only=True)
        assert cp2.maybe_load(got) == 1
    finally:
        gate.set()
    cp.finalize()
    assert 3 not in cp._streaming and 3 in cp._local_iterations()
    up.update()
    cp.save(up)
    cp.finalize()
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "snapshot_iter_3.s0of1", "snapshot_iter_4.s0of1"]
