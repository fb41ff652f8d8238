"""The port's communicator against the JAX package's, at N = 2 and 4.

The port runs an N-process gloo world (``test_torch_world.run_world``,
one world per N for the whole module); the JAX package runs its
``tpu_xla`` communicator over N devices of the 8-device virtual CPU
mesh.  Rank ``r``'s tensor is the JAX world-stacked array's ``[r]``,
and rank ``r``'s result must equal the JAX result's ``[r]``: exactly for
data movement and integer sums, to 1e-6 for float sums (gloo and XLA
add in different orders).  The differentiable collectives' gradients
(the sum over ranks of ``sum(f(x) * w)``) are held against ``jax.grad``
through ``chainermn_tpu.ops.collectives`` inside ``shard_map`` to 1e-5.
The object collectives have no world-stacked JAX counterpart (one JAX
process holds every device), so they are held to ChainerMN's contract,
``allreduce_obj`` through the JAX package's own ``_tree_reduce``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu import create_communicator as jax_create_communicator
from chainermn_tpu.communicators.tpu_xla import _tree_reduce
from chainermn_tpu.ops import collectives as JC
from chainermn_tpu_torch import communicators as port
from chainermn_tpu_torch.ops import fused
from test_torch_world import run_world

SIZES = (2, 4)


def _inputs(n):
    rng = np.random.RandomState(100 + n)

    def f(*shape):
        return rng.randn(*shape).astype(np.float32)

    return dict(x=f(n, 3, 4), xi=rng.randint(-1000, 1000, (n, 3)).astype(
        np.int32), sq=f(n, n, 3), w=f(n, 3, 4), wg=f(n, n, 3, 4),
        wgt=f(n, 3, 4 * n), wrs=f(n, 1, 3), wa2a=f(n, n, 3), ws=f(n, 3))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comm")
    return {n: (_inputs(n), run_world(tmp, n, "battery_communicator",
                                      _inputs(n))) for n in SIZES}


def _jax_comm(n):
    return jax_create_communicator("tpu_xla", devices=jax.devices()[:n])


def _per_rank(got, key):
    return [g[key] for g in got]


def _close(port_values, want, exact=False):
    for r, v in enumerate(port_values):
        w = np.asarray(want[r])
        assert v.shape == w.shape, (r, v.shape, w.shape)
        if exact:
            np.testing.assert_array_equal(v, w)
        else:
            np.testing.assert_allclose(v, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_topology(worlds, n):
    _, got = worlds[n]
    assert [g["rank"] for g in got] == list(range(n))
    assert all(g["size"] == n and g["inter_size"] == 1
               and g["inter_rank"] == 0 for g in got)
    # one node: the intra rank is the rank (LOCAL_RANK under torchrun)
    assert [g["intra_rank"] for g in got] == list(range(n))


@pytest.mark.parametrize("n", SIZES)
def test_array_collectives_match_jax(worlds, n):
    p, got = worlds[n]
    jc = _jax_comm(n)
    _close(_per_rank(got, "bcast"), jc.bcast(p["x"], root=n - 1), True)
    for op in ("sum", "mean", "max", "min", "prod"):
        _close(_per_rank(got, f"allreduce_{op}"), jc.allreduce(p["x"], op),
               exact=op in ("max", "min"))
    _close(_per_rank(got, "allreduce_int_sum"), jc.allreduce(p["xi"]), True)
    mean = jc.allreduce(p["xi"], "mean")
    _close(_per_rank(got, "allreduce_int_mean"), mean)
    assert got[0]["allreduce_int_mean"].dtype == np.asarray(mean).dtype
    _close(_per_rank(got, "allgather"), jc.allgather(p["x"]), True)
    _close(_per_rank(got, "alltoall"), jc.alltoall(p["sq"]), True)
    _close(_per_rank(got, "gather"), jc.gather(p["x"], root=1), True)
    _close(_per_rank(got, "scatter"), jc.scatter(p["sq"], root=1), True)
    _close(_per_rank(got, "reduce_scatter"), jc.reduce_scatter(p["sq"]))
    _close(_per_rank(got, "send"), jc.send(p["x"], dest=0, source=n - 1),
           True)
    _close(_per_rank(got, "send_self"), jc.send(p["x"], dest=1, source=1),
           True)


@pytest.mark.parametrize("n", SIZES)
def test_object_collectives(worlds, n):
    _, got = worlds[n]
    objs = [{"rank": r, "v": [r, float(r) / 2]} for r in range(n)]
    for r, g in enumerate(got):
        assert g["bcast_obj"] == objs[1]
        assert g["gather_obj"] == (objs if r == 1 else None)
        assert g["allgather_obj"] == objs
        assert g["allreduce_obj_sum"] == _tree_reduce(
            [{"a": s, "b": [1.0, s]} for s in range(n)], "sum")
        assert g["allreduce_obj_mean"] == _tree_reduce(
            [{"a": float(s)} for s in range(n)], "mean")
        assert g["allreduce_obj_max"] == n - 1
        assert g["scatter_obj"] == f"to{r}"
        assert g["alltoall_obj"] == [("from", s, "to", r, "x" * (s * 7 + r))
                                     for s in range(n)]
    assert got[n - 1]["recv_obj"] == {"msg": "hello", "n": n}


@pytest.mark.parametrize("n", SIZES)
def test_no_fallback_across_devices(worlds, n):
    _, got = worlds[n]
    for g in got:
        assert "given to a communicator on cpu" in g["wrong_device"]
        assert "needs 'nccl'" in g["cuda_on_gloo"]


@pytest.mark.parametrize("n", SIZES)
def test_split_and_bcast_data(worlds, n):
    _, got = worlds[n]
    for r, g in enumerate(got):
        # MPI_Comm_split: color r % 2, key -r ranks the members backwards
        members = sorted((s for s in range(n) if s % 2 == r % 2),
                         key=lambda s: -s)
        assert g["split"] == dict(rank=members.index(r), size=len(members),
                                  sum=float(sum(members)), members=members)
        np.testing.assert_array_equal(g["bcast_data"]["w"],
                                      np.full((2, 3), n - 1.0, np.float32))
        np.testing.assert_array_equal(g["bcast_data"]["b"][0], [n - 1])


def _jax_grad(n, f, v, w):
    """Per-rank outputs of ``f`` and the gradient, w.r.t. the stacked
    ``v``, of the sum over ranks of ``sum(f(v[r]) * w[r])``."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("world",))

    def total(v):
        def local(v, w):
            y = f(v[0])
            return jnp.sum(y * w[0])[None], y[None]

        loss, y = jax.shard_map(local, mesh=mesh,
                                in_specs=(P("world"), P("world")),
                                out_specs=(P("world"), P("world")))(v, w)
        return loss.sum(), y

    (_, y), g = jax.jit(jax.value_and_grad(total, has_aux=True))(v)
    return np.asarray(y), np.asarray(g)


GRAD_CASES = {
    "psum": (lambda v: JC.psum(v, "world"), "x", "w"),
    "pmean": (lambda v: JC.pmean(v, "world"), "x", "w"),
    "allgather": (lambda v: JC.allgather(v, "world"), "x", "wg"),
    "allgather_tiled": (lambda v: JC.allgather(v, "world", axis=1,
                                               tiled=True), "x", "wgt"),
    "reduce_scatter": (lambda v: JC.reduce_scatter(v, "world"), "sq",
                       "wrs"),
    "alltoall": (lambda v: JC.alltoall(v, "world"), "sq", "wa2a"),
    "bcast": (lambda v: JC.bcast(v, "world", root=1), "x", "w"),
    "gather": (lambda v: JC.gather(v, "world", root=1), "x", "wg"),
    "scatter": (lambda v: JC.scatter(v, "world", root=1), "sq", "ws"),
}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_collective_gradients_match_jax_grad(worlds, n, name):
    p, got = worlds[n]
    f, v, w = GRAD_CASES[name]
    y, g = _jax_grad(n, f, jnp.asarray(p[v]), jnp.asarray(p[w]))
    for r in range(n):
        np.testing.assert_allclose(got[r][f"grad_{name}_y"], y[r],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[r][f"grad_{name}"], g[r],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", SIZES)
def test_alltoall_across_axes_matches_jax(worlds, n):
    # split on one axis, concatenate on another (jax.grad cannot
    # transpose this case, so the gradient test splits and concatenates
    # on one axis)
    p, got = worlds[n]
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("world",))
    want = jax.shard_map(lambda v: JC.alltoall(v[0], "world", 0, 1)[None],
                         mesh=mesh, in_specs=P("world"),
                         out_specs=P("world"))(jnp.asarray(p["sq"]))
    _close(_per_rank(got, "alltoall_01"), np.asarray(want), True)


def test_create_communicator_names_and_aliases():
    comm = port.create_communicator("loopback", device="cpu")
    assert isinstance(comm, port.LoopbackCommunicator)
    assert (comm.size, comm.rank, comm.inter_size) == (1, 0, 1)
    x = torch.arange(6.0).reshape(1, 2, 3)
    for got in (comm.bcast(x), comm.allreduce(x, "mean"), comm.alltoall(x)):
        torch.testing.assert_close(got, x)
    torch.testing.assert_close(comm.allgather(x), x[None])
    torch.testing.assert_close(comm.reduce_scatter(x), x[0])
    assert comm.alltoall_obj([{"a": 1}]) == [{"a": 1}]
    tree = {"g": torch.ones(3)}
    assert comm.multi_node_mean_grad(tree, torch.bfloat16) is tree
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        comm.multi_node_mean_grad(tree, plan="auto")
    with pytest.raises(ValueError, match="unknown communicator"):
        port.create_communicator("mpi", device="cpu")


def test_legacy_aliases_warn_and_map_to_tpu_xla(monkeypatch):
    seen = []

    def stop(device=None):       # tpu_xla resolves its device first
        seen.append(device)
        raise ValueError("sentinel")

    monkeypatch.setattr(port, "resolve_device", stop)
    for alias in sorted(port._LEGACY_ALIASES):
        with pytest.warns(UserWarning, match="legacy alias"), \
                pytest.raises(ValueError, match="sentinel"):
            port.create_communicator(alias, device="cpu")
    assert seen == ["cpu"] * len(port._LEGACY_ALIASES)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: port.create_communicator(),
                 lambda: port.create_communicator("loopback"),
                 lambda: port.init_distributed()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # with a card but no NCCL the port raises instead of taking gloo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        port.init_distributed(device="cuda")
    assert not torch.distributed.is_initialized()


def test_fused_budget_matches_jax():
    from chainermn_tpu.utils.comm_model import fused_collective_budget

    for total, bucket, groups in ((0, 1, 1), (1, 1, 1), (4097, 1024, 1),
                                  (10 ** 8, 4 << 20, 3), (15, 4, 2)):
        assert fused.fused_collective_budget(total, bucket, groups) == \
            fused_collective_budget(total, bucket, groups)
    with pytest.raises(ValueError, match="positive"):
        fused.fused_collective_budget(10, 0)
