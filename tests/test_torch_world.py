"""Gloo worlds of N processes for the port's communicator tests, and
what each rank of them runs.

:func:`run_world` spawns ``n`` processes that rendezvous through a
``FileStore`` under the test's ``tmp_path`` (never a fixed port, so the
xdist workers cannot collide), build
``create_communicator("tpu_xla", device="cpu")`` and run one battery
function of this module on the same numpy inputs; it returns every
rank's result.  A world that does not finish within its join timeout
is killed and fails the test, so a hang cannot use up the suite's
clock.  This module imports torch and the port only, never JAX, so the
spawned processes start quickly; the test files hold the JAX side.
"""

import multiprocessing
import pickle
import time
import traceback
from pathlib import Path

import pytest
import torch

JOIN_TIMEOUT_S = 240


def _child(rank, n, store, battery, payload_path, out_dir):
    import torch.distributed as dist

    from chainermn_tpu_torch.communicators import (
        create_communicator,
        init_distributed,
    )

    torch.set_num_threads(1)
    out = Path(out_dir) / f"{rank}.pkl"
    try:
        init_distributed(init_method=f"file://{store}", world_size=n,
                         rank=rank, device="cpu")
        comm = create_communicator("tpu_xla", device="cpu")
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        result = ("ok", globals()[battery](comm, payload))
    except BaseException:                      # reported to the parent
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def run_world(tmp_path, n, battery, payload, timeout=JOIN_TIMEOUT_S):
    """Every rank's result of ``battery(comm, payload)`` in an
    ``n``-process gloo world."""
    tmp_path = Path(tmp_path) / f"world-{battery}-{n}"
    tmp_path.mkdir(parents=True)
    payload_path = tmp_path / "payload.pkl"
    with open(payload_path, "wb") as f:
        pickle.dump(payload, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(r, n, str(tmp_path / "store"), battery,
                               str(payload_path), str(tmp_path)))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise AssertionError(f"{battery}: ranks {hung} of {n} did not "
                             f"finish within {timeout} s")
    results = []
    for r in range(n):
        with open(tmp_path / f"{r}.pkl", "rb") as f:
            kind, value = pickle.load(f)
        if kind != "ok":
            raise AssertionError(f"{battery}: rank {r} failed:\n{value}")
        results.append(value)
    return results


def np_tree(tree):
    """A tree of tensors as numpy (fp32 for bf16)."""
    import torch.utils._pytree as pytree

    return pytree.tree_map(
        lambda t: (t.detach().float() if t.dtype == torch.bfloat16
                   else t.detach()).numpy().copy()
        if torch.is_tensor(t) else t, tree)


# --------------------------------------------------------------------- #
# batteries (run on every rank)
# --------------------------------------------------------------------- #


def battery_smoke(comm, payload):
    return comm.rank, comm.size, comm.allreduce(
        torch.tensor([comm.rank + 1.0])).item()


def battery_hang(comm, payload):
    if comm.rank == 0:
        comm.barrier()                 # rank 1 does not arrive in time
    else:
        time.sleep(120)
    return None


def battery_communicator(comm, p):
    """Every array and object collective on this rank's slice of the
    world-stacked inputs, the differentiable collectives' gradients,
    ``split``, ``barrier`` and ``bcast_data``."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.ops import collectives as C

    r, n = comm.rank, comm.size
    x = torch.tensor(p["x"][r])               # (3, 4)
    xi = torch.tensor(p["xi"][r])             # int32
    sq = torch.tensor(p["sq"][r])             # (n, 3)
    out = {"rank": r, "size": n, "intra_rank": comm.intra_rank,
           "inter_rank": comm.inter_rank, "inter_size": comm.inter_size}
    out["bcast"] = comm.bcast(x, root=n - 1)
    for op in ("sum", "mean", "max", "min", "prod"):
        out[f"allreduce_{op}"] = comm.allreduce(x, op)
    out["allreduce_int_sum"] = comm.allreduce(xi, "sum")
    out["allreduce_int_mean"] = comm.allreduce(xi, "mean")
    out["allgather"] = comm.allgather(x)
    out["alltoall"] = comm.alltoall(sq)
    out["gather"] = comm.gather(x, root=1)
    out["scatter"] = comm.scatter(sq, root=1)
    out["reduce_scatter"] = comm.reduce_scatter(sq)
    out["send"] = comm.send(x, dest=0, source=n - 1)
    out["send_self"] = comm.send(x, dest=1, source=1)

    obj = {"rank": r, "v": [r, float(r) / 2]}
    out["bcast_obj"] = comm.bcast_obj(obj if r == 1 else None, root=1)
    out["gather_obj"] = comm.gather_obj(obj, root=1)
    out["allgather_obj"] = comm.allgather_obj(obj)
    out["allreduce_obj_sum"] = comm.allreduce_obj({"a": r, "b": [1.0, r]})
    out["allreduce_obj_mean"] = comm.allreduce_obj({"a": float(r)}, "mean")
    out["allreduce_obj_max"] = comm.allreduce_obj(r, "max")
    out["scatter_obj"] = comm.scatter_obj(
        [f"to{j}" for j in range(n)] if r == 0 else None, root=0)
    out["alltoall_obj"] = comm.alltoall_obj(
        [("from", r, "to", j, "x" * (r * 7 + j)) for j in range(n)])
    if r == 0:
        comm.send_obj({"msg": "hello", "n": n}, dest=n - 1)
    if r == n - 1:
        out["recv_obj"] = comm.recv_obj(source=0)
    comm.barrier()

    sub = comm.split(color=r % 2, key=-r)
    out["split"] = dict(rank=sub.rank, size=sub.size,
                        sum=sub.allreduce(torch.tensor([float(r)])).item(),
                        members=sub.allgather_obj(r))
    sub.barrier()

    # no fallback: a tensor elsewhere than the group's device, or a CUDA
    # communicator over a gloo world, raises
    try:
        comm.allreduce(torch.empty(2, device="meta"))
    except ValueError as e:
        out["wrong_device"] = str(e)
    available = torch.cuda.is_available
    torch.cuda.is_available = lambda: True
    try:
        create_communicator("tpu_xla", device="cuda")
    except RuntimeError as e:
        out["cuda_on_gloo"] = str(e)
    finally:
        torch.cuda.is_available = available

    tree = {"w": torch.full((2, 3), float(r)), "b": [torch.tensor([r])]}
    comm.bcast_data(tree, root=n - 1)
    out["bcast_data"] = tree

    # differentiable collectives: this rank's loss is sum(f(x) * w); the
    # gradient of the sum over ranks of those losses w.r.t. this rank's x
    w = torch.tensor(p["w"][r])
    ws = torch.tensor(p["ws"][r])
    cases = {
        "psum": (lambda v: C.psum(v, comm), x, w),
        "pmean": (lambda v: C.pmean(v, comm), x, w),
        "allgather": (lambda v: C.allgather(v, comm), x,
                      torch.tensor(p["wg"][r])),
        "allgather_tiled": (lambda v: C.allgather(v, comm, axis=1,
                                                  tiled=True), x,
                            torch.tensor(p["wgt"][r])),
        "reduce_scatter": (lambda v: C.reduce_scatter(v, comm), sq,
                           torch.tensor(p["wrs"][r])),
        "alltoall": (lambda v: C.alltoall(v, comm), sq,
                     torch.tensor(p["wa2a"][r])),
        "bcast": (lambda v: C.bcast(v, comm, root=1), x, w),
        "gather": (lambda v: C.gather(v, comm, root=1), x,
                   torch.tensor(p["wg"][r])),
        "scatter": (lambda v: C.scatter(v, comm, root=1), sq, ws),
    }
    out["alltoall_01"] = C.alltoall(sq, comm, 0, 1)
    for name, (f, v, wt) in cases.items():
        v = v.clone().requires_grad_(True)
        y = f(v)
        (g,) = torch.autograd.grad((y * wt).sum(), v)
        out[f"grad_{name}_y"] = y.detach()
        out[f"grad_{name}"] = g
    return np_tree(out)


def battery_data_parallel(comm, p):
    """The fused gradient exchange, synchronised BN, the data
    partition, and one updater step of the ResNet and of the MLP."""
    import torch.utils._pytree as pytree

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.datasets import (
        scatter_dataset,
        scatter_index,
        shuffle_data_blocks,
    )
    from chainermn_tpu_torch.iterators import (
        SerialIterator,
        apply_batch_policy,
        local_rows,
    )
    from chainermn_tpu_torch.links import BatchNormState, \
        multi_node_batch_normalization
    from chainermn_tpu_torch.models import (
        ResNetConfig,
        mlp_apply,
        mlp_params_from_jax,
        resnet_apply,
        resnet_params_from_jax,
        resnet_to_numpy,
        softmax_cross_entropy,
    )

    r, n = comm.rank, comm.size
    out = {}

    # -- fused exchange: fp32 and bf16 wire, fused and per leaf --------- #
    grads = pytree.tree_map(lambda a: torch.tensor(a[r]), p["grads"])
    for name, kw in (("fp32", {}), ("bf16", dict(dtype=torch.bfloat16)),
                     ("fp32_leaf", dict(fused=False)),
                     ("bf16_leaf", dict(fused=False,
                                        dtype=torch.bfloat16))):
        before = comm.n_collectives
        res = comm.multi_node_mean_grad(
            pytree.tree_map(torch.clone, grads),
            bucket_bytes=p["bucket"], **kw)
        out[f"mean_{name}"] = np_tree(res)
        out[f"count_{name}"] = comm.n_collectives - before
    out["dtypes"] = pytree.tree_map(lambda t: str(t.dtype), res)

    # -- synchronised BN: forward, backward, running state -------------- #
    x = torch.tensor(p["bn_x"][r]).permute(0, 3, 1, 2)       # NCHW
    gamma = torch.tensor(p["bn_gamma"]).requires_grad_(True)
    beta = torch.tensor(p["bn_beta"]).requires_grad_(True)
    x = x.clone().requires_grad_(True)
    state = BatchNormState(torch.tensor(p["bn_mean"]),
                           torch.tensor(p["bn_var"]),
                           torch.tensor(0, dtype=torch.int32))
    y, new = multi_node_batch_normalization(
        {"gamma": gamma, "beta": beta}, state, x, comm)
    wt = torch.tensor(p["bn_w"][r]).permute(0, 3, 1, 2)
    gx, gg, gb = torch.autograd.grad((y * wt).sum(), (x, gamma, beta))
    out["bn"] = np_tree(dict(
        y=y.permute(0, 2, 3, 1), gx=gx.permute(0, 2, 3, 1),
        ggamma=comm.allreduce(gg), gbeta=comm.allreduce(gb),
        mean=new.mean, var=new.var, n=new.n))

    # -- data partition and iterator order ------------------------------ #
    out["scatter"] = scatter_dataset(list(range(p["n_data"])), comm,
                                     shuffle=True, seed=5).indices
    out["scatter_eq"] = scatter_dataset(list(range(p["n_data"])), comm,
                                        force_equal_length=False).indices
    out["scatter_index"] = scatter_index(p["n_data"], comm)
    block = [("r", r, i) for i in range(3 + r)]
    out["shuffled"] = shuffle_data_blocks(comm, block, seed=3)

    # -- one updater step: ResNet with sync BN, and the MLP ------------- #
    cfg = ResNetConfig(**p["resnet_cfg"])
    X, Y = apply_batch_policy((p["images"], p["labels"]), n, True)
    xs, ys = local_rows((X, Y), r, n)
    params, state = resnet_params_from_jax(p["resnet_params"],
                                           p["resnet_state"], cfg,
                                           device="cpu")

    def loss_fn(params, state, x, y):
        logits, new_state = resnet_apply(cfg, params, state, x, train=True,
                                         comm=comm)
        return softmax_cross_entropy(logits, y), new_state

    opt = training.create_multi_node_optimizer(
        training.sgd(0.1, momentum=0.9), comm)
    up = training.StandardUpdater(SerialIterator((xs, ys), len(xs)), opt,
                                  loss_fn, params, comm, state=state)
    up.update()
    out["resnet"] = dict(loss=float(up.observation["main/loss"]),
                         params=resnet_to_numpy(up.params),
                         state=resnet_to_numpy(up.state))

    mx, my = local_rows((p["mlp_x"], p["mlp_y"]), r, n)
    for name, dtype in (("mlp", None), ("mlp_bf16", torch.bfloat16)):
        opt = training.create_multi_node_optimizer(
            training.sgd(0.05), comm, allreduce_grad_dtype=dtype)
        up = training.StandardUpdater(
            SerialIterator((mx, my), len(mx)), opt,
            lambda prm, x, y: softmax_cross_entropy(mlp_apply(prm, x), y),
            mlp_params_from_jax(p["mlp_params"], device="cpu"), comm)
        losses = []
        for _ in range(3):
            up.update()
            losses.append(float(up.observation["main/loss"]))
        out[name] = dict(losses=losses, params=np_tree(up.params))
    return out


# --------------------------------------------------------------------- #
# the harness's own tests
# --------------------------------------------------------------------- #


def test_world_runs_and_reports(tmp_path):
    got = run_world(tmp_path, 2, "battery_smoke", None)
    assert got == [(0, 2, 3.0), (1, 2, 3.0)]


def test_world_hang_fails_within_timeout(tmp_path):
    with pytest.raises(AssertionError, match="did not finish"):
        run_world(tmp_path, 2, "battery_hang", None, timeout=8)

