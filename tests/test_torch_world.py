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
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

JOIN_TIMEOUT_S = 240


def _child(rank, n, init_method, battery, payload_path, out_dir):
    import torch.distributed as dist

    from chainermn_tpu_torch.communicators import (
        create_communicator,
        init_distributed,
    )

    torch.set_num_threads(1)
    out = Path(out_dir) / f"{rank}.pkl"
    try:
        init_distributed(init_method=init_method, world_size=n,
                         rank=rank, device="cpu")
        comm = create_communicator("tpu_xla", device="cpu")
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        result = ("ok", globals()[battery](comm, payload))
    except BaseException:                      # reported to the parent
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    # a battery's finale runs after its result is written: a drill that
    # ends the processes itself (the global except hook)
    finale = globals().get(f"{battery}_finale")
    if finale is not None and result[0] == "ok":
        finale(comm, payload)
    if dist.is_initialized():
        dist.destroy_process_group()


def run_world(tmp_path, n, battery, payload, timeout=JOIN_TIMEOUT_S,
              info=None, tcp=False):
    """Every rank's result of ``battery(comm, payload)`` in an
    ``n``-process gloo world.  ``info``, a dict, receives the ranks'
    exit codes (``exitcodes``) and the monotonic time at which the last
    one had ended (``ended_at``).  ``tcp=True`` rendezvouses through a
    ``TCPStore`` that rank 0's process hosts on a free local port, as
    ``torchrun`` does, instead of the ``FileStore``."""
    from chainermn_tpu_torch.communicators import _free_port

    tmp_path = Path(tmp_path) / f"world-{battery}-{n}"
    tmp_path.mkdir(parents=True)
    init_method = (f"tcp://127.0.0.1:{_free_port()}" if tcp
                   else f"file://{tmp_path / 'store'}")
    payload_path = tmp_path / "payload.pkl"
    with open(payload_path, "wb") as f:
        pickle.dump(payload, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(r, n, init_method, battery,
                               str(payload_path), str(tmp_path)))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    if info is not None:
        info["ended_at"] = time.monotonic()
        info["exitcodes"] = [p.exitcode for p in procs]
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


def one_thread(fn):
    """``fn()`` with torch on one CPU thread: a product's or a
    reduction's threads split its sums otherwise from run to run, and
    a bitwise comparison of two runs would see that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


# the torch.distributed calls the port's communicators post
_COLLECTIVES = ("all_reduce", "batch_isend_irecv", "all_to_all_single",
                "all_gather_into_tensor", "all_gather", "broadcast",
                "reduce_scatter_tensor", "send", "recv", "scatter")


def run_counted(fn):
    """``(fn(), calls)``: ``calls`` the collectives (by
    ``torch.distributed`` function) and the flash kernels' plain
    versions (``flash_fwd``, ``flash_bwd``) ``fn`` ran on this rank."""
    import importlib

    import torch.distributed as dist

    # the module (the package's ``ops.flash_attention`` is the function)
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    calls = {}
    saved = [(dist, n, getattr(dist, n)) for n in _COLLECTIVES] + [
        (fa, n, getattr(fa, n)) for n in ("flash_attention_reference",
                                          "flash_attention_bwd_reference")]

    def wrap(name, f):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return f(*a, **kw)
        return call

    for mod, n, f in saved:
        key = {"flash_attention_reference": "flash_fwd",
               "flash_attention_bwd_reference": "flash_bwd"}.get(n, n)
        setattr(mod, n, wrap(key, f))
    try:
        return fn(), calls
    finally:
        for mod, n, f in saved:
            setattr(mod, n, f)


def dots_against_full(cfg, mesh, params, x, y):
    """The gradients of ``cfg`` on ``mesh`` under ``remat_policy="dots"``
    and under ``"full"``, on one thread: whether they are the same bits,
    the "dots" loss and gradients (numpy, the whole tree), and what each
    policy ran on this rank (:func:`run_counted`)."""
    import dataclasses

    from chainermn_tpu_torch.models import (make_value_and_grad_fn,
                                            params_to_numpy)

    got, calls = {}, {}
    for policy in ("full", "dots"):
        run = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        fn = make_value_and_grad_fn(run, mesh=mesh)
        got[policy], calls[policy] = one_thread(
            lambda fn=fn: run_counted(lambda: fn(params, x, y)))
    leaves = [torch.utils._pytree.tree_leaves(got[k][1])
              for k in ("full", "dots")]
    loss, grads = got["dots"]
    return dict(bitwise=bool(torch.equal(got["full"][0], loss)) and all(
        torch.equal(a, b) for a, b in zip(*leaves)), loss=float(loss),
        grads=params_to_numpy(grads, cfg, mesh=mesh), calls=calls)


def fsdp_step_matches_dense(cfg, steps=2, seed=0):
    """``cfg`` (with ``fsdp=True``) trained on one CPU rank, where the
    data group has one member, against the same config without FSDP
    from the same seeded weights: ``(losses, dense losses, params
    bitwise)``.  Each block's gathers are then identities, so the two
    runs must agree bit for bit (on one thread, :func:`one_thread`)."""
    return one_thread(lambda: _fsdp_against_dense(cfg, steps, seed))


def _fsdp_against_dense(cfg, steps, seed):
    import dataclasses

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        init_numpy_params, make_train_step, params_from_jax)

    B = 2 * max(cfg.num_microbatches, 1)
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, cfg.max_seq + 1)).astype(np.int32)
    runs = []
    for c in (cfg, dataclasses.replace(cfg, fsdp=False,
                                       fsdp_wire_dtype="")):
        params = params_from_jax(init_numpy_params(c, seed), c, "cpu")
        opt = training.adamw(1e-3)
        state = opt.init(params)
        step = make_train_step(c, opt, device="cpu")
        losses = []
        for _ in range(steps):
            params, state, loss = step(params, state, toks[:, :-1],
                                       toks[:, 1:])
            losses.append(float(loss))
        runs.append((losses, params))
    (lf, pf), (ld, pd) = runs
    import torch.utils._pytree as pytree

    same = all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(pf),
                                                 pytree.tree_leaves(pd)))
    return lf, ld, same


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
# the large-batch recipe: the exchange's forms, the optimizer stack,
# accumulation and windows
# --------------------------------------------------------------------- #


def _wire_tensor(a, dtype):
    t = torch.tensor(a)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def local_batches(X, Y, G, r, n):
    """Rank ``r``'s rows of every global batch of ``G`` rows of
    ``(X, Y)`` in order (a ragged last batch split evenly too): what a
    rank iterates with batch ``G // n`` to see the JAX updater's global
    batches."""
    xs, ys = [], []
    for start in range(0, len(X), G):
        b = min(G, len(X) - start)
        lo = start + r * (b // n)
        xs.append(X[lo:lo + b // n])
        ys.append(Y[lo:lo + b // n])
    return np.concatenate(xs), np.concatenate(ys)


def _port_job(comm, p, job):
    """A port updater over the JAX updater's global batches (this rank's
    rows), ``job["updates"]`` updates: losses, iterations, parameters
    and model state."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import (
        ResNetConfig, mlp_apply, mlp_params_from_jax, resnet_apply,
        resnet_params_from_jax, resnet_to_numpy, softmax_cross_entropy)

    n = job["n"]
    if job["model"] == "mlp":
        X, Y = p["mlp_x"][:n], p["mlp_y"][:n]
        params, state = mlp_params_from_jax(p["mlp_params"], "cpu"), None

        def loss_fn(prm, x, y):
            return softmax_cross_entropy(mlp_apply(prm, x), y)
    else:
        X, Y = p["images"][:n], p["labels"][:n]
        cfg = ResNetConfig(**p["resnet_cfg"])
        params, state = resnet_params_from_jax(
            p["resnet_params"], p["resnet_state"], cfg, device="cpu")

        def loss_fn(prm, st, x, y):
            logits, new = resnet_apply(cfg, prm, st, x, train=True,
                                       comm=comm)
            return softmax_cross_entropy(logits, y), new
    xs, ys = local_batches(X, Y, job["G"], comm.rank, comm.size)
    it = SerialIterator((xs, ys), job["G"] // comm.size,
                        repeat=job["repeat"], shuffle=False)
    inner = {"sgd": lambda lr: training.sgd(lr),
             "momentum": lambda lr: training.sgd(lr, momentum=0.9),
             "adam": lambda lr: training.adamw(lr, weight_decay=0.0)}[
        job["opt"]](job["lr"])
    up = training.StandardUpdater(
        it, training.create_multi_node_optimizer(inner, comm), loss_fn,
        params, comm, state=state, accum_steps=job["M"],
        steps_per_execution=job["spe"])
    losses, iterations = [], []
    for _ in range(job["updates"]):
        up.update()
        losses.append(float(up.observation["main/loss"]))
        iterations.append(up.iteration)
    tree = np_tree if job["model"] == "mlp" else resnet_to_numpy
    return dict(losses=losses, iterations=iterations,
                params=tree(up.params),
                state=None if state is None else resnet_to_numpy(up.state))


def battery_large_batch(comm, p):
    """The exchange's forms (reduce-scatter/all-gather, two-stage over a
    2 x 2 split, the overlap schedule's modes and routes, the two-stage
    ``multi_node_mean_grad``), the multi-node optimizer's accumulation
    and double buffering, and the updater's accumulation and windows."""
    import importlib.util

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.ops import fused

    r = comm.rank
    out = {}

    # -- one flat bucket: reduce-scatter/all-gather and two-stage ------- #
    node, slot = r // 2, r % 2
    intra = comm.split(node, slot)
    inter = comm.split(slot, node)
    for name, (a, dtype) in p["buckets"].items():
        x = _wire_tensor(a[r], dtype)
        out[f"rs_{name}"] = np_tree(fused.reduce_scatter_allgather(x, comm))
        out[f"rs_sum_{name}"] = np_tree(
            fused.reduce_scatter_allgather(x, comm, op="sum"))
        out[f"hier_{name}"] = np_tree(
            fused.hierarchical_allreduce(x, intra, inter))

    # -- a gradient tree: the overlap schedules, two-stage ------------- #
    def tree():
        return {k: _wire_tensor(a[r], p["tree_dtypes"][k])
                for k, a in p["tree"].items()}

    for i, (sched, wire) in enumerate(p["schedules"]):
        wire = None if wire is None else torch.bfloat16
        out[f"overlap_{i}"] = np_tree(fused.overlap_exchange(
            tree(), comm, schedule=sched, bucket_bytes=p["bucket"],
            wire_dtype=wire))
        out[f"overlap_hier_{i}"] = np_tree(fused.overlap_exchange(
            tree(), intra, schedule=sched, bucket_bytes=p["bucket"],
            wire_dtype=wire, inter_comm=inter))
    out["schedule"] = fused.build_overlap_schedule(
        tree(), p["bucket"], torch.bfloat16)
    # shares whose mean rounds: the flat bf16 multi_node_mean_grad
    out["mean_bf16_rounding"] = np_tree(comm.multi_node_mean_grad(
        [torch.as_tensor(a[r]) for a in p["rounding"]], torch.bfloat16))
    # the world seen as two nodes of two ranks: multi_node_mean_grad
    # goes two-stage over hierarchy()
    comm._intra_rank, comm._inter_rank = slot, node
    comm._inter_size, comm._node_sizes = 2, [2, 2]
    stages = comm.hierarchy()
    before = [c.n_collectives for c in (comm,) + stages]
    out["mean_two_stage"] = np_tree(comm.multi_node_mean_grad(
        tree(), torch.bfloat16, bucket_bytes=p["bucket"]))
    out["two_stage_collectives"] = [
        c.n_collectives - b for c, b in zip((comm,) + stages, before)]
    out["hierarchy_sizes"] = [c.size for c in stages]
    # ranks 0-2 seen as two nodes of 2 and 1 ranks: hierarchy(), and the
    # two-stage optimizer over it, raise on every member
    sub = comm.split(int(r == 3), r)
    if r < 3:
        sub._inter_rank, sub._intra_rank = int(r == 2), r % 2
        sub._inter_size, sub._node_sizes = 2, [2, 1]
        opt = training.create_multi_node_optimizer(
            training.sgd(0.1), sub, inter_axis_name="inter")
        w = {"w": torch.zeros(2)}
        st = opt.init(w)
        out["uneven"] = []
        for call in (sub.hierarchy,
                     lambda: opt.update({"w": torch.ones(2)}, st, w)):
            try:
                call()
                out["uneven"].append(None)
            except ValueError as e:
                out["uneven"].append(str(e))

    # -- the multi-node optimizer: accumulation, double buffering ------ #
    g1, g2 = p["g1"][r], p["g2"][r]
    for kind, make in (("sgd", lambda: training.sgd(0.5)),
                       ("adam", lambda: training.adamw(
                           1e-2, weight_decay=0.0))):
        prm = {"w": torch.ones(6)}
        opt = training.create_multi_node_optimizer(make(), comm,
                                                   accum_steps=2)
        st = opt.init(prm)
        opt.update({"w": torch.tensor(g1)}, st, prm)
        mid = prm["w"].clone()
        tree_mid = np_tree(training.optimizer_state_tree(st))
        opt.update({"w": torch.tensor(g2)}, st, prm)
        big = {"w": torch.ones(6)}
        ref = training.create_multi_node_optimizer(make(), comm)
        ref_st = ref.init(big)
        ref.update({"w": torch.tensor((g1 + g2) / 2)}, ref_st, big)
        out[f"opt_accum_{kind}"] = dict(mid=mid.numpy(), acc=prm["w"].numpy(),
                                    big=big["w"].numpy(), tree=tree_mid)

    opt = training.create_multi_node_optimizer(
        training.sgd(1.0), comm, double_buffering=True)
    w = {"w": torch.zeros(2)}
    st = opt.init(w)
    stale = []
    for g in ([1.0, 2.0], [10.0, 20.0]):
        opt.update({"w": torch.tensor(g)}, st, w)
        stale.append(w["w"].clone().numpy())
    out["double_buffer"] = stale

    spec = importlib.util.spec_from_file_location(
        "lb_example", p["example"])
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    sched = ex.make_lr_schedule(base_lr=0.1, global_batch=1024,
                                warmup_epochs=1, total_epochs=3,
                                steps_per_epoch=4)
    out["sched"] = [float(sched(c)) for c in (0, 1, 4, 8)]
    opt = training.create_multi_node_optimizer(
        training.sgd(sched), comm, double_buffering=True,
        allreduce_grad_dtype=torch.bfloat16)
    w = {"w": torch.zeros(2)}
    st = opt.init(w)
    recipe = []
    for _ in range(2):
        opt.update({"w": torch.tensor(p["recipe_g"][r])}, st, w)
        recipe.append(w["w"].clone().numpy())
    out["recipe"] = recipe

    # -- the updater: accumulation, windows, flushes, weighted loss ---- #
    for job in p["jobs"]:
        out[job["name"]] = _port_job(comm, p, job)
    return out


# --------------------------------------------------------------------- #
# checkpoint, resume and the trainer extensions
# --------------------------------------------------------------------- #


def linear_dataset(n=64):
    """The resume drills' regression set (the JAX package's
    ``tests/extension_tests/test_resume_equivalence.py``)."""
    import numpy as np

    rng = np.random.RandomState(0)
    x = rng.randn(n, 4).astype(np.float32)
    w = rng.randn(4).astype(np.float32)
    y = (x @ w).astype(np.float32)
    return [(x[i], y[i]) for i in range(n)]


def linear_loss(params, x, y):
    pred = x @ params["w"] + params["b"]
    return torch.mean((pred - y) ** 2)


def linear_job(comm, root, seed=5, async_write=False, history=1,
               ckpt_every=3, epochs=6, data=None, inner=None, **opt_kw):
    """The resume drills' job: ``sgd(0.05)`` (or the optimizer
    ``inner``, wrapped with ``opt_kw``) on a linear model, batch 16 of
    64 examples (4 iterations an epoch), a ``LogReport`` an epoch and a
    checkpoint every ``ckpt_every`` iterations (3: not aligned with the
    epoch, so a resume lands mid-epoch and mid-shuffle).  Returns
    ``(trainer, updater, checkpointer, log)``."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )
    from chainermn_tpu_torch.iterators import SerialIterator

    root = Path(root)
    it = SerialIterator(data or linear_dataset(), batch_size=16,
                        shuffle=True, seed=seed)
    opt = training.create_multi_node_optimizer(
        inner or training.sgd(0.05), comm, **opt_kw)
    params = {"w": torch.zeros(4), "b": torch.zeros(())}
    up = training.StandardUpdater(it, opt, linear_loss, params, comm)
    trainer = training.Trainer(up, stop_trigger=(epochs, "epoch"),
                               out=str(root / "out"))
    log = training.LogReport(trigger=(1, "epoch"))
    trainer.extend(log)
    cp = create_multi_node_checkpointer(comm, str(root / "ckpt"),
                                        async_write=async_write,
                                        history=history)
    if ckpt_every:
        trainer.extend(cp, trigger=(ckpt_every, "iteration"))
    return trainer, up, cp, log


class FakeUpdater:
    """What the checkpointer reads of an updater: a parameter ``w`` of
    3 values, SGD with momentum over it, the iteration."""

    def __init__(self, comm, value=0.0, iteration=0):
        from chainermn_tpu_torch import training

        self.comm = comm
        self.iteration = iteration
        self.params = {"w": torch.full((3,), float(value))}
        self.opt_state = training.sgd(0.1, momentum=0.9).init(self.params)
        self.state = None


def _snapshot_files(path):
    import os

    return sorted(f for f in os.listdir(path) if f.startswith("snapshot"))


def battery_extensions(comm, p):
    """The checkpointer's agreement across ranks (fallback resume with a
    quarantine on one rank, ``history`` GC of agreed sets), SIGTERM on
    one rank, the persistent-value mean, the observation mean and the
    watchdog's heartbeats through the world's store."""
    import signal
    from types import SimpleNamespace

    from chainermn_tpu_torch.extensions import (
        AllreducePersistentValues,
        ObservationAggregator,
        PreemptionCheckpointer,
        TrainingWatchdog,
        create_multi_node_checkpointer,
    )
    from chainermn_tpu_torch.links import BatchNormState
    from chainermn_tpu_torch.testing import FaultInjector, FaultPlan, \
        corrupt_file

    r = comm.rank
    root = Path(p["root"])
    out = {}

    # -- fallback resume: rank 1's newest file is corrupt --------------- #
    d = root / "fallback"
    cp = create_multi_node_checkpointer(comm, str(d), history=2)
    cp._cleanup = lambda keep: None          # keep every set for now
    for it in (5, 10, 15):
        cp.save(FakeUpdater(comm, it, it))
    comm.barrier()
    if r == 1:
        corrupt_file(str(d / "snapshot_iter_15.1"), seed=1)
    comm.barrier()
    up = FakeUpdater(comm)
    cp2 = create_multi_node_checkpointer(comm, str(d), history=2)
    out["fallback_resumed"] = cp2.maybe_load(up)
    out["fallback_w"] = up.params["w"].tolist()
    comm.barrier()
    out["fallback_files"] = _snapshot_files(d)
    comm.barrier()
    # the next save runs the agreed GC: 15 is complete on rank 0 only,
    # so it takes no history slot; the quarantined file stays
    cp2.save(FakeUpdater(comm, 20, 20))
    comm.barrier()                           # every rank's GC is done
    out["gc_files"] = _snapshot_files(d)
    comm.barrier()
    out["second_resume"] = create_multi_node_checkpointer(
        comm, str(d), history=2).maybe_load(FakeUpdater(comm))
    # both of the two newest sets broken, one file on each rank
    d2 = root / "fallback2"
    cp = create_multi_node_checkpointer(comm, str(d2))
    cp._cleanup = lambda keep: None
    for it in (5, 10, 15):
        cp.save(FakeUpdater(comm, it, it))
    comm.barrier()
    corrupt_file(str(d2 / f"snapshot_iter_{15 - 5 * r}.{r}"), seed=2 + r)
    comm.barrier()
    up = FakeUpdater(comm)
    out["twice_resumed"] = create_multi_node_checkpointer(
        comm, str(d2)).maybe_load(up)
    out["twice_w"] = up.params["w"].tolist()

    # -- SIGTERM on rank 1: both ranks save the same iteration ---------- #
    d3 = root / "sigterm"
    trainer, up, cp, _ = linear_job(comm, d3, ckpt_every=None, epochs=50)
    pre = PreemptionCheckpointer(cp, comm)
    trainer.extend(pre)
    trainer.extend(FaultInjector(
        FaultPlan(sigterm_at_iteration=2, sigterm_rank=1), comm))
    trainer.run()
    comm.barrier()
    out["sigterm"] = dict(
        iteration=up.iteration, signaled=pre.signaled,
        stop_reason=trainer.stop_reason, files=_snapshot_files(d3 / "ckpt"),
        handler_restored=signal.getsignal(signal.SIGTERM)
        is signal.SIG_DFL)
    t2, up2, cp2, _ = linear_job(comm, d3, ckpt_every=None, epochs=50)
    out["sigterm"]["resumed"] = cp2.maybe_load(up2, t2)
    out["sigterm"]["same_w"] = torch.equal(up2.params["w"],
                                           up.params["w"])

    # -- AllreducePersistentValues: BN statistics a rank --------------- #
    st = BatchNormState(torch.tensor(p["bn_mean"][r]),
                        torch.tensor(p["bn_var"][r]),
                        torch.tensor(3, dtype=torch.int32))
    holder = SimpleNamespace(state=st)
    AllreducePersistentValues(comm).allreduce_persistent(holder)
    out["persistent"] = np_tree(tuple(holder.state))

    # -- ObservationAggregator ------------------------------------------ #
    obs = {"main/loss": torch.tensor(p["obs_loss"][r]),
           "main/host_time": p["obs_time"][r],
           f"only{r}": float(r + 7)}
    tr = SimpleNamespace(observation=obs)
    ObservationAggregator(comm).observe(tr)
    out["observation"] = {k: float(v) for k, v in tr.observation.items()}

    # -- the watchdog's cross-rank heartbeats --------------------------- #
    reports = []
    wd = TrainingWatchdog(stall_timeout=0.5, check_interval=0.1, comm=comm,
                          on_stall=reports.append,
                          report_path=str(root / f"stall.{r}.json"))
    wd.start()
    for i in range(3):
        wd.heartbeat(iteration=i)
    comm.barrier()
    if r == 1:
        time.sleep(2.5)                      # rank 1 stops beating
    else:
        for i in range(50):
            wd.heartbeat(iteration=3 + i)
            time.sleep(0.05)
    comm.barrier()
    wd.stop()
    out["watchdog"] = [(rep["kind"], sorted(rep["stalled_peers"]),
                        rep["peer_heartbeats"]) for rep in reports]
    return out


def battery_watchdog_store_host_exit(comm, p):
    """The watchdog when the world's store dies with its host: rank 0,
    which hosts the ``TCPStore``, leaves with ``os._exit`` (the finale);
    rank 1 stops beating after the barrier, as a rank stuck in a
    collective would, and must still report its peer and its own
    stall."""
    from chainermn_tpu_torch.extensions import TrainingWatchdog

    reports = []
    wd = TrainingWatchdog(stall_timeout=p["stall_timeout"],
                          check_interval=0.1, comm=comm,
                          on_stall=reports.append,
                          report_path=str(Path(p["root"]) /
                                          f"stall.{comm.rank}.json"))
    wd.start()
    for i in range(3):
        wd.heartbeat(iteration=i)
    comm.barrier()
    if comm.rank == 0:
        wd.stop()
        return []
    deadline = time.monotonic() + p["wait_s"]
    while time.monotonic() < deadline and not (
            any(r["store_unreachable"] for r in reports)
            and "local-stall" in [r["kind"] for r in reports]):
        time.sleep(0.05)
    wd.stop()
    return [(r["kind"], sorted(r["stalled_peers"]), r["store_unreachable"])
            for r in reports]


def battery_watchdog_store_host_exit_finale(comm, p):
    import os

    if comm.rank == 0:
        os._exit(0)


def battery_extensions_finale(comm, p):
    """The global except hook: rank 1 raises, rank 0 waits in a barrier
    for it; the hook must end both processes."""
    import sys

    from chainermn_tpu_torch.extensions import add_global_except_hook

    add_global_except_hook(trace_dir=p["root"])
    Path(p["root"], f"finale.{comm.rank}").write_text(str(time.monotonic()))
    try:
        if comm.rank == 1:
            raise RuntimeError("rank 1 fails")
        comm.barrier()                 # rank 1 never arrives
    except BaseException:
        sys.excepthook(*sys.exc_info())


# --------------------------------------------------------------------- #
# point-to-point transfers and MultiNodeChainList (4 ranks)
# --------------------------------------------------------------------- #

# the raw transfers: name -> (op, keyword arguments); perms in ranks of 4
P2P_CASES = {
    "send": ("send", dict(dest=1, source=0)),
    "send_recv": ("send_recv", dict(perm=[(0, 2), (2, 3), (3, 0), (1, 1)])),
    "send_recv_partial": ("send_recv", dict(perm=[(3, 1), (1, 0)])),
    "shift_up": ("shift_up", dict()),
    "shift_up_wrap": ("shift_up", dict(wrap=True)),
    "shift_down": ("shift_down", dict()),
    "shift_down_wrap": ("shift_down", dict(wrap=True)),
}

# chain graphs: (kind, owner, rank_in, rank_out, (d_in, d_out)) a
# component; kind "dense" is tanh(h @ w + b), "add" joins two inputs as
# a + b and "fifo" as a - 2 b (two messages on one pair, whose order
# shows)
CHAINS = {
    "seq3": dict(broadcast=True, x=(4, 6), comps=[
        ("dense", 0, None, 1, (6, 5)), ("dense", 1, 0, 2, (5, 4)),
        ("dense", 2, 1, None, (4, 3))]),
    "nobcast": dict(broadcast=False, x=(4, 6), comps=[
        ("dense", 0, None, 1, (6, 5)), ("dense", 1, 0, 2, (5, 4)),
        ("dense", 2, 1, None, (4, 3))]),
    "dag": dict(broadcast=True, x=(2, 4), comps=[
        ("dense", 0, None, [1, 2], (4, 4)), ("dense", 1, 0, 3, (4, 4)),
        ("dense", 2, 0, 3, (4, 4)), ("add", 3, [1, 2], None, (4, 4))]),
    "fifo": dict(broadcast=True, x=(3, 4), comps=[
        ("dense", 0, None, 1, (4, 5)), ("dense", 0, None, 1, (4, 5)),
        ("fifo", 1, [0, 0], None, (5, 3))]),
    "self": dict(broadcast=True, x=(3, 4), comps=[
        ("dense", 0, None, 0, (4, 5)), ("dense", 0, 0, None, (5, 3))]),
}
CHAIN_ERRORS = {
    "unconsumed": [("dense", 0, None, 1, (4, 4)),
                   ("dense", 1, None, None, (4, 4))],
    "missing": [("dense", 0, 7, None, (4, 4))],
}


def chain_apply(kind, tanh):
    """A component's apply function over either package's arrays."""
    if kind == "dense":
        return lambda p, h: tanh(h @ p["w"] + p["b"])
    if kind == "add":
        return lambda p, a, b: tanh((a + b) @ p["w"] + p["b"])
    return lambda p, a, b: tanh((a - 2.0 * b) @ p["w"] + p["b"])


def port_chain(comm, comps, broadcast=True):
    from chainermn_tpu_torch.links import MultiNodeChainList

    mn = MultiNodeChainList(comm, broadcast_output=broadcast)
    for kind, owner, rank_in, rank_out, _ in comps:
        mn.add_link(None, chain_apply(kind, torch.tanh), owner=owner,
                    rank_in=rank_in, rank_out=rank_out, name=kind)
    return mn


def battery_point_to_point(comm, p):
    """Every transfer of ``P2P_CASES`` (forward and the gradient of
    ``sum(out * w)``), ``pseudo_connect`` on a rank that only sends,
    every graph of ``CHAINS`` (output, and the reduced gradients of
    ``sum(y ** 2)``), the two graph errors, and the model-parallel MNIST
    example in two 2-rank halves of the world."""
    import importlib.util

    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.models import chain_params_from_jax

    r = comm.rank
    out = {"ops": {}, "chains": {}, "errors": {}}
    for name, (op, kw) in P2P_CASES.items():
        x = torch.tensor(p["x"][r], requires_grad=True)
        y = getattr(ops, op)(x, comm, **kw)
        (y * torch.tensor(p["w"][r])).sum().backward()
        out["ops"][name] = (y.detach().numpy().copy(),
                            x.grad.numpy().copy())

    # rank 0 sends to 1 and uses nothing it received
    x = torch.tensor(p["x"][r], requires_grad=True)
    phi = ops.send(x, comm, dest=1, source=0)
    y = ops.pseudo_connect(phi, x * 2.0)
    (y * (r + 1.0)).sum().backward()
    out["pseudo_connect"] = x.grad.numpy().copy()

    objs = [0]
    for op in ("send_obj", "recv_obj", "bcast_obj"):
        def counted(*a, _real=getattr(comm, op), **kw):
            objs[0] += 1
            return _real(*a, **kw)
        setattr(comm, op, counted)

    def as_numpy(grads):
        return [None if g is None else {k: v.numpy().copy()
                                        for k, v in g.items()}
                for g in grads]

    out["chain_cache"] = {}
    for name, spec in CHAINS.items():
        mn = port_chain(comm, spec["comps"], spec["broadcast"])
        mn.load_params(chain_params_from_jax(p["chain_params"][name], mn))
        x = torch.tensor(p["chain_x"][name])
        y = mn(x)
        loss = (y ** 2).sum()
        loss.backward()
        grads = mn.reduce_grads(mn.grads())
        out["chains"][name] = (y.detach().numpy().copy(), float(loss),
                               as_numpy(grads))
        # again with x's shape known: no object message, the same output,
        # and the gradients accumulate to twice the first; then a new
        # shape of x exchanges the shapes again
        objs[0] = 0
        y2 = mn(x)
        (y2 ** 2).sum().backward()
        again = objs[0]
        with torch.no_grad():
            y3 = mn(x[:1])
        out["chain_cache"][name] = (
            again, objs[0] - again, torch.equal(y2, y),
            as_numpy(mn.reduce_grads(mn.grads())), y3.numpy().copy())

    for name, comps in CHAIN_ERRORS.items():
        mn = port_chain(comm, comps)
        mn.load_params([{"w": torch.eye(4), "b": torch.zeros(4)}
                        if mn.owns(i) else None for i in range(len(comps))])
        try:
            mn(torch.zeros(2, 4))
            out["errors"][name] = None
        except ValueError as e:
            out["errors"][name] = str(e)

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "train_mnist_model_parallel_torch",
        root / "examples" / "mnist" / "train_mnist_model_parallel_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    half = comm.split(color=r // 2, key=r)
    out["example"] = ex.train(ex.parse_args(
        ["--device", "cpu", "--epoch", "1", "--iterations", "2"]),
        comm=half, quiet=True)
    return out


def _load_example(rel, name):
    import importlib.util

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(name, root / rel)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return ex


def battery_lm_data_parallel(comm, p):
    """The flagship's data-parallel train step: for each case of
    ``p["cases"]`` (a name, ``TransformerConfig`` fields, a learning
    rate), AdamW steps of ``make_train_step(comm=comm)`` on the global
    batches ``p["batches"]``: free from the JAX weights ``p["tree"]``,
    and, where ``p["forced"]`` holds the JAX run's states (params, the
    adam moments and count before each step), each step again from the
    JAX state before it.  Every rank's losses and parameters (JAX
    layout)."""
    import torch.utils._pytree as pytree

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, make_train_step, params_from_jax,
        params_to_numpy)

    def steps(cfg, lr, start, batches):
        params = params_from_jax(start[0], cfg, device="cpu")
        opt = training.adamw(lr)
        state = opt.init(params)
        if len(start) > 1:
            _, mu, nu, count = start
            with torch.no_grad():
                for t, m, v in zip(
                        pytree.tree_leaves(params),
                        pytree.tree_leaves(params_from_jax(mu, cfg, "cpu")),
                        pytree.tree_leaves(params_from_jax(nu, cfg, "cpu"))):
                    st = state.state[t]
                    st["mu"].copy_(m)
                    st["nu"].copy_(v)
                    st["count"].fill_(int(count))
        step = make_train_step(cfg, opt, comm=comm)
        losses = []
        for x, y in batches:
            params, state, loss = step(params, state, x, y)
            losses.append(float(loss))
        return losses, params_to_numpy(params, cfg)

    out = {}
    for name, fields, lr in p["cases"]:
        cfg = TransformerConfig(**fields)
        free = steps(cfg, lr, (p["tree"],), p["batches"])
        forced = [steps(cfg, lr, st, [b])
                  for st, b in zip(p["forced"].get(name, ()), p["batches"])]
        out[name] = dict(free=free, forced=forced)
    return out


def battery_lm_examples(comm, p):
    """``train_lm_torch.py`` in this world: ``p["argv"]`` from the JAX
    weights ``p["tree"]``, its printed lines and losses on rank 0; then a
    text-file run with a BPE vocabulary saved under ``p["ck"]``, resumed
    for more steps, and greedy generation from the checkpoint on rank 0."""
    import contextlib
    import io

    from chainermn_tpu_torch.utils.serialization import load_state

    ex = _load_example("examples/transformer/train_lm_torch.py",
                       "train_lm_torch")
    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = ex.main(p["argv"], init=p["tree"])
    out["printed"], out["losses"] = buf.getvalue(), run.losses

    text = p["text_argv"] + ["--checkpoint", p["ck"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        first = ex.main(text + ["--steps", "4"])
        saved = load_state(p["ck"] + "/lm_state.npz")
        again = ex.main(text + ["--steps", "6"])
    final = load_state(p["ck"] + "/lm_state.npz")
    out["text"] = dict(printed=buf.getvalue(), first=first.losses,
                       resumed=again.losses, start=again.start,
                       perplexity=again.perplexity,
                       steps=(int(saved["step"]), int(final["step"])),
                       first_embed=first.params["embed"].numpy().copy(),
                       saved_embed=saved["params"]["embed"],
                       final_embed=final["params"]["embed"])
    if comm.rank == 0:
        gen = _load_example("examples/transformer/generate_torch.py",
                            "generate_torch")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = gen.main(p["gen_argv"] + ["--checkpoint", p["ck"],
                                            "--tokenizer",
                                            p["ck"] + "/bpe.json"],
                           keep_logits=True)
        from chainermn_tpu_torch.models import make_forward_fn

        # the full forward over the generated sequence predicts what
        # each decode step predicted
        full = make_forward_fn(res.cfg, device="cpu")(
            res.params, res.tokens[:, :-1].long())
        out["generate"] = dict(
            printed=buf.getvalue(), tokens=res.tokens.numpy().copy(),
            logits=res.logits.numpy().copy(),
            full=full[:, res.prompt.shape[1] - 1:].numpy().copy(),
            embed=res.params["embed"].numpy().copy())
    return out


def _seq_block(x, mesh, axis=1):
    """This rank's block of a global array along ``axis`` over seq."""
    S, s = mesh.axis_size("seq"), mesh.axis_index("seq")
    t = x.shape[axis] // S
    return np.take(x, np.arange(s * t, (s + 1) * t), axis=axis)


def battery_sequence_parallel(comm, p):
    """The mesh's sequence axis in a 4-rank world, every case of the
    parity tests in ``test_torch_sequence_parallel.py``: the mesh's
    coordinates and sub-communicators, the tiled all-to-all, ring and
    Ulysses attention (forward and gradients), the flagship's forward
    and one AdamW step at data=2,seq=2, data- and seq-parallel decoding,
    and ``train_lm_torch.py`` at data=2,seq=2 with the zigzag ring.
    Returns every case's result on this rank, with the flash calls
    (forward, backward) each kernel-path case made on it: the plain
    versions' calls, which stand on the CPU where the card launches the
    kernels."""
    import contextlib
    import importlib
    import io

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, make_forward_fn, make_generate_fn,
        make_train_step, params_from_jax, params_to_numpy)
    from chainermn_tpu_torch.parallel import (
        MeshConfig, all_to_all_tiled, ring_attention, ulysses_attention)
    from chainermn_tpu_torch.ops.flash_attention import flash_attention

    out = {"rank": comm.rank, "calls": {}}
    # the module (the package's ``ops.flash_attention`` is the function)
    fa_mod = importlib.import_module(
        "chainermn_tpu_torch.ops.flash_attention")
    calls = [0, 0]

    def counted(i, fn):
        def call(*a, **kw):
            calls[i] += 1
            return fn(*a, **kw)
        return call

    fa_mod.flash_attention_reference = counted(
        0, fa_mod.flash_attention_reference)
    fa_mod.flash_attention_bwd_reference = counted(
        1, fa_mod.flash_attention_bwd_reference)

    def count(key, fn, *args):
        """``fn(*args)``, recording its flash calls under ``key``."""
        calls[:] = [0, 0]
        got = fn(*args)
        out["calls"][key] = tuple(calls)
        return got

    # the mesh: coordinates and each sub-communicator's members
    out["mesh"] = []
    for spec, groups in p["meshes"]:
        mesh = MeshConfig(comm, **spec)
        members = {g: mesh.comm(*g).allgather_obj(comm.rank)
                   for g in groups}
        out["mesh"].append((mesh.shape, mesh.coords, members))

    seq4 = MeshConfig(comm, seq=4)
    # the tiled exchange on its own
    x = torch.as_tensor(p["a2a"][comm.rank])
    out["a2a"] = [all_to_all_tiled(x, seq4.comm("seq"), s, c).numpy()
                  for s, c in ((2, 1), (1, 2), (3, 0))]

    def attn_case(fn, q, k, v, do):
        q, k, v = (torch.as_tensor(_seq_block(a, seq4)).requires_grad_()
                   for a in (q, k, v))
        o = fn(q, k, v)
        grads = torch.autograd.grad(
            (o * torch.as_tensor(_seq_block(do, seq4))).sum(), (q, k, v))
        return [o.detach().numpy()] + [g.numpy() for g in grads]

    seq = seq4.comm("seq")
    out["ring"] = {}
    for name, case in p["ring"].items():
        for use_flash in (False, True):
            fn = (lambda q, k, v: ring_attention(
                q, k, v, comm=seq, causal=True, window=case["window"],
                layout=case["layout"], use_flash=use_flash))
            out["ring"][name, use_flash] = count(
                ("ring", name, use_flash), attn_case, fn, *case["qkvd"])
    out["ulysses"] = {}
    for name, case in p["ulysses"].items():
        for attn_fn in (None, flash_attention):
            fn = (lambda q, k, v: ulysses_attention(
                q, k, v, comm=seq, causal=True, attn_fn=attn_fn))
            flag = attn_fn is not None
            out["ulysses"][name, flag] = count(
                ("ulysses", name, flag), attn_case, fn, *case["qkvd"])

    # the flagship at data=2, seq=2: forward shards and one AdamW step
    mesh = MeshConfig(comm, data=2, seq=2)
    out["lm"] = {}
    for name, fields in p["lm_cases"].items():
        cfg = TransformerConfig(**fields)
        x, y = p["lm_batch"][name]
        params = params_from_jax(p["lm_tree"][name], cfg, device="cpu")
        logits = make_forward_fn(cfg, mesh=mesh)(params, x).numpy()
        opt = training.adamw(p["lr"])
        state = opt.init(params)
        step = make_train_step(cfg, opt, mesh=mesh)
        params, state, loss = count(("lm", name), step, params, state, x,
                                    y)
        out["lm"][name] = dict(logits=logits, loss=float(loss),
                               params=params_to_numpy(params, cfg))

    # "dots" remat against full remat at data=2, seq=2, and one AdamW
    # step under "dots"
    out["dots"] = {}
    for name in p["lm_cases"]:
        cfg = TransformerConfig(**dict(p["lm_cases"][name], remat=True,
                                       remat_policy="dots"))
        x, y = p["lm_batch"][name]
        params = params_from_jax(p["lm_tree"][name], cfg, device="cpu")
        res = dots_against_full(cfg, mesh, params, x, y)
        opt = training.adamw(p["lr"])
        step = make_train_step(cfg, opt, mesh=mesh)
        params, _, loss = step(params, opt.init(params), x, y)
        res.update(step_loss=float(loss),
                   params=params_to_numpy(params, cfg))
        out["dots"][name] = res

    # decoding: data=2 (each half of the world a mesh of its own), then
    # data=2, seq=2 with the seq-KV cache; eos is a token the no-eos run
    # generates in the first data shard's rows and not in the second's
    half = MeshConfig(comm.split(comm.rank // 2, comm.rank), data=2)
    out["gen"] = {}
    for name, (fields, m) in dict(
            data2=(p["gen_cases"]["data2"], half),
            data2_seq2=(p["gen_cases"]["data2_seq2"], mesh)).items():
        cfg = TransformerConfig(**fields)
        params = params_from_jax(p["gen_tree"][name], cfg, device="cpu")
        prompt, max_len = p["gen_prompt"], p["gen_max_len"]
        plain = make_generate_fn(cfg, max_len=max_len, mesh=m)(
            params, prompt)
        rows = np.concatenate(m.comm("data").allgather_obj(plain.numpy()))
        b = rows.shape[0] // 2
        first = set(rows[:b, prompt.shape[1]:].ravel().tolist())
        second = set(rows[b:, prompt.shape[1]:].ravel().tolist())
        eos = min(first - second)
        toks, done, gen_len = make_generate_fn(
            cfg, max_len=max_len, eos_id=eos, pad_id=p["gen_pad"],
            with_row_state=True, mesh=m)(params, prompt)
        out["gen"][name] = dict(plain=plain.numpy(), eos=eos,
                                tokens=toks.numpy(), done=done.numpy(),
                                gen_len=gen_len.numpy())

    # the example at data=2, seq=2, the zigzag ring, from JAX's weights
    ex = _load_example("examples/transformer/train_lm_torch.py",
                       "train_lm_torch")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = ex.main(p["example_argv"], init=p["example_tree"])
    out["example"] = dict(printed=buf.getvalue(), losses=run.losses,
                          perm=run.perm)
    return out


def battery_tensor_parallel(comm, p):
    """The mesh's model axis in a 4-rank world, every case of the parity
    tests in ``test_torch_tensor_parallel.py``: the column→row pair at
    model=4 (output and gradients), ``shard_params`` and its gather, the
    flagship's forward at model=4 and data=2,model=2 (``vocab_parallel``
    on and off), its loss, gradients and one AdamW step at data=2,model=2
    and model=2,seq=2, greedy decoding at data=2,model=2, and
    ``train_lm_torch.py``/``generate_torch.py`` at data=2,model=2
    against data=4, the checkpoint saved at one model size and resumed
    at the other.  Returns every case's result on this rank, with the
    flash calls (forward, dq and dk/dv together) of each step: the plain
    versions', which stand on the CPU where the card launches the
    kernels."""
    import contextlib
    import importlib
    import io

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, make_forward_fn, make_generate_fn,
        make_train_step, make_value_and_grad_fn, params_from_jax,
        params_to_numpy)
    from chainermn_tpu_torch.parallel import (
        MeshConfig, column_parallel_dense, row_parallel_dense)
    from chainermn_tpu_torch.parallel.mesh import BATCH_AXES
    from chainermn_tpu_torch.testing import replicas_bitwise
    from chainermn_tpu_torch.utils.serialization import load_state

    out = {"rank": comm.rank}
    fa_mod = importlib.import_module(
        "chainermn_tpu_torch.ops.flash_attention")
    calls = [0, 0]

    def counted(i, fn):
        def call(*a, **kw):
            calls[i] += 1
            return fn(*a, **kw)
        return call

    fa_mod.flash_attention_reference = counted(
        0, fa_mod.flash_attention_reference)
    fa_mod.flash_attention_bwd_reference = counted(
        1, fa_mod.flash_attention_bwd_reference)

    def meshed(axes):
        return MeshConfig(comm, **axes)

    # the column→row pair at model=4: this rank's column block of w1 and
    # row block of w2
    m4 = meshed(dict(model=4))
    x, w1, w2, dz = (torch.as_tensor(a) for a in p["dense"])
    r, F = m4.axis_index("model"), w1.shape[1] // 4
    x = x.clone().requires_grad_()
    w1s = w1[:, r * F:(r + 1) * F].clone().requires_grad_()
    w2s = w2[r * F:(r + 1) * F].clone().requires_grad_()
    model = m4.comm("model")
    z = row_parallel_dense(torch.relu(column_parallel_dense(
        x, w1s, comm=model)), w2s, comm=model)
    grads = torch.autograd.grad((z * dz).sum(), (x, w1s, w2s))
    out["dense"] = [z.detach().numpy()] + [g.numpy() for g in grads]

    # the layout: each rank's shard and the gather of the shards
    out["layout"] = {}
    for name, (axes, fields) in p["layout_cases"].items():
        cfg, mesh = TransformerConfig(**fields), meshed(axes)
        shard = params_from_jax(p["tree"][name], cfg, "cpu", mesh=mesh)
        out["layout"][name] = dict(
            shard=np_tree(shard),
            gathered=params_to_numpy(shard, cfg, mesh=mesh))

    # the flagship's forward
    out["fwd"] = {}
    for name, (axes, fields) in p["fwd_cases"].items():
        cfg, mesh = TransformerConfig(**fields), meshed(axes)
        params = params_from_jax(p["tree"][name], cfg, "cpu", mesh=mesh)
        out["fwd"][name] = make_forward_fn(cfg, mesh=mesh)(
            params, p["x"]).numpy()

    # loss, gradients and one AdamW step; the flash calls of the step;
    # the leaves' bits across the model group (the replicated ones) and
    # across the batch-like group (all of them)
    out["step"] = {}
    x, y = p["x"], p["y"]
    for name, (axes, fields) in p["step_cases"].items():
        cfg, mesh = TransformerConfig(**fields), meshed(axes)
        params = params_from_jax(p["tree"][name], cfg, "cpu", mesh=mesh)
        loss, grads = make_value_and_grad_fn(cfg, mesh=mesh)(params, x, y)
        g_np = params_to_numpy(grads, cfg, mesh=mesh)
        opt = training.adamw(p["lr"])
        state = opt.init(params)
        step = make_train_step(cfg, opt, mesh=mesh)
        calls[:] = [0, 0]
        params, state, step_loss = step(params, state, x, y)
        n_calls = tuple(calls)
        repl = {k: v for k, v in params.items()
                if k not in ("blocks",) and not (
                    k == "embed" and cfg.vocab_parallel)}
        repl["ln"] = [params["blocks"]["ln1"], params["blocks"]["ln2"]]
        out["step"][name] = dict(
            loss=float(loss), step_loss=float(step_loss), grads=g_np,
            params=params_to_numpy(params, cfg, mesh=mesh), calls=n_calls,
            model_bitwise=replicas_bitwise(mesh.comm("model"), repl),
            batch_bitwise=replicas_bitwise(mesh.comm(*BATCH_AXES), params))

    # greedy decoding
    axes, fields = p["gen_case"]
    cfg, mesh = TransformerConfig(**fields), meshed(axes)
    params = params_from_jax(p["gen_tree"], cfg, "cpu", mesh=mesh)
    out["gen"] = make_generate_fn(cfg, max_len=p["gen_max_len"],
                                  mesh=mesh)(params, p["gen_prompt"]).numpy()

    # the examples: data=2,model=2 with the vocabulary sharded against
    # data=4, each checkpoint resumed at the other model size
    ex = _load_example("examples/transformer/train_lm_torch.py",
                       "train_lm_torch")
    runs = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name, argv, ck in p["example_runs"]:
            run = ex.main(p["example_argv"] + argv + ["--checkpoint", ck])
            runs[name] = dict(losses=run.losses, start=run.start)
            if name == p["saved_after"]:
                out["saved"] = {k: v for k, v in load_state(
                    ck + "/lm_state.npz").items()
                    if k in ("params", "opt", "step")}
    out["example"] = runs
    gen = _load_example("examples/transformer/generate_torch.py",
                        "generate_torch")
    out["generate"] = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name, argv in p["generate_runs"].items():
            res = gen.main(argv + ["--checkpoint", p["example_ck"]])
            out["generate"][name] = res.tokens.numpy().copy()
    out["serving"] = _serving(comm, p["serving"])
    return out


def _serving(comm, s):
    """The int8 decoders over meshes, each against this rank's own
    one-rank run of it: greedy, speculative (the target as its own
    draft), prompt lookup and beam search over a 2-rank data axis
    (the world's first half) and a 2-rank model axis (its second half);
    beam search at data=2, seq=2 (the seq-KV cache reordered on each
    member); and at pipe=2, model=2 the int8 tree through
    ``shard_params``/``gather_params`` and greedy decoding."""
    from chainermn_tpu_torch.models import (
        TransformerConfig, make_beam_search_fn, make_generate_fn,
        make_lookup_generate_fn, make_speculative_generate_fn,
        params_from_jax, params_to_numpy, quantize_params_int8,
        regroup_blocks)
    from chainermn_tpu_torch.parallel import MeshConfig

    cfg = TransformerConfig(**s["fields"])
    tree = quantize_params_int8(cfg, s["tree"])
    # the draft is the target itself: every proposal is accepted, so the
    # rounds commit several tokens at once
    dcfg, dtree = cfg, tree
    prompt, T, K = s["prompt"], s["max_len"], s["k"]

    def run(mesh=None):
        kw = dict(device="cpu") if mesh is None else dict(mesh=mesh)
        params = params_from_jax(tree, cfg, "cpu", mesh=mesh)
        d_params = params_from_jax(dtree, dcfg, "cpu", mesh=mesh)
        spec = make_speculative_generate_fn(
            cfg, dcfg, k=K, max_len=T, quantized=True,
            draft_quantized=True, with_stats=True, **kw)(
            params, d_params, prompt)
        look = make_lookup_generate_fn(
            cfg, k=K, max_len=T, quantized=True, with_stats=True, **kw)(
            params, s["pattern"])
        beam = make_beam_search_fn(cfg, beam_size=K, max_len=T,
                                   quantized=True, **kw)(params, prompt)
        return dict(
            greedy=make_generate_fn(cfg, max_len=T, quantized=True, **kw)(
                params, prompt).numpy(),
            spec=(spec[0].numpy(), float(spec[1])),
            lookup=(look[0].numpy(), float(look[1])),
            beam=(beam[0].numpy(), beam[1].numpy()))

    out = {"one": run()}
    half = comm.split(comm.rank // 2, comm.rank)
    out["half"] = run(MeshConfig(half, **({"data": 2} if comm.rank < 2
                                          else {"model": 2})))
    seq = MeshConfig(comm, data=2, seq=2)
    toks, scores = make_beam_search_fn(cfg, beam_size=K, max_len=T,
                                       quantized=True, mesh=seq)(
        params_from_jax(tree, cfg, "cpu", mesh=seq), prompt)
    out["seq_beam"] = (toks.numpy(), scores.numpy())
    pp = MeshConfig(comm, pipe=2, model=2)
    grouped = dict(tree, blocks=regroup_blocks(tree["blocks"], 1, 2))
    params = params_from_jax(grouped, cfg, "cpu", mesh=pp)
    back = params_to_numpy(params, cfg, mesh=pp)

    def same(a, b):
        return a.dtype == b.dtype and np.array_equal(a, b)

    out["pp_round_trip"] = set(back) == set(grouped) \
        and set(back["blocks"]) == set(grouped["blocks"]) \
        and all(same(back[k], grouped[k]) for k in grouped if k != "blocks") \
        and all(same(v, grouped["blocks"][k])
                for k, v in back["blocks"].items())
    out["pp_scale_shape"] = tuple(params["blocks"]["wkv_scale"].shape)
    out["pp_greedy"] = make_generate_fn(cfg, max_len=T, quantized=True,
                                        mesh=pp)(params, prompt).numpy()
    return out


def toy_stage(p, x):
    """The toy stage of the pipeline tests (a tanh dense layer); with
    ``aux`` it also returns a scalar of its output."""
    return torch.tanh(x @ p["w"] + p["b"])


def toy_stage_aux(p, x):
    y = toy_stage(p, x)
    return y, (y * y).mean() * 0.1


def toy_loss(lp, y, tgt):
    return ((y @ lp["head"] - tgt) ** 2).mean()


def battery_pipeline(comm, p):
    """The mesh's pipe axis in a 4-rank world, every case of the parity
    tests in ``test_torch_pipeline.py``: the three schedules on the toy
    stage, the layout, the flagship's forward, its loss, gradients and
    one AdamW step under each schedule (with each step's flash calls and
    whether its pipe-replicated leaves' gradients and parameters are the
    same bits on every stage), pipe-sharded decoding, and
    ``train_lm_torch.py``/``generate_torch.py`` at pipe=2,data=2 against
    data=4 with a checkpoint resumed across the groupings.  Returns
    every case's result on this rank."""
    import contextlib
    import importlib
    import io

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, make_forward_fn, make_generate_fn,
        make_train_step, make_value_and_grad_fn, params_from_jax,
        params_to_numpy)
    from chainermn_tpu_torch.parallel import MeshConfig
    from chainermn_tpu_torch.parallel import pipeline as pp
    from chainermn_tpu_torch.testing import replicas_bitwise

    out = {"rank": comm.rank}
    fa_mod = importlib.import_module(
        "chainermn_tpu_torch.ops.flash_attention")
    calls = [0, 0]

    def counted(i, fn):
        def call(*a, **kw):
            calls[i] += 1
            return fn(*a, **kw)
        return call

    fa_mod.flash_attention_reference = counted(
        0, fa_mod.flash_attention_reference)
    fa_mod.flash_attention_bwd_reference = counted(
        1, fa_mod.flash_attention_bwd_reference)

    def tensors(tree):
        import torch.utils._pytree as pytree
        return pytree.tree_map(torch.as_tensor, tree)

    # the schedules on the toy stage
    toy = p["toy"]
    stages, lp = tensors(toy["stages"]), tensors(toy["lp"])
    x, y = torch.as_tensor(toy["x"]), torch.as_tensor(toy["y"])
    out["toy"] = {}
    for name, case in toy["cases"].items():
        mesh = MeshConfig(comm, pipe=case["S"], data=4 // case["S"])
        pipe = mesh.comm("pipe")
        s, S, M = pipe.rank, pipe.size, case["M"]
        aux = case.get("aux", False)
        fn = toy_stage_aux if aux else toy_stage
        if case["kind"] == "apply":
            q = {k: v.clone().requires_grad_() for k, v in stages[s].items()}
            xx = x.clone().requires_grad_()
            res = pp.pipeline_apply(fn, q, xx, comm=pipe, num_microbatches=M,
                                    with_aux=aux, remat=case["remat"])
            o, a = res if aux else (res, None)
            loss = toy_loss(lp, o, y) + (case["aux_weight"] * a if aux
                                         else 0.0)
            loss.backward()
            out["toy"][name] = dict(
                out=o.detach().numpy(), aux=None if a is None else a.item(),
                gp=np_tree({k: v.grad for k, v in q.items()}),
                dx=xx.grad.numpy())
            continue
        kw = dict(comm=pipe, num_microbatches=M, with_aux=aux)
        if aux:
            kw["aux_weight"] = case["aux_weight"]
        if case["kind"] == "1f1b":
            res = pp.pipeline_train_1f1b(fn, toy_loss, stages[s], lp, x, y,
                                         **kw)
        else:
            V = case["V"]
            res = pp.pipeline_train_interleaved(
                fn, toy_loss, [stages[c * S + s] for c in range(V)], lp, x,
                y, num_chunks=V, **kw)
        out["toy"][name] = np_tree(res)

    # the layout: each rank's shard and the gather of the shards
    out["layout"] = {}
    for name, (axes, fields) in p["layout_cases"].items():
        cfg, mesh = TransformerConfig(**fields), MeshConfig(comm, **axes)
        shard = params_from_jax(p["tree"][name], cfg, "cpu", mesh=mesh)
        out["layout"][name] = dict(
            shard=np_tree(shard),
            gathered=params_to_numpy(shard, cfg, mesh=mesh))

    # the flagship's forward
    out["fwd"] = {}
    for name, (axes, fields) in p["fwd_cases"].items():
        cfg, mesh = TransformerConfig(**fields), MeshConfig(comm, **axes)
        params = params_from_jax(p["tree"][name], cfg, "cpu", mesh=mesh)
        out["fwd"][name] = make_forward_fn(cfg, mesh=mesh)(
            params, p["x"]).numpy()

    # loss, gradients and one AdamW step; the flash calls of the step; the
    # pipe-replicated leaves' bits across the pipe group
    out["step"] = {}
    x, y = p["x"], p["y"]
    for name, (axes, fields) in p["step_cases"].items():
        cfg = TransformerConfig(**fields)
        mesh = None if axes is None else MeshConfig(comm, **axes)
        dev = "cpu" if mesh is None else None
        params = params_from_jax(p["tree"][name], cfg, "cpu", mesh=mesh)
        loss, grads = make_value_and_grad_fn(cfg, device=dev, mesh=mesh)(
            params, x, y)
        g_np = params_to_numpy(grads, cfg, mesh=mesh)
        repl = [k for k in ("embed", "pos", "ln_f") if k in params]
        opt = training.adamw(p["lr"])
        state = opt.init(params)
        step = make_train_step(cfg, opt, device=dev, mesh=mesh)
        calls[:] = [0, 0]
        params, state, step_loss = step(params, state, x, y)
        n_calls = tuple(calls)
        pipe_bitwise = None
        if mesh is not None:
            pipe = mesh.comm("pipe")
            pipe_bitwise = (
                replicas_bitwise(pipe, [grads[k] for k in repl])
                and replicas_bitwise(pipe, [params[k] for k in repl]))
        out["step"][name] = dict(
            loss=float(loss), step_loss=float(step_loss), grads=g_np,
            params=params_to_numpy(params, cfg, mesh=mesh), calls=n_calls,
            pipe_bitwise=pipe_bitwise)

    # greedy decoding
    out["gen"] = {}
    for name, (axes, fields) in p["gen_cases"].items():
        cfg, mesh = TransformerConfig(**fields), MeshConfig(comm, **axes)
        params = params_from_jax(p["gen_tree"][name], cfg, "cpu", mesh=mesh)
        out["gen"][name] = make_generate_fn(
            cfg, max_len=p["gen_max_len"], mesh=mesh)(
            params, p["gen_prompt"]).numpy()

    # the examples: pipe=2,data=2 (1F1B) against data=4, each checkpoint
    # resumed at the other grouping; generate_torch.py on the pipe=2
    # checkpoint at pipe=2 and at data=4
    ex = _load_example("examples/transformer/train_lm_torch.py",
                       "train_lm_torch")
    runs = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name, argv, ck in p["example_runs"]:
            run = ex.main(p["example_argv"] + argv + ["--checkpoint", ck])
            runs[name] = dict(losses=run.losses, start=run.start)
    out["example"] = runs
    gen = _load_example("examples/transformer/generate_torch.py",
                        "generate_torch")
    out["generate"] = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name, argv in p["generate_runs"].items():
            res = gen.main(argv + ["--checkpoint", p["example_ck"]])
            out["generate"][name] = res.tokens.numpy().copy()
    return out


def moe_expert_fn(p, tokens):
    """The MoE tests' expert FFN on a rank's local experts at once."""
    return torch.relu(tokens @ p["w1"]) @ p["w2"]


def battery_expert_parallel(comm, p):
    """The mesh's expert axis in a 4-rank world, every case of the
    parity tests in ``test_torch_expert_parallel.py``: the MoE layer at
    each expert grouping (its routing, slots against the dense
    reference's, output and aux), the flagship's forward, its loss,
    gradients and one AdamW step (whether its leaves replicated over
    the expert group come out the same bits on every member), MoE
    decoding, and ``train_lm_torch.py``/``generate_torch.py`` with
    ``--moe`` over ``data=2,expert=2``.  Returns every case's result on
    this rank."""
    import contextlib
    import io

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, make_forward_fn, make_generate_fn,
        make_train_step, make_value_and_grad_fn, params_from_jax,
        params_to_numpy)
    from chainermn_tpu_torch.parallel import MeshConfig
    from chainermn_tpu_torch.parallel import expert as ep
    from chainermn_tpu_torch.testing import replicas_bitwise

    out = {"rank": comm.rank, "layer": {}}
    # the layer: mesh data=4/S, expert=S; this rank's block of the
    # tokens (row-major over data, expert) and of the experts
    for name, case in p["layer_cases"].items():
        S = case["S"]
        mesh = MeshConfig(comm, data=4 // S, expert=S)
        e = mesh.axis_index("expert")
        i = mesh.axis_index("data") * S + e
        x = torch.as_tensor(case["x"]).chunk(4)[i]
        rw = torch.as_tensor(case["router"])
        E = rw.shape[1]
        local = {k: torch.as_tensor(case[k]).chunk(S)[e]
                 for k in ("w1", "w2")}
        ep.expert_parallel_moe.routings = log = []
        y, aux = ep.expert_parallel_moe(
            x, rw, local, moe_expert_fn, comm=mesh.comm("expert"),
            capacity_factor=case["cf"], top_k=case["k"])
        ep.expert_parallel_moe.routings = None
        r = log[0]
        whole = {k: torch.as_tensor(case[k]) for k in ("w1", "w2")}
        _, _, dense_slots = ep._moe_dense_reference(
            x, rw, whole, moe_expert_fn, capacity_factor=case["cf"],
            top_k=case["k"])
        out["layer"][name] = dict(
            out=y.numpy(), aux=float(aux), top_i=r.top_i.numpy(),
            keep=r.keep.numpy(), pos=r.pos.numpy(),
            slot_token=r.slot_token.numpy(), dropped=int(r.dropped),
            slots=ep.dispatch(x, r).numpy(), dense_slots=dense_slots.numpy(),
            E=E)

    # the flagship's forward
    out["fwd"] = {}
    for name, (axes, fields) in p["fwd_cases"].items():
        cfg, mesh = TransformerConfig(**fields), MeshConfig(comm, **axes)
        params = params_from_jax(p["tree"][name], cfg, "cpu", mesh=mesh)
        out["fwd"][name] = make_forward_fn(cfg, mesh=mesh)(
            params, p["x"]).numpy()

    # loss, gradients and one AdamW step; the replicated leaves' bits
    # across the expert group; the drops of the step's first forward
    out["step"] = {}
    x, y = p["x"], p["y"]
    for name, (axes, fields) in p["step_cases"].items():
        cfg, mesh = TransformerConfig(**fields), MeshConfig(comm, **axes)
        params = params_from_jax(p["tree"][name], cfg, "cpu", mesh=mesh)
        ep.expert_parallel_moe.routings = log = []
        loss, grads = make_value_and_grad_fn(cfg, mesh=mesh)(params, x, y)
        ep.expert_parallel_moe.routings = None
        g_np = params_to_numpy(grads, cfg, mesh=mesh)
        opt = training.adamw(p["lr"])
        state = opt.init(params)
        step = make_train_step(cfg, opt, mesh=mesh)
        params, state, step_loss = step(params, state, x, y)
        repl = [v for k, v in params.items() if k != "blocks"] + [
            v for k, v in params["blocks"].items() if k not in ("w1", "w2")]
        out["step"][name] = dict(
            loss=float(loss), step_loss=float(step_loss), grads=g_np,
            params=params_to_numpy(params, cfg, mesh=mesh),
            dropped=[int(r.dropped) for r in log],
            expert_bitwise=replicas_bitwise(mesh.comm("expert"), repl))

    # "dots" remat against full remat on the step cases' meshes
    out["dots"] = {}
    for name in p["dots_cases"]:
        axes, fields = p["step_cases"][name]
        cfg, mesh = TransformerConfig(**fields), MeshConfig(comm, **axes)
        params = params_from_jax(p["tree"][name], cfg, "cpu", mesh=mesh)
        out["dots"][name] = dots_against_full(cfg, mesh, params, x, y)

    # greedy decoding
    out["gen"] = {}
    for name, (axes, fields) in p["gen_cases"].items():
        cfg, mesh = TransformerConfig(**fields), MeshConfig(comm, **axes)
        params = params_from_jax(p["gen_tree"][name], cfg, "cpu", mesh=mesh)
        out["gen"][name] = make_generate_fn(
            cfg, max_len=p["gen_max_len"], mesh=mesh)(
            params, p["gen_prompt"]).numpy()

    # the examples: --moe over data=2,expert=2 from the JAX weights, its
    # checkpoint resumed at data=4 with as many experts; generate_torch.py
    # on the checkpoint over data=2,expert=2 and over data=4
    ex = _load_example("examples/transformer/train_lm_torch.py",
                       "train_lm_torch")
    gen = _load_example("examples/transformer/generate_torch.py",
                        "generate_torch")
    buf = io.StringIO()
    ck = p["example_ck"]
    with contextlib.redirect_stdout(buf):
        run = ex.main(p["example_argv"] + ["--checkpoint", ck],
                      init=p["example_tree"])
        printed = buf.getvalue()
        again = ex.main(p["resume_argv"] + ["--checkpoint", ck])
        toks = {name: gen.main(argv + ["--checkpoint", ck]).tokens.numpy()
                for name, argv in p["generate_runs"].items()}
    out["example"] = dict(printed=printed, losses=run.losses,
                          resumed=again.losses, start=again.start,
                          generate=toks)
    return out


# --------------------------------------------------------------------- #
# ZeRO-1/2 and FSDP
# --------------------------------------------------------------------- #


def zero_inner(name):
    """The inner optimizers of the ZeRO cases (optax's ``sgd`` with
    momentum, ``adam`` as ``adamw`` without decay)."""
    from chainermn_tpu_torch import training

    return {"sgd": lambda: training.sgd(0.1, momentum=0.9),
            "adam": lambda: training.adamw(1e-2, weight_decay=0.0)}[name]()


def battery_zero(comm, p):
    """ZeRO-1 and ZeRO-2 in a 4-rank world, every case of
    ``test_torch_zero.py``: ``create_multi_node_optimizer`` updates on
    per-rank gradients (the parameters and each rank's state), the
    optimizers under ``StandardUpdater`` (fused windows, the overlap
    hooks), and a ZeRO-1 trainer's checkpoint resumed exactly and
    refused under ZeRO-2."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.training.elastic import topology_signature

    r = comm.rank
    out = {"rank": r, "runs": {}, "updater": {}}
    for name, case in p["runs"].items():
        kw = dict(case)
        opt = training.create_multi_node_optimizer(
            zero_inner(kw.pop("inner")), comm, **kw)
        params = {k: torch.tensor(v) for k, v in p["params"].items()}
        state = opt.init(params)
        for _ in range(p["steps"]):
            opt.update({k: torch.tensor(v) for k, v in
                        p["grads"][r].items()}, state, params)
        out["runs"][name] = dict(
            params=np_tree(params),
            state=np_tree(training.optimizer_state_tree(state)),
            signature=topology_signature(
                comm, params, state,
                sharding=getattr(opt, "sharding", None)))

    # the updater: its mode, fused windows of two updates, the overlap
    # hooks of a window's last microbatch
    data = linear_dataset()
    for name, case in p["updater"].items():
        kw = dict(case)
        up_kw = {k: kw.pop(k) for k in ("steps_per_execution",
                                        "accum_steps") if k in kw}
        it = SerialIterator(data[r::comm.size], batch_size=4,
                            shuffle=False)
        opt = training.create_multi_node_optimizer(
            zero_inner(kw.pop("inner")), comm, **kw)
        up = training.StandardUpdater(
            it, opt, linear_loss,
            {"w": torch.zeros(4), "b": torch.zeros(())}, comm, **up_kw)
        losses = []
        for _ in range(3):
            up.update()
            losses.append(float(up.observation["main/loss"]))
        out["updater"][name] = dict(status=up.status(), losses=losses,
                                    params=np_tree(up.params))

    # a ZeRO-1 trainer (adam: state of its own) resumed at the same world
    root = Path(p["root"])
    adam = lambda: zero_inner("adam")  # noqa: E731
    trainer, up, _, _ = linear_job(comm, root / "straight", ckpt_every=None,
                                   inner=adam(), zero1=True)
    trainer.run()
    stopped, _, _, _ = linear_job(comm, root / "resume", epochs=3,
                                  inner=adam(), zero1=True)
    stopped.run()
    t2, up2, cp2, _ = linear_job(comm, root / "resume", inner=adam(),
                                 zero1=True)
    resumed = cp2.maybe_load(up2, t2)
    t2.run()
    out["resume"] = dict(
        at=resumed, straight=np_tree(up.params), again=np_tree(up2.params),
        straight_state=np_tree(training.optimizer_state_tree(up.opt_state)),
        again_state=np_tree(training.optimizer_state_tree(up2.opt_state)))
    _, up3, cp3, _ = linear_job(comm, root / "resume", inner=adam(),
                                zero2=True)
    try:
        cp3.maybe_load(up3)
        out["resume"]["other_mode"] = None
    except RuntimeError as e:
        out["resume"]["other_mode"] = str(e)
    return out


def _mlp_fsdp(comm, p, wire=None):
    """The generic FSDP MLP of ``test_fsdp_generic.py`` at data=4:
    ``ShardedState`` places every leaf, the step gathers the tree, the
    gradients of the sharded leaves leave the gathers' backward summed
    over the ranks (divided by the ranks here), a whole leaf's are
    meaned; adam on the shards.  Returns the losses, this rank's
    parameters and moments' shapes, and the whole parameters."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.parallel import ShardedState, fsdp_gather

    n, r = comm.size, comm.rank
    full = {k: torch.tensor(v) for k, v in p["mlp"].items()}
    sharded = ShardedState(full, comm, wire_dtype=wire)
    local = sharded.place(full)
    state = sharded.init_opt_state(training.adamw(1e-2, weight_decay=0.0))
    x = torch.tensor(p["mlp_x"]).chunk(n)[r]
    y = torch.tensor(p["mlp_y"]).chunk(n)[r]
    dims = sharded.dims
    opt = training.adamw(1e-2, weight_decay=0.0)
    losses = []
    for _ in range(p["mlp_steps"]):
        leaves = {k: v.requires_grad_() for k, v in local.items()}
        w = sharded.gather(leaves)
        h = torch.relu(x @ w["w1"] + w["b1"])
        loss = torch.mean((h @ w["w2"] - y) ** 2)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        grads = {k: g / n if dims[k] is not None
                 else comm.allreduce(g, "mean") for k, g in grads.items()}
        opt.update(grads, state, local)
        losses.append(float(comm.allreduce(loss.detach(), "mean")))
    whole = fsdp_gather({k: v.detach() for k, v in local.items()}, dims,
                        comm)
    mu = [tuple(state.state[t]["mu"].shape) for t in local.values()]
    return dict(losses=losses, whole=np_tree(whole), dims=dict(dims),
                local={k: tuple(v.shape) for k, v in local.items()}, mu=mu)


def battery_fsdp(comm, p):
    """FSDP in a 4-rank world, every case of ``test_torch_fsdp.py``: the
    generic MLP, the layer stream's forward and its window, and the
    flagship under ``fsdp`` on each mesh (3 steps with and without it:
    losses, parameters, the moments' widths, each rank's gathers, the
    leaves replicated over data), the bf16 wire, the moments re-laid
    with FSDP on and off, and ``train_lm_torch.py --fsdp``."""
    import contextlib
    import dataclasses
    import io
    import shutil

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, make_train_step, params_from_jax,
        params_to_numpy, reshard_train_state)
    from chainermn_tpu_torch.models.transformer import _fsdp_dims
    from chainermn_tpu_torch.parallel import MeshConfig, ShardedState
    from chainermn_tpu_torch.parallel.fsdp import fsdp_gather
    from chainermn_tpu_torch.testing import replicas_bitwise

    r = comm.rank
    out = {"rank": r, "mlp": _mlp_fsdp(comm, p),
           "mlp_bf16": _mlp_fsdp(comm, p, torch.bfloat16)["losses"]}

    # the layer stream: its forward on this rank's rows, the layers alive
    layers = {k: {n: torch.tensor(v) for n, v in layer.items()}
              for k, layer in p["stream_params"].items()}
    sharded = ShardedState(layers, comm)
    local = sharded.place(layers)
    x = torch.tensor(p["stream_x"]).chunk(comm.size)[r]
    out["stream"] = {}
    for window in (1, 2):
        stream = sharded.gather_stream(local, window=window)
        h, live = x, []
        for i in range(len(stream)):
            w = stream.layer(i)
            live.append(len(stream.live))
            h = h @ w["w"] + w["b"]
            if i + 1 < len(stream):
                h = torch.relu(h)
            h = stream.retire(i, h)
        out["stream"][window] = dict(out=h.numpy(), live=live,
                                     issued=list(stream.issued),
                                     names=stream.names)

    # the flagship on each mesh, with and without FSDP
    xs, ys = p["x"], p["y"]
    out["step"] = {}
    for name, (axes, fields) in p["cases"].items():
        for fsdp in (True, False):
            cfg = TransformerConfig(**dict(fields, fsdp=fsdp))
            mesh = MeshConfig(comm, **axes)
            params = params_from_jax(p["tree"][name], cfg, "cpu", mesh=mesh)
            opt = training.adamw(p["lr"], weight_decay=0.0)
            state = opt.init(params)
            step = make_train_step(cfg, opt, mesh=mesh)
            fsdp_gather.gathers = 0
            losses = []
            for _ in range(p["steps"]):
                params, state, loss = step(params, state, xs, ys)
                losses.append(float(loss))
            gathers = fsdp_gather.gathers
            fs = set(_fsdp_dims(cfg)) if fsdp else set()
            repl = [v for k, v in params.items() if k != "blocks"] + [
                v for k, v in params["blocks"].items() if k not in fs]
            out["step"][(name, fsdp)] = dict(
                losses=losses, gathers=gathers,
                params=params_to_numpy(params, cfg, mesh=mesh),
                shapes={k: tuple(v.shape)
                        for k, v in params["blocks"].items()},
                mu={k: tuple(state.state[v]["mu"].shape)
                    for k, v in params["blocks"].items()},
                data_bitwise=replicas_bitwise(mesh.comm("data"), repl))

    # the bf16 wire at data=4
    cfg = TransformerConfig(**dict(p["cases"]["data4"][1], fsdp=True,
                                   fsdp_wire_dtype="bfloat16"))
    mesh = MeshConfig(comm, data=4)
    params = params_from_jax(p["tree"]["data4"], cfg, "cpu", mesh=mesh)
    opt = training.adamw(p["lr"], weight_decay=0.0)
    state = opt.init(params)
    step = make_train_step(cfg, opt, mesh=mesh)
    out["bf16"] = [float(step(params, state, xs, ys)[2])
                   for _ in range(p["steps"])]

    # the moments re-laid with FSDP on and off (either direction): the
    # next step's loss after 3 steps of either run
    out["reshard"] = {}
    for fsdp in (True, False):
        cfg = TransformerConfig(**dict(p["cases"]["data4"][1], fsdp=fsdp))
        params = params_from_jax(p["tree"]["data4"], cfg, "cpu", mesh=mesh)
        opt = training.adamw(p["lr"], weight_decay=0.0)
        state = opt.init(params)
        step = make_train_step(cfg, opt, mesh=mesh)
        for _ in range(p["steps"]):
            step(params, state, xs, ys)
        saved = params_to_numpy(params, cfg, mesh=mesh)
        moments = training.map_state_moments(
            training.optimizer_state_tree(state), params,
            lambda t, cfg=cfg: params_to_numpy(t, cfg, mesh=mesh))
        for to in (True, False):
            c2 = dataclasses.replace(cfg, fsdp=to)
            p2, s2 = reshard_train_state(mesh, c2, opt, saved, moments)
            loss = make_train_step(c2, opt, mesh=mesh)(p2, s2, xs, ys)[2]
            out["reshard"][(fsdp, to)] = dict(
                loss=float(loss), w1=tuple(p2["blocks"]["w1"].shape),
                mu=tuple(s2.state[p2["blocks"]["w1"]]["mu"].shape))

    # train_lm_torch.py --fsdp over data=4, resumed with --fsdp on and off
    ex = _load_example("examples/transformer/train_lm_torch.py",
                       "train_lm_torch")
    ck = Path(p["example_ck"])
    with contextlib.redirect_stdout(io.StringIO()):
        first = ex.main(p["example_argv"] + ["--fsdp", "--checkpoint",
                                             str(ck / "a")]).losses
        if r == 0:
            shutil.copytree(ck / "a", ck / "b")
        comm.barrier()
        on = ex.main(p["resume_argv"] + ["--fsdp", "--checkpoint",
                                         str(ck / "a")])
        off = ex.main(p["resume_argv"] + ["--checkpoint", str(ck / "b")])
    out["example"] = dict(first=first, on=on.losses, off=off.losses,
                          start=(on.start, off.start))
    return out


# --------------------------------------------------------------------- #
# the n-step RNN over ranks (test_torch_n_step_rnn.py)
# --------------------------------------------------------------------- #


def battery_n_step_rnn(comm, p):
    """Every case of ``p["cases"]`` (``n_layers, n_stages, cell, xs,
    mask, params, grad``) through ``create_multi_node_n_step_rnn`` on
    this world: the chain's ``(ys, hy, cy)`` on this rank, and with
    ``grad`` the reduced gradients of ``sum(ys ** 2)`` of the stages it
    owns; beside them the port's own sequential stack on one rank
    (``stage_apply`` over every layer), its gradients in the chain's
    structure."""
    import torch.utils._pytree as pytree

    from chainermn_tpu_torch.links import create_multi_node_n_step_rnn
    from chainermn_tpu_torch.links.n_step_rnn import stage_apply
    from chainermn_tpu_torch.models import chain_params_from_jax

    out = {}
    for name, c in p["cases"].items():
        chain = create_multi_node_n_step_rnn(
            c["n_layers"], c["xs"].shape[-1], p["d_hidden"], c["n_stages"],
            comm=comm, cell=c["cell"])
        params = chain.load_params(chain_params_from_jax(c["params"], chain))
        ys, hy, cy = chain((c["xs"], c["mask"]))
        res = dict(ys=ys.detach().numpy().copy(),
                   hy=hy.detach().numpy().copy(),
                   cy=cy.detach().numpy().copy())
        if c["grad"]:
            (ys ** 2).sum().backward()
            res["grads"] = [None if g is None else np_tree(g)
                            for g in chain.reduce_grads(chain.grads())]
        # the sequential stack on this rank alone
        seq = [pytree.tree_map(lambda a: torch.tensor(a, requires_grad=True),
                               layer)
               for stage in c["params"] for layer in stage]
        s_ys, s_hy, s_cy = stage_apply(seq, torch.tensor(c["xs"]),
                                       torch.tensor(c["mask"]), c["cell"])
        res["seq"] = dict(ys=s_ys.detach().numpy().copy(),
                          hy=s_hy.detach().numpy().copy(),
                          cy=s_cy.detach().numpy().copy())
        if c["grad"]:
            (s_ys ** 2).sum().backward()
            flat = iter(np_tree(pytree.tree_map(lambda t: t.grad, seq)))
            res["seq"]["grads"] = [[next(flat) for _ in stage]
                                   for stage in c["params"]]
        out[name] = res
        del params
    return out


# --------------------------------------------------------------------- #
# elastic resume (test_torch_elastic.py)
# --------------------------------------------------------------------- #


def elastic_data():
    """The elastic drills' regression set: 5 features to 3 targets."""
    import numpy as np

    rng = np.random.RandomState(0)
    x = rng.randn(64, 5).astype(np.float32)
    y = (x @ rng.randn(5, 3)).astype(np.float32)
    return [(x[i], y[i]) for i in range(64)]


def elastic_job(comm, root, shard_only=False, elastic=True, history=1):
    """A ZeRO-1 ``adam(1e-2)`` job whose leaves do not divide over 4 or
    2 ranks (``w`` 15 and ``b`` 3 elements), batch 4 of this rank's
    slice of :func:`elastic_data`, and its checkpointer (not extended:
    the drills save through the fault injector or by hand).  Returns
    ``(trainer, updater, checkpointer)``."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )
    from chainermn_tpu_torch.iterators import SerialIterator

    def loss(params, x, y):
        return torch.mean((x @ params["w"] + params["b"] - y) ** 2)

    it = SerialIterator(elastic_data()[comm.rank::comm.size], batch_size=4,
                        shuffle=False)
    opt = training.create_multi_node_optimizer(training.adam(1e-2), comm,
                                               zero1=True)
    up = training.StandardUpdater(
        it, opt, loss, {"b": torch.zeros(3), "w": torch.zeros(5, 3)}, comm)
    trainer = training.Trainer(up, stop_trigger=(10, "iteration"),
                               out=str(Path(root) / "out"))
    cp = create_multi_node_checkpointer(comm, str(Path(root) / "ckpt"),
                                        shard_only=shard_only,
                                        elastic=elastic, history=history)
    return trainer, up, cp


def _elastic_state(up):
    from chainermn_tpu_torch import training

    return dict(params=np_tree(up.params), iteration=int(up.iteration),
                opt=np_tree(training.optimizer_state_tree(up.opt_state)))


def battery_elastic_save(comm, p):
    """World 4 (or the grow drill's 2): ``FaultPlan(resize_at_iteration,
    resize_to)`` saves a full set and a shard-only set and stops the
    trainer; each rank's state then, and a same-topology resume of each
    set (the exact path, bitwise)."""
    from chainermn_tpu_torch.testing import FaultInjector, FaultPlan

    out = {}
    for name, shard_only in (("full", False), ("shard", True)):
        root = Path(p["root"]) / name
        trainer, up, cp = elastic_job(comm, root, shard_only=shard_only)
        injector = FaultInjector(FaultPlan(
            resize_at_iteration=p["at"], resize_to=p["to"]), comm,
            checkpointer=cp)
        trainer.extend(injector, trigger=(1, "iteration"))
        trainer.run()
        out[name] = dict(saved=_elastic_state(up), fired=injector.fired)
        _, again, cp2 = elastic_job(comm, root, shard_only=shard_only)
        out[name]["resumed_at"] = cp2.maybe_load(again)
        out[name]["mode"] = cp2.last_resume_mode
        out[name]["again"] = _elastic_state(again)
    return out


def battery_elastic_resume(comm, p):
    """A smaller or larger world: each set of ``p["sets"]`` resumed by an
    ``elastic=True`` checkpointer (the state, the path taken), one more
    update; a default checkpointer's refusal; and with ``p["save_to"]``
    the resumed full-set job saved here (the grow drill's source)."""
    out = {}
    for name in p["sets"]:
        root = Path(p["root"]) / name
        _, up, cp = elastic_job(comm, root)
        at = cp.maybe_load(up)
        out[name] = dict(at=at, mode=cp.last_resume_mode,
                         state=_elastic_state(up))
        up.update()
        out[name]["after"] = _elastic_state(up)
        if name == "full" and p.get("save_to"):
            _, _, cp_to = elastic_job(comm, p["save_to"])
            cp_to.save(up)
    _, up, cp = elastic_job(comm, Path(p["root"]) / "full", elastic=False)
    try:
        cp.maybe_load(up)
        out["refused"] = None
    except RuntimeError as e:
        out["refused"] = str(e)
    return out


# --------------------------------------------------------------------- #
# the metrics registry (test_torch_metrics.py)
# --------------------------------------------------------------------- #


def battery_merge_metrics(comm, rows):
    """``merge_metrics`` of this rank's registry (row ``rank`` of
    ``rows``): the merged snapshot and its Prometheus text."""
    from chainermn_tpu_torch.utils.metrics import (
        MetricsRegistry,
        merge_metrics,
        to_prometheus,
    )

    reg = MetricsRegistry(enabled=True)
    reg.load(rows[comm.rank])
    merged = merge_metrics(comm, reg)
    return merged.snapshot(), to_prometheus(merged,
                                            labels={"rank": "merged"})


# --------------------------------------------------------------------- #
# the live resize (test_torch_live_resize.py)
# --------------------------------------------------------------------- #

LIVE_N, LIVE_DIM, LIVE_CLASSES, LIVE_BATCH = 96, 6, 3, 16


def live_dataset():
    """The JAX live-resize tests' set: 96 examples of 6 features, 3
    classes."""
    rng = np.random.RandomState(0)
    return [(rng.randn(LIVE_DIM).astype(np.float32),
             np.int32(i % LIVE_CLASSES)) for i in range(LIVE_N)]


def live_params():
    """The MLP ``[6, 12, 3]``'s weights from a seed (He init, numpy)."""
    rng = np.random.RandomState(1)
    out = []
    for fan_in, fan_out in ((LIVE_DIM, 12), (12, LIVE_CLASSES)):
        out.append({"b": np.zeros(fan_out, np.float32),
                    "w": (rng.randn(fan_in, fan_out)
                          * np.sqrt(2.0 / fan_in)).astype(np.float32)})
    return out


def live_world(n):
    """A communicator over the launch's ranks ``[0, n)`` (every rank
    calls it; ``None`` outside)."""
    from chainermn_tpu_torch.communicators import create_communicator

    return create_communicator("tpu_xla", device="cpu", ranks=range(n))


def live_opt(comm):
    from chainermn_tpu_torch import training

    return training.create_multi_node_optimizer(training.adam(5e-2), comm,
                                                zero1=True)


def live_updater(comm, prefetch=0, max_inflight=None, iterator=None,
                 converter=None):
    """The JAX tests' job on the global-batch feed: every rank iterates
    the whole set in the same shuffled order (batch 16, seed 7) and
    takes its rows."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.iterators import (
        GlobalBatchConverter,
        SerialIterator,
    )
    from chainermn_tpu_torch.models import mlp_apply, softmax_cross_entropy

    it = iterator if iterator is not None else SerialIterator(
        live_dataset(), LIVE_BATCH, shuffle=True, seed=7)
    params = [{k: torch.tensor(v) for k, v in layer.items()}
              for layer in live_params()]

    def loss_fn(p, x, y):
        return softmax_cross_entropy(mlp_apply(p, x), y)

    kw = {} if max_inflight is None else dict(max_inflight=max_inflight)
    return training.StandardUpdater(
        it, live_opt(comm), loss_fn, params, comm,
        converter=converter or GlobalBatchConverter(comm),
        prefetch=prefetch, **kw)


def _live_state(up):
    from chainermn_tpu_torch import training

    return dict(params=np_tree(up.params), iteration=int(up.iteration),
                world=int(up.comm.size),
                opt=np_tree(training.optimizer_state_tree(up.opt_state)))


def _updates(up, k):
    out = []
    for _ in range(k):
        up.update()
        out.append(float(up.observation["main/loss"]))
    return out


def _live_drill(comm, root):
    """The acceptance drill on the global-batch feed: arm B, live
    (``FaultPlan(resize_live_at_iteration=2, resize_live_to=2)``, a
    second plan back to 4 at iteration 4, stop at 6: ranks 2 and 3
    parked in between), and arm A, the save/restart chain at the same
    boundaries (fresh jobs resumed by ``elastic=True`` checkpointers at
    4, 2 and 4).  Each rank's losses (the job's ``LogReport``, which a
    joining rank takes from rank 0), final state and the records."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )
    from chainermn_tpu_torch.testing import FaultInjector, FaultPlan
    from chainermn_tpu_torch.training.elastic import ResizeController

    r = comm.rank
    # arm B: the live path
    c4 = live_world(4)
    up = live_updater(c4)
    trainer = training.Trainer(up, (6, "iteration"),
                               out=str(Path(root) / "b"))
    ctrl = ResizeController(live_world, live_opt)
    log = training.LogReport(trigger=(1, "iteration"))
    shrink, grow = (FaultInjector(FaultPlan(resize_live_at_iteration=at,
                                            resize_live_to=to), c4,
                                  resize_controller=ctrl)
                    for at, to in ((2, 2), (4, 4)))
    for ext in (log, shrink, grow, ctrl):
        trainer.extend(ext)
    trainer.run()
    live = dict(losses={e["iteration"]: e["main/loss"] for e in log.log},
                state=_live_state(up), resizes=ctrl.resizes,
                fired=shrink.fired + grow.fired, closed=c4.closed,
                stop=trainer.stop_reason)
    up.comm.close()

    # arm A: save/restart at the same boundaries
    ck = str(Path(root) / "a")
    a4 = live_world(4)
    up = live_updater(a4)
    losses = dict(enumerate(_updates(up, 2), 1))
    create_multi_node_checkpointer(a4, ck, elastic=True).save(up)
    a4.close()
    a2 = live_world(2)              # None on ranks 2 and 3
    if a2 is not None:
        up = live_updater(a2)
        cp = create_multi_node_checkpointer(a2, ck, elastic=True)
        resumed2 = (cp.maybe_load(up), cp.last_resume_mode)
        losses.update(dict(enumerate(_updates(up, 2), 3)))
        cp.save(up)
        a2.close()
    else:
        resumed2 = None
    a4 = live_world(4)
    up = live_updater(a4)
    cp = create_multi_node_checkpointer(a4, ck, elastic=True)
    resumed4 = (cp.maybe_load(up), cp.last_resume_mode)
    got = _updates(up, 2)
    losses.update({5: got[0], 6: got[1]})
    restart = dict(losses=losses, state=_live_state(up),
                   resumed=(resumed2, resumed4))
    a4.close()
    return dict(live=live, restart=restart)


def battery_live_control(comm, p):
    """The live resize's control plane over the world's store (the JAX
    ``scenario_elastic_membership`` and ``scenario_resize_live``), with
    no process group: ``ElasticMembership`` agrees epoch 1 over every
    rank, a channel fenced to it refuses a message published before the
    fence and delivers the next one, a relaunched membership on the same
    path agrees epoch 2; the last rank posts ``post_resize_intent(n)``,
    every rank reads it and the OR-agreement resolves to it everywhere,
    the epoch bumps, the intent is cleared on every rank.  Returns what
    each check saw and ``ok``."""
    import os

    from chainermn_tpu_torch.communicators import (
        KVObjectChannel,
        StaleGenerationError,
    )
    from chainermn_tpu_torch.training.elastic import (
        ElasticMembership,
        ResizeController,
        post_resize_intent,
    )

    me, n = comm.rank, comm.size
    store = comm.store
    boot = KVObjectChannel(tag="live-control-boot", store=store)

    def barrier():
        boot.allgather(None, list(range(n)), me)

    def stale_then_live(membership, tag):
        chan = KVObjectChannel(tag=tag, store=store)
        if me == 0:
            chan.send("before the fence", src=0, dst=1)
        membership.fence(chan)
        if me == 0:
            chan.send({"epoch": membership.record.epoch}, src=0, dst=1)
        if me != 1:
            return None
        try:
            chan.recv(src=0, dst=1)
            refused = False
        except StaleGenerationError:
            refused = True
        return refused, chan.recv(src=0, dst=1)

    out = {}
    path = os.path.join(p["root"], "membership")
    m = ElasticMembership(comm, path=path)
    rec = m.agree()
    out["membership"] = dict(epoch=rec.epoch, members=rec.members,
                             rank=rec.rank_of(me))
    out["fence"] = stale_then_live(m, "live-control-data")
    rec2 = ElasticMembership(comm, path=path).agree()
    out["relaunch_epochs"] = boot.allgather((rec.epoch, rec2.epoch),
                                            list(range(n)), me)

    path = os.path.join(p["root"], "resize")
    membership = ElasticMembership(comm, path=path)
    ctrl = ResizeController(comm_factory=lambda w: comm,
                            optimizer_factory=lambda c: None,
                            membership=membership)
    out["intent_before"] = ctrl._kv_intent(comm)
    barrier()
    if me == n - 1:
        post_resize_intent(n, reason="control drill")
    barrier()
    out["intent_seen"] = ctrl._kv_intent(comm)
    mine = ctrl._kv_intent(comm) if me == n - 1 else None
    seen = [r for r in boot.allgather(mine, list(range(n)), me)
            if r is not None]
    out["agreed"] = max(seen) if seen else None
    rec = membership.agree()
    out["resize_epoch"] = rec.epoch
    out["resize_fence"] = stale_then_live(membership, "live-control-resize")
    ctrl._clear_kv_intent(comm)
    barrier()
    out["intent_after"] = ctrl._kv_intent(comm)
    barrier()
    out["ok"] = (
        out["membership"] == dict(epoch=1, members=list(range(n)), rank=me)
        and out["relaunch_epochs"] == [(1, 2)] * n
        and out["intent_before"] is None and out["intent_seen"] == n
        and out["agreed"] == n and out["resize_epoch"] == 1
        and out["intent_after"] is None
        and all(f is None or f == (True, {"epoch": 1})
                for f in (out["fence"], out["resize_fence"]))
        and (me != 1 or out["fence"] == (True, {"epoch": 1})))
    # the verdict of every rank, on every rank
    out["ok"] = all(boot.allgather(out["ok"], list(range(n)), me))
    return out


def _live_job(root, stop=100, **kw):
    """``(trainer, updater, controller)`` of a job on the world of 4."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.training.elastic import ResizeController

    up = live_updater(live_world(4), **kw)
    trainer = training.Trainer(up, (stop, "iteration"), out=str(root))
    return trainer, up, ResizeController(live_world, live_opt)


def _release(ctrl, trainer, up):
    """End a case: rank 0 posts the job's end (parked ranks stop) and
    the members close their world."""
    ctrl.finalize(trainer)
    if not ctrl.parked:
        up.comm.close()


def _case_direct(root):
    """The JAX acceptance case by direct ``resize`` calls: 2 updates at
    4, 3 at 2, 3 at 4 (ranks 2 and 3 return from the shrink's call once
    the grow brought them back), against the save/restart chain."""
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )

    trainer, up, ctrl = _live_job(Path(root) / "b")
    losses = dict(enumerate(_updates(up, 2), 1))
    ctrl.resize(trainer, 2)
    if up.comm.rank < 2 and up.comm.size == 2:
        losses.update(enumerate(_updates(up, 3), 3))
        ctrl.resize(trainer, 4)
    after_grow = (int(up.comm.size), int(up.iteration))
    losses.update(enumerate(_updates(up, 3), 6))
    live = dict(losses=losses, state=_live_state(up), grow=after_grow,
                worlds=[r["world"] for r in ctrl.resizes],
                pauses=[r["pause_s"] for r in ctrl.resizes])
    _release(ctrl, trainer, up)
    ck = str(Path(root) / "a")
    a4 = live_world(4)
    up = live_updater(a4)
    losses = dict(enumerate(_updates(up, 2), 1))
    create_multi_node_checkpointer(a4, ck, elastic=True).save(up)
    a4.close()
    a2 = live_world(2)
    if a2 is not None:
        up = live_updater(a2)
        cp = create_multi_node_checkpointer(a2, ck, elastic=True)
        cp.maybe_load(up)
        losses.update(enumerate(_updates(up, 3), 3))
        cp.save(up)
        a2.close()
    a4 = live_world(4)
    up = live_updater(a4)
    create_multi_node_checkpointer(a4, ck, elastic=True).maybe_load(up)
    losses.update(enumerate(_updates(up, 3), 6))
    restart = dict(losses=losses, state=_live_state(up))
    a4.close()
    return dict(live=live, restart=restart)


def _case_same_world(root):
    """4 -> 4: an epoch only; 5 updates against the uninterrupted 5."""
    a4 = live_world(4)
    ref = _updates(live_updater(a4), 5)
    a4.close()
    trainer, up, ctrl = _live_job(root)
    got = _updates(up, 2)
    old = up.comm
    ctrl.resize(trainer, 4)
    got += _updates(up, 3)
    out = dict(ref=ref, got=got, epoch=ctrl.epoch, closed=old.closed,
               renewed=up.comm is not old)
    _release(ctrl, trainer, up)
    return out


def _case_request(root):
    """``request(2)`` before ``run``: the resize at the first boundary,
    the run finishing at world 2; the parked ranks' trainers stopped at
    the job's end."""
    trainer, up, ctrl = _live_job(root, stop=6)
    trainer.extend(ctrl)
    ctrl.request(2)
    trainer.run()
    out = dict(iteration=int(up.iteration), parked=ctrl.parked,
               resizes=[{k: r[k] for k in ("iteration", "world", "epoch")}
                        for r in ctrl.resizes],
               requested=ctrl._requested, stop=trainer.stop_reason,
               world=None if ctrl.parked else int(up.comm.size))
    if not ctrl.parked:
        up.comm.close()
    return out


def _case_fault_plan(root):
    """``FaultPlan(resize_live_at_iteration=3, resize_live_to=2)``: the
    injector arms the controller and the controller resizes at the end
    of the same tick."""
    from chainermn_tpu_torch.testing import FaultInjector, FaultPlan

    trainer, up, ctrl = _live_job(root, stop=7)
    inj = FaultInjector(FaultPlan(resize_live_at_iteration=3,
                                  resize_live_to=2), up.comm,
                        resize_controller=ctrl)
    trainer.extend(inj)
    trainer.extend(ctrl)
    trainer.run()
    out = dict(fired=inj.fired, resizes=ctrl.resizes, parked=ctrl.parked,
               iteration=int(up.iteration),
               world=None if ctrl.parked else int(up.comm.size))
    if not ctrl.parked:
        up.comm.close()
    return out


def _case_windows_and_hook(root):
    """Captured windows dropped, the old world closed, a new optimizer,
    and ``on_resize`` last, under the new world and epoch."""
    from chainermn_tpu_torch.training.elastic import ResizeController

    calls = []
    trainer, up, _ = _live_job(root)

    def hook(c, new_comm, epoch):
        calls.append(("on_resize", int(new_comm.size), epoch,
                      up.comm is new_comm))

    ctrl = ResizeController(live_world, live_opt, on_resize=hook)
    up.update()
    up._windows[("sentinel", 0)] = object()
    old_comm, old_opt = up.comm, up.optimizer
    ctrl.resize(trainer, 2)
    out = dict(calls=calls, parked=ctrl.parked, old_closed=old_comm.closed)
    if not ctrl.parked:
        out.update(windows=dict(up._windows), renewed=up.comm is not old_comm,
                   new_opt=up.optimizer is not old_opt)
        up.update()
        out["after"] = int(up.iteration)
    _release(ctrl, trainer, up)
    return out


def _case_checkpointers(root):
    """A registered checkpointer (async, shard-only, elastic, history 2)
    and a preemption checkpointer follow the resize: post-resize sets
    are the new world's, a later resume at 2 is exact."""
    from chainermn_tpu_torch.extensions import (
        PreemptionCheckpointer,
        create_multi_node_checkpointer,
    )
    from chainermn_tpu_torch.utils.serialization import read_topology

    from chainermn_tpu_torch.extensions import TrainingWatchdog

    ck = str(Path(root) / "ck")
    trainer, up, ctrl = _live_job(root, stop=6)
    cp = create_multi_node_checkpointer(up.comm, ck, async_write=True,
                                        elastic=True, shard_only=True,
                                        history=2)
    pc = PreemptionCheckpointer(cp, up.comm)
    wd = TrainingWatchdog(stall_timeout=60, comm=up.comm,
                          report_path=str(Path(root) / "stall.json"))
    seen = {}

    class WatchdogAfterResize:
        trigger, priority = (1, "iteration"), 3

        def __call__(self, trainer):
            if trainer.updater.iteration == 2:
                seen.update(running=wd._thread is not None,
                            same=wd.comm is trainer.updater.comm)

    trainer.extend(cp, trigger=(2, "iteration"))
    trainer.extend(pc)
    trainer.extend(wd)
    trainer.extend(WatchdogAfterResize())
    trainer.extend(ctrl)
    ctrl.request(2)
    trainer.run()
    cp.finalize()
    out = dict(parked=ctrl.parked, cp_comm=cp.comm is None,
               pc_comm=pc.comm is None, watchdog=seen,
               watchdog_stopped=wd._thread is None,
               stalls=wd.stall_count)
    a2 = live_world(2)
    if not ctrl.parked:
        parts = sorted(f for f in os.listdir(ck) if "iter_6" in f)
        out.update(same=pc.comm is cp.comm is up.comm,
                   world=int(cp.comm.size), parts=parts,
                   stamped=read_topology(os.path.join(ck, parts[0]))[
                       "world_size"])
        again = live_updater(a2)
        cp2 = create_multi_node_checkpointer(a2, ck, elastic=True,
                                             shard_only=True, history=2)
        out.update(at=cp2.maybe_load(again), mode=cp2.last_resume_mode,
                   params=_same_tree(again.params, up.params))
        up.comm.close()
        a2.close()
    return out


def _same_tree(a, b):
    import torch.utils._pytree as pytree

    return all(torch.equal(x, y) for x, y in zip(pytree.tree_leaves(a),
                                                  pytree.tree_leaves(b)))


def _case_prefetch(root):
    """A prefetching feed through the resize: closed, re-wrapped over
    the new world, its position kept; a pre-built prefetcher keeps its
    own converter."""
    from chainermn_tpu_torch.iterators import (
        GlobalBatchConverter,
        PrefetchIterator,
        SerialIterator,
    )

    out = {}
    for name, kw in (("serial", {}),
                     ("prefetch", dict(prefetch=True, max_inflight=1))):
        trainer, up, ctrl = _live_job(Path(root) / name, **kw)
        got = _updates(up, 2)
        ctrl.resize(trainer, 2)
        if not ctrl.parked:
            got += _updates(up, 3)
            out[name] = dict(losses=got, params=np_tree(up.params),
                             prefetch=isinstance(up.iterator,
                                                 PrefetchIterator))
        up.finalize()
        _release(ctrl, trainer, up)

    class Counting(GlobalBatchConverter):
        calls = 0

        def __call__(self, batch):
            Counting.calls += 1
            return super().__call__(batch)

    c4 = live_world(4)
    conv = Counting(c4)
    feed = PrefetchIterator(SerialIterator(live_dataset(), LIVE_BATCH,
                                           shuffle=True, seed=7), c4,
                            converter=conv)
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.training.elastic import ResizeController

    up = live_updater(c4, iterator=feed, converter=conv, max_inflight=1)
    trainer = training.Trainer(up, (100, "iteration"),
                               out=str(Path(root) / "built"))
    ctrl = ResizeController(live_world, live_opt)
    _updates(up, 2)
    before = Counting.calls
    ctrl.resize(trainer, 2)
    if not ctrl.parked:
        _updates(up, 2)
        out["prebuilt"] = dict(same=up.iterator._converter is conv,
                               rebound=conv.comm is up.comm,
                               grew=Counting.calls > before > 0)
    up.finalize()
    _release(ctrl, trainer, up)
    return out


def _case_shard_feed_refused(root):
    """A per-rank shard feed cannot follow a change of world size: every
    rank refuses before anything moves, the world left as it was."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.iterators import default_converter
    from chainermn_tpu_torch.training.elastic import ResizeController

    c4 = live_world(4)
    up = live_updater(c4, converter=default_converter)
    trainer = training.Trainer(up, (100, "iteration"), out=str(root))
    ctrl = ResizeController(live_world, live_opt)
    up.update()
    try:
        ctrl.resize(trainer, 2)
        msg = None
    except ValueError as e:
        msg = str(e)
    up.update()                 # the world of 4 still runs
    out = dict(msg=msg, world=int(up.comm.size), closed=c4.closed)
    c4.close()
    return out


def battery_live_resize(comm, p):
    """The live-resize cases of ``test_torch_live_resize.py`` on a
    4-rank gloo world: worlds of 4 and 2 over the launch's ranks, ranks
    2 and 3 parked in between.  Every case builds its worlds with
    ``create_communicator(ranks=)`` and closes them, and ends with no
    rank parked."""
    root = Path(p["root"])
    cases = dict(drill=lambda: _live_drill(comm, root / "drill"),
                 direct=lambda: _case_direct(root / "direct"),
                 same_world=lambda: _case_same_world(root / "same"),
                 request=lambda: _case_request(root / "request"),
                 fault_plan=lambda: _case_fault_plan(root / "plan"),
                 windows=lambda: _case_windows_and_hook(root / "windows"),
                 checkpointers=lambda: _case_checkpointers(root / "ck"),
                 prefetch=lambda: _case_prefetch(root / "prefetch"),
                 shard_feed=lambda: _case_shard_feed_refused(root / "sf"))
    return {name: one_thread(fn) for name, fn in cases.items()}


# --------------------------------------------------------------------- #
# the harness's own tests
# --------------------------------------------------------------------- #


def test_world_runs_and_reports(tmp_path):
    got = run_world(tmp_path, 2, "battery_smoke", None)
    assert got == [(0, 2, 3.0), (1, 2, 3.0)]


def test_world_hang_fails_within_timeout(tmp_path):
    with pytest.raises(AssertionError, match="did not finish"):
        run_world(tmp_path, 2, "battery_hang", None, timeout=8)

