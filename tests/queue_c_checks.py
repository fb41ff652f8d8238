"""One-off checks of three results on the card that ROADMAP Queue C
listed as unexplained, run on the CPU outside the tier-1 tests (the
file's name keeps pytest from collecting it):

    python tests/queue_c_checks.py fsdp_moe   # 4 gloo ranks
    python tests/queue_c_checks.py moe_loss   # both packages, one device
    python tests/queue_c_checks.py zero_sum   # 4 gloo ranks

``fsdp_moe``: the MoE flagship at data=2,expert=2 (top-2, capacity 1.0,
``test_torch_expert_parallel.py``'s config) with and without ``fsdp``:
the first step's gradients leaf by leaf, then the losses of 3 AdamW
steps and the tokens whose experts differ between the two runs at each
step.  ``moe_loss``: the MoE flagship at the same config on one device,
``adamw(3e-4)`` (the card's optimizer) for 10 steps on one batch (as the
card's phase 18 steps) in both packages.  ``zero_sum``: ZeRO-1's
first-update mean gradient on 4 gloo ranks (SGD at learning rate 1, so
the update is the mean) against the exact mean and the replicated
exchange's, elementwise, beside the fp32 bound of a sum of four in
another order.  Each prints one JSON line."""

import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

B, T, VOCAB = 8, 32, 128
MOE = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=128, n_layers=2, max_seq=T, dtype="float32",
           remat=False, attention="local", moe=True, n_experts=4)


def _child(rank, n, store, fn, payload, out_dir):
    import pickle

    from chainermn_tpu_torch.communicators import (create_communicator,
                                                   init_distributed)

    init_distributed(init_method=f"file://{store}", world_size=n,
                     rank=rank, device="cpu")
    result = fn(create_communicator("tpu_xla", device="cpu"), payload)
    with open(Path(out_dir) / f"{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def run_world(n, fn, payload):
    """Every rank's ``fn(comm, payload)`` in an ``n``-process gloo
    world."""
    import pickle

    import torch.multiprocessing as mp

    out = tempfile.mkdtemp()
    mp.start_processes(_child, args=(n, Path(out) / "store", fn, payload,
                                     out), nprocs=n, start_method="spawn")
    results = []
    for r in range(n):
        with open(Path(out) / f"{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def batch(seed=3):
    toks = np.random.RandomState(seed).randint(0, VOCAB, (B, T + 1)) \
        .astype(np.int32)
    return toks[:, :T], toks[:, 1:]


def battery_fsdp_moe(comm, p):
    import torch

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_train_step,
        make_value_and_grad_fn, params_from_jax, params_to_numpy)
    from chainermn_tpu_torch.models.transformer import _fsdp_dims
    from chainermn_tpu_torch.parallel import MeshConfig
    from chainermn_tpu_torch.parallel import expert as ep

    torch.set_num_threads(1)
    x, y = batch()
    mesh = MeshConfig(comm, data=2, expert=2)
    out = {}
    for fsdp in (False, True):
        cfg = TransformerConfig(**dict(MOE, router_top_k=2,
                                       capacity_factor=1.0, fsdp=fsdp))
        tree = init_numpy_params(TransformerConfig(**MOE), seed=0)
        params = params_from_jax(tree, cfg, "cpu", mesh=mesh)
        _, grads = make_value_and_grad_fn(cfg, mesh=mesh)(params, x, y)
        g = params_to_numpy(grads, cfg, mesh=mesh)
        opt = training.adamw(1e-3)
        state = opt.init(params)
        step = make_train_step(cfg, opt, mesh=mesh)
        losses, routes = [], []
        for _ in range(3):
            ep.expert_parallel_moe.routings = log = []
            params, state, loss = step(params, state, x, y)
            ep.expert_parallel_moe.routings = None
            losses.append(float(loss))
            routes.append([r.top_i.numpy().copy() for r in log])
        out[fsdp] = dict(grads=g, losses=losses, routes=routes)
    sharded = {f"blocks/{k}" for k in _fsdp_dims(cfg)}
    return dict(out=out, sharded=sorted(sharded))


def fsdp_moe():
    res = run_world(4, battery_fsdp_moe, {})
    r0 = res[0]
    dense, fsdp = r0["out"][False], r0["out"][True]
    leaves = {}
    for top in dense["grads"]:
        if top == "blocks":
            for k, a in dense["grads"]["blocks"].items():
                b = fsdp["grads"]["blocks"][k]
                leaves[f"blocks/{k}"] = (a, b)
        else:
            leaves[top] = (dense["grads"][top], fsdp["grads"][top])
    table = {}
    for name, (a, b) in leaves.items():
        d = np.abs(a - b)
        table[name] = dict(
            bitwise=bool(np.array_equal(a, b)),
            max_abs=float(d.max()),
            rel_l2=float(np.linalg.norm(a - b) / np.linalg.norm(a)),
            # a sum of 4 in another order: within 3 ulps of the
            # magnitude summed (one mean's rounding on top)
            ulp_of_max=float(d.max() / np.spacing(np.abs(a).max())))
    flips = []
    for step in range(3):
        n = 0
        for ra, rb in zip(dense["routes"][step], fsdp["routes"][step]):
            n += int((ra != rb).any(-1).sum())
        flips.append(n)
    # every rank: the same decision
    same_ranks = all(r["out"][True]["losses"] == fsdp["losses"]
                     for r in res)
    print(json.dumps(dict(
        check="fsdp_moe", sharded=r0["sharded"],
        losses_dense=dense["losses"], losses_fsdp=fsdp["losses"],
        loss_rel=[abs(a - b) / abs(a) for a, b in
                  zip(dense["losses"], fsdp["losses"])],
        token_flips_by_step=flips,
        tokens_routed_per_step=sum(int(r.shape[0]) for r in
                                   dense["routes"][0]),
        ranks_agree=same_ranks, grads=table)))


def moe_loss():
    import dataclasses

    import jax
    import optax
    import torch

    from chainermn_tpu.models import TransformerConfig as JaxConfig
    from chainermn_tpu.models import make_train_step as jax_step
    from chainermn_tpu.models import shard_params
    from chainermn_tpu.parallel import MeshConfig
    from chainermn_tpu.training import shard_opt_state
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_train_step,
        params_from_jax)

    torch.set_num_threads(1)
    steps, lr = 10, 3e-4
    rows = {}
    for k in (1, 2):
        fields = dict(MOE, router_top_k=k)
        cfg = TransformerConfig(**fields)
        tree = init_numpy_params(cfg, seed=0)
        x, y = batch()
        params = params_from_jax(tree, cfg, "cpu")
        opt = training.adamw(lr)
        state = opt.init(params)
        step = make_train_step(cfg, opt, device="cpu")
        port = []
        for _ in range(steps):
            params, state, loss = step(params, state, x, y)
            port.append(float(loss))
        jcfg = JaxConfig(**dataclasses.asdict(cfg))
        mc = MeshConfig(data=1, devices=jax.devices()[:1])
        jopt = optax.adamw(lr)
        jp = shard_params(mc, jcfg, tree)
        js = shard_opt_state(jopt, jp)
        jfn = jax_step(mc, jcfg, jopt)
        ref = []
        for _ in range(steps):
            jp, js, loss = jfn(jp, js, x, y)
            ref.append(float(loss))
        rows[f"top{k}"] = dict(port=port, jax=ref, max_rel=max(
            abs(a - b) / abs(b) for a, b in zip(port, ref)))
    print(json.dumps(dict(check="moe_loss", lr=lr, steps=steps, **rows)))


def battery_zero_sum(comm, p):
    import torch

    from chainermn_tpu_torch import training

    torch.set_num_threads(1)
    r = comm.rank
    out = {}
    for name, kw in (("replicated", {}), ("zero1", dict(zero1=True))):
        opt = training.create_multi_node_optimizer(
            training.sgd(1.0), comm, **kw)
        params = {k: torch.zeros(v.shape) for k, v in p["grads"][0].items()}
        state = opt.init(params)
        opt.update({k: torch.tensor(v) for k, v in p["grads"][r].items()},
                   state, params)
        out[name] = {k: (-v).numpy().copy() for k, v in params.items()}
    return out


def zero_sum():
    rng = np.random.RandomState(0)
    # ResNet-like leaves: a conv kernel, a BN scale, an fc weight
    shapes = {"conv": (64, 64, 3, 3), "bn": (256,), "fc": (2048, 100)}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.uniform(-3, 0, s))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    res = run_world(4, battery_zero_sum, dict(grads=grads))
    u = np.finfo(np.float32).eps / 2
    table = {}
    for k in shapes:
        g = np.stack([gr[k] for gr in grads]).astype(np.float64)
        exact = g.sum(0) / 4
        # |fl(sum of 4) - sum| <= 3u/(1-3u) Σ|g|; the /4 is exact
        bound = (3 * u / (1 - 3 * u)) * np.abs(g).sum(0) / 4
        z, rep = res[0]["zero1"][k], res[0]["replicated"][k]
        table[k] = dict(
            zero_within_bound=bool((np.abs(z - exact) <= bound).all()),
            replicated_within_bound=bool(
                (np.abs(rep - exact) <= bound).all()),
            zero_vs_replicated_max_over_bound=float(
                (np.abs(z - rep) / np.maximum(2 * bound, 1e-45)).max()),
            zero_vs_replicated_rel_l2=float(
                np.linalg.norm(z - rep) / np.linalg.norm(rep)),
            bitwise=bool(np.array_equal(z, rep)),
            ranks_agree=all(np.array_equal(x["zero1"][k], z)
                            for x in res))
    print(json.dumps(dict(check="zero_sum", leaves=table)))


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    {"fsdp_moe": fsdp_moe, "moe_loss": moe_loss,
     "zero_sum": zero_sum}[sys.argv[1]]()
