"""The mesh's sequence axis in the port against the JAX package's: the
mesh over the world communicator, ring attention (contiguous, zigzag,
windowed, GQA) and Ulysses (G = S and the lcm case) over the seq axis,
the flagship's forward and AdamW step at data=2, seq=2, data- and
sequence-parallel decoding, and ``train_lm_torch.py`` with the zigzag
ring, all at a small size (d_model 64, 4 query / 2 KV heads, d_head 16,
2 layers, T = 32, batch 4).

Every port case runs in one 4-rank gloo world for the module
(``battery_sequence_parallel`` in ``test_torch_world.py``), started in a
thread so that the JAX side, on 4 of the conftest's 8 virtual CPU
devices, computes meanwhile.  The JAX ring runs its XLA pair on the CPU
(interpret mode); the port's kernel schedule runs the kernel's plain
version and its einsum scan the grouped products.  Tolerances: fp32
everywhere, so attention outputs and gradients agree to 1e-5 max abs
(they differ in summation order only), logits to 1e-5, the loss to
1e-5 relative, and each parameter leaf after one AdamW step to 1e-5
relative L2 (as ``test_torch_lm_data_parallel.py`` holds a step).
Decoding takes argmaxes of fp32 logits, so its tokens are held bitwise.
"""

import concurrent.futures
import dataclasses
import importlib.util
import re
from functools import partial
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chainermn_tpu.models import TransformerConfig as JaxConfig
from chainermn_tpu.models import make_forward_fn as jax_fwd
from chainermn_tpu.models import make_generate_fn as jax_gen
from chainermn_tpu.models import make_train_step as jax_train_step
from chainermn_tpu.models import shard_params
from chainermn_tpu.parallel import MeshConfig as JaxMesh
from chainermn_tpu.parallel import ring_attention as jax_ring
from chainermn_tpu.parallel import ulysses_attention as jax_ulysses
from chainermn_tpu.parallel import zigzag_indices as jax_zigzag
from chainermn_tpu.training import shard_opt_state
from chainermn_tpu_torch.models import (
    TransformerConfig,
    init_numpy_params,
    init_transformer,
    make_forward_fn,
    make_value_and_grad_fn,
)
from chainermn_tpu_torch.parallel import (
    local_attention,
    simulate_ring,
    zigzag_indices,
)
from chainermn_tpu_torch.parallel.ring_attention import ring_launches

from test_torch_world import run_world

ROOT = Path(__file__).resolve().parent.parent
N, B, T, D, VOCAB, LR = 4, 2, 32, 16, 128, 1e-3
ATOL = 1e-5

BASE = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=256, n_layers=2, max_seq=T, dtype="float32",
            remat=False)
LM_CASES = {
    "ring": dict(attention="ring"),
    "ring_zigzag_rope": dict(attention="ring", seq_layout="zigzag",
                             pos_embedding="rope", remat=True),
    "ulysses": dict(attention="ulysses"),
}
GEN_CASES = {
    "data2": dict(BASE, attention="local", pos_embedding="rope"),
    "data2_seq2": dict(BASE, attention="local"),
}
GEN_MAX_LEN, GEN_PAD = 32, VOCAB - 1
# (name, H, G, layout, window) of the ring cases at seq=4
RING_CASES = {
    "contiguous": (4, 4, "contiguous", None),
    "zigzag_gqa": (4, 2, "zigzag", None),
    "window_gqa": (4, 2, "contiguous", 12),
}
ULYSSES_CASES = {"g_eq_s": (8, 4), "lcm": (8, 2)}
# (mesh, the axis groups whose members are compared)
MESHES = [
    (dict(data=2, seq=2), [("seq",), ("data",), ("data", "expert", "seq")]),
    (dict(seq=4), [("seq",), ("data",)]),
    (dict(data=-1, model=2), [("model",), ("data", "model"), ("data",)]),
    (dict(pipe=2, seq=2), [("pipe",), ("seq",), ("pipe", "seq")]),
]
# train_lm_torch.py at the "ring_zigzag_rope" case's config and batch
# shape, so the JAX side reuses that case's compiled step
EXAMPLE_ARGV = ["--device", "cpu", "--mesh", "data=2,seq=2", "--attention",
                "ring", "--seq-layout", "zigzag", "--pos-embedding", "rope",
                "--n-kv-heads", "2", "--remat", "--steps", "2",
                "--n-layers", "2", "--batchsize", "4", "--lr", str(LR)]


def lm_fields(name):
    return dict(BASE, **LM_CASES[name])


def qkvd(seed, H, G, layout):
    """Global fp32 (q, k, v, do), in the layout's token order."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, T, h, D).astype(np.float32)
                   for h in (H, G, G, H))
    if layout == "zigzag":
        perm = zigzag_indices(N, T).reshape(-1)
        q, k, v, do = (a[:, perm] for a in (q, k, v, do))
    return q, k, v, do


def lm_batch(name):
    rng = np.random.RandomState(3)
    toks = rng.randint(0, VOCAB, (4, T + 1)).astype(np.int32)
    x, y = toks[:, :T], toks[:, 1:]
    if LM_CASES[name].get("seq_layout") == "zigzag":
        perm = zigzag_indices(2, T).reshape(-1)
        x, y = x[:, perm], y[:, perm]
    return x, y


def tree_of(fields):
    """Seeded weights for ``fields`` in the JAX layout (numpy), fed to
    both packages."""
    return init_numpy_params(TransformerConfig(**fields), seed=0)


def gen_prompt():
    return np.random.RandomState(5).randint(0, VOCAB - 1, (4, 8)) \
        .astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """The port's 4-rank world, started with the module's first test and
    running in a thread: ``.result()`` is every rank's battery output.
    The tests that need no world come first, and the others compute
    their JAX side before they wait."""
    payload = dict(
        meshes=MESHES,
        a2a=np.random.RandomState(9).randn(N, 2, 8, 4, 4).astype(
            np.float32),
        ring={n: dict(window=w, layout=lay,
                      qkvd=qkvd(i, h, g, lay))
              for i, (n, (h, g, lay, w)) in enumerate(RING_CASES.items())},
        ulysses={n: dict(qkvd=qkvd(10 + i, h, g, "contiguous"))
                 for i, (n, (h, g)) in enumerate(ULYSSES_CASES.items())},
        lm_cases={n: lm_fields(n) for n in LM_CASES},
        lm_batch={n: lm_batch(n) for n in LM_CASES},
        lm_tree={n: tree_of(lm_fields(n)) for n in LM_CASES},
        lr=LR,
        gen_cases=GEN_CASES,
        gen_tree={n: tree_of(f) for n, f in GEN_CASES.items()},
        gen_prompt=gen_prompt(), gen_max_len=GEN_MAX_LEN, gen_pad=GEN_PAD,
        example_argv=EXAMPLE_ARGV,
        example_tree=tree_of(lm_fields("ring_zigzag_rope")))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_world, tmp_path_factory.mktemp("seq_parallel"),
                      N, "battery_sequence_parallel", payload)
    # the JAX side's compilations meanwhile, a few at a time
    jax_pool = concurrent.futures.ThreadPoolExecutor(3)
    for name in LM_CASES:
        _JAX_LM_RUN[name] = jax_pool.submit(_jax_lm, name)
    for name in RING_CASES:
        _JAX_RING[name] = jax_pool.submit(_jax_ring, name)
    for name in ULYSSES_CASES:
        _JAX_ULYSSES[name] = jax_pool.submit(_jax_ulysses, name)
    yield fut
    jax_pool.shutdown(wait=True)
    pool.shutdown(wait=True)


def jax_mesh(**axes):
    n = N if -1 in axes.values() else int(np.prod(list(axes.values())))
    return JaxMesh(devices=jax.devices()[:n], **axes)


# --------------------------------------------------------------------- #
# without the world: the layout, the mesh's errors, the ring's schedule
# on one device
# --------------------------------------------------------------------- #


def test_zigzag_indices_bitwise():
    for S, t in ((1, 8), (2, 32), (4, 32), (4, 2048)):
        got, want = zigzag_indices(S, t), np.asarray(jax_zigzag(S, t))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="divisible by 2\\*S"):
        zigzag_indices(4, 36)


def test_mesh_errors_match_jax():
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.parallel import MeshConfig

    one = create_communicator("loopback", device="cpu")
    for axes in (dict(data=-1, seq=-1), dict(data=2), dict(seq=3, data=-1)):
        with pytest.raises(ValueError) as want:
            JaxMesh(devices=jax.devices()[:1], **axes)
        with pytest.raises(ValueError) as got:
            MeshConfig(one, **axes)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("layout,window", [("contiguous", None),
                                           ("zigzag", None),
                                           ("contiguous", 20),
                                           ("zigzag", 20)])
def test_simulated_ring_is_full_attention(layout, window):
    # every rank's body on one device, kernel schedule and einsum scan,
    # against whole-sequence attention; launches as the schedule predicts
    S, H, G = 4, 4, 2
    q, k, v, do = (torch.as_tensor(a).requires_grad_()
                   for a in qkvd(1, H, G, layout))
    perm = torch.as_tensor(zigzag_indices(S, T).reshape(-1)) \
        if layout == "zigzag" else torch.arange(T)
    inv = torch.argsort(perm)
    want = local_attention(q[:, inv], k[:, inv], v[:, inv], causal=True,
                           window=window)[:, perm]
    wgrads = torch.autograd.grad((want * do).sum(), (q, k, v))
    for use_flash in (False, True):
        got = simulate_ring(q, k, v, S=S, causal=True, window=window,
                            layout=layout, use_flash=use_flash)
        grads = torch.autograd.grad((got * do).sum(), (q, k, v))
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        for a, b in zip(grads, wgrads):
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
    # the launches the schedule predicts: the (rank, step, Q run, K run)
    # pairs whose mask, built position by position, keeps any entry
    pos = perm.numpy().reshape(S, -1)
    runs = 2 if layout == "zigzag" else 1
    steps = S if window is None or layout == "zigzag" \
        else min(S, -(-window // (T // S)) + 1)
    live = 0
    for r in range(S):
        for i in range(steps):
            for qp in np.split(pos[r], runs):
                for kp in np.split(pos[(r - i) % S], runs):
                    d = qp[:, None] - kp[None, :]
                    live += bool(((d >= 0) & (d < (window or T))).any())
    assert ring_launches(S, T // S, causal=True, window=window,
                         layout=layout) == live


@pytest.mark.parametrize("kw", [dict(q_offset=0, k_offset=0),
                                dict(q_offset=8, k_offset=20),
                                dict(q_offset=40, k_offset=8, window=12)])
def test_lse_pair_and_merge_match_jax(kw):
    # the plain (Q block x K/V block) partial and the log-space merge:
    # against the JAX package's, and against the kernel's plain version
    # (its fully masked rows: o = 0, lse = -1e30)
    from chainermn_tpu.parallel.ring_attention import (
        _lse_attention_pair as jax_pair, _merge_lse as jax_merge)
    from chainermn_tpu_torch.ops.flash_attention import flash_attention
    from chainermn_tpu_torch.parallel.ring_attention import (
        _lse_attention_pair, _merge_lse, broadcast_kv)

    q, k, v, _ = qkvd(4, 4, 2, "contiguous")
    got = _lse_attention_pair(*map(torch.as_tensor, (q, k, v)),
                              causal=True, **kw)
    want = jax_pair(q, k, v, causal=True, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)
    kb, vb = broadcast_kv(torch.as_tensor(k), torch.as_tensor(v), 2)
    flash = flash_attention(torch.as_tensor(q), kb, vb, causal=True,
                            return_lse=True, **kw)
    torch.testing.assert_close(flash[0], got[0], rtol=0, atol=ATOL)
    live = got[1] > -1e29
    torch.testing.assert_close(flash[1][live], got[1][live], rtol=0,
                               atol=ATOL)
    assert bool((flash[1][~live] <= -1e29).all())
    plain = dict(causal=True, q_offset=0, k_offset=0)
    other = _lse_attention_pair(*map(torch.as_tensor, (q, k, v)), **plain)
    merged = _merge_lse(got[0], got[1], *other)
    ref = jax_merge(want[0], want[1], *jax_pair(q, k, v, **plain))
    for a, b in zip(merged, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)


def test_one_rank_ring_is_the_flash_step():
    # a one-rank ring runs the single pair: bitwise the flash path
    cfg = TransformerConfig(**dict(BASE, attention="flash"))
    params = init_transformer(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    x, y = lm_batch("ring")
    want = make_value_and_grad_fn(cfg, device="cpu")(params, x, y)
    ring = dataclasses.replace(cfg, attention="ring")
    got = make_value_and_grad_fn(ring, device="cpu")(params, x, y)
    assert torch.equal(got[0], want[0])
    for a, b in zip(torch.utils._pytree.tree_leaves(got[1]),
                    torch.utils._pytree.tree_leaves(want[1])):
        assert torch.equal(a, b)
    assert torch.equal(make_forward_fn(ring, device="cpu")(params, x),
                       make_forward_fn(cfg, device="cpu")(params, x))


def test_layouts_and_options_raise_as_jax():
    cfg = TransformerConfig(**dict(BASE, attention="flash",
                                   seq_layout="zigzag"))
    params = init_transformer(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    with pytest.raises(ValueError, match="ring-attention layout"):
        make_forward_fn(cfg, device="cpu")(params, lm_batch("ring")[0])
    from chainermn_tpu_torch.parallel import ring_attention

    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        ring_attention(q, q, q, permute_plan=object())
    with pytest.raises(ValueError, match="layout"):
        ring_attention(q, q, q, layout="striped")


# --------------------------------------------------------------------- #
# in the world: the mesh, the exchange, ring attention and Ulysses at
# seq=4
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=[",".join(f"{k}={v}" for k, v in m.items())
                              for m, _ in MESHES])
def test_mesh_ranks_and_groups_match_jax(world, i):
    spec, groups = MESHES[i]
    ids = np.vectorize(lambda d: d.id)(jax_mesh(**spec).mesh.devices)
    order = ("pipe", "data", "expert", "seq", "model")
    for res in world.result():
        shape, coords, members = res["mesh"][i]
        r = res["rank"]
        assert tuple(shape.values()) == ids.shape
        assert tuple(coords[a] for a in order) == tuple(
            int(c) for c in np.argwhere(ids == r)[0])
        for g in groups:
            # the ranks sharing r's other coordinates, row-major over g
            idx = tuple(slice(None) if a in g else coords[a] for a in order)
            assert members[g] == ids[idx].reshape(-1).tolist(), (g, r)


def test_all_to_all_tiled_matches_jax(world):
    x = np.random.RandomState(9).randn(N, 2, 8, 4, 4).astype(np.float32)
    mesh = jax_mesh(seq=4).mesh
    for i, (s, c) in enumerate(((2, 1), (1, 2), (3, 0))):
        f = jax.jit(jax.shard_map(
            lambda a, s=s, c=c: jax.lax.all_to_all(
                a[0], "seq", s, c, tiled=True)[None],
            mesh=mesh, in_specs=P("seq"), out_specs=P("seq")))
        want = np.asarray(f(x))
        for r, res in enumerate(world.result()):
            np.testing.assert_array_equal(res["a2a"][i], want[r])


def jax_attention(fn, q, k, v, do):
    spec = P(None, "seq")

    def body(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return (o, *vjp(do))

    f = jax.jit(jax.shard_map(body, mesh=jax_mesh(seq=4).mesh,
                              in_specs=(spec,) * 4, out_specs=(spec,) * 4))
    return [np.asarray(a) for a in f(q, k, v, do)]


def assert_attention(got, want):
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=name)


# the JAX side of each case, computed in the fixture's threads
_JAX_RING = {}
_JAX_ULYSSES = {}


def _jax_ring(name):
    H, G, layout, window = RING_CASES[name]
    i = list(RING_CASES).index(name)
    return jax_attention(
        partial(jax_ring, axis_name="seq", causal=True, window=window,
                use_flash=True, interpret=True, layout=layout),
        *qkvd(i, H, G, layout))


def _jax_ulysses(name):
    H, G = ULYSSES_CASES[name]
    i = list(ULYSSES_CASES).index(name)
    return jax_attention(partial(jax_ulysses, axis_name="seq", causal=True),
                         *qkvd(10 + i, H, G, "contiguous"))


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["einsum", "kernel_schedule"])
@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_attention_matches_jax(world, name, use_flash):
    want = _JAX_RING[name].result()
    results = world.result()
    got = [np.concatenate([r["ring"][name, use_flash][j] for r in results],
                          axis=1) for j in range(4)]
    assert_attention(got, want)


@pytest.mark.parametrize("kernel", [False, True], ids=["local", "flash"])
@pytest.mark.parametrize("name", list(ULYSSES_CASES))
def test_ulysses_matches_jax(world, name, kernel):
    want = _JAX_ULYSSES[name].result()
    results = world.result()
    got = [np.concatenate([r["ulysses"][name, kernel][j] for r in results],
                          axis=1) for j in range(4)]
    assert_attention(got, want)


@pytest.mark.parametrize("case", [("ring", n) for n in RING_CASES]
                         + [("ulysses", n) for n in ULYSSES_CASES],
                         ids=lambda c: "-".join(c))
def test_attention_kernel_calls_per_rank_follow_the_schedule(world, case):
    # each rank's flash calls (forward, backward) on the communicator
    # path: its share of the ring's live pairs, one call for Ulysses;
    # none on the einsum and local paths
    kind, name = case
    for res in world.result():
        if kind == "ring":
            _, _, layout, window = RING_CASES[name]
            n = ring_launches(N, T // N, causal=True, window=window,
                              layout=layout, rank=res["rank"])
        else:
            n = 1
        assert res["calls"][kind, name, True] == (n, n), res["rank"]
        assert res["calls"][kind, name, False] == (0, 0), res["rank"]


# --------------------------------------------------------------------- #
# the flagship at data=2, seq=2
# --------------------------------------------------------------------- #

_JAX_LM = {}


def jax_steps(name, batches):
    """JAX's AdamW steps at mesh data=2, seq=2 from the case's weights:
    the losses and the final parameters; with the logits of the first
    batch."""
    if name not in _JAX_LM:
        # remat changes no value; the JAX side compiles faster without
        jcfg = JaxConfig(**dict(lm_fields(name), remat=False))
        mc = jax_mesh(data=2, seq=2)
        opt = optax.adamw(LR)
        _JAX_LM[name] = (mc, jax_fwd(mc, jcfg), opt,
                         jax_train_step(mc, jcfg, opt), jcfg)
    mc, fwd, opt, step, jcfg = _JAX_LM[name]
    params = shard_params(mc, jcfg, tree_of(lm_fields(name)))
    logits = np.asarray(fwd(params, batches[0][0]))
    # the state on the params' shardings, as the step returns it: one
    # compiled step serves every call
    state, losses = shard_opt_state(opt, params), []
    for x, y in batches:
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))
    return logits, losses, jax.tree.map(np.asarray, params)


_JAX_LM_RUN = {}


def _jax_lm(name):
    logits, losses, params = jax_steps(name, [lm_batch(name)])
    return logits, losses[0], params


def jax_lm(name):
    """JAX's logits and one AdamW step on the case's batch (computed in
    the fixture's threads)."""
    return _JAX_LM_RUN[name].result()


@pytest.mark.parametrize("name", list(LM_CASES))
def test_flagship_forward_shards_match_jax(world, name):
    logits = jax_lm(name)[0]
    for res in world.result():
        d, s = divmod(res["rank"], 2)
        want = logits[2 * d:2 * d + 2, 16 * s:16 * s + 16]
        got = res["lm"][name]["logits"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(LM_CASES))
def test_flagship_step_matches_jax(world, name):
    _, loss, params = jax_lm(name)
    results = world.result()
    first = results[0]["lm"][name]
    np.testing.assert_allclose(first["loss"], loss, rtol=1e-5)
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(first["params"]),
            jax.tree.leaves(params)):
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err < 1e-5, (jax.tree_util.keystr(path), err)
    for res in results[1:]:        # the ranks applied one mean, bitwise
        assert res["lm"][name]["loss"] == first["loss"]
        jax.tree.map(np.testing.assert_array_equal,
                     res["lm"][name]["params"], first["params"])


@pytest.mark.parametrize("name", list(LM_CASES))
def test_flagship_step_kernel_calls_per_rank(world, name):
    # a training step at data=2, seq=2: each layer's flash calls on this
    # rank's seq index, the forward twice under remat (the checkpoint
    # recomputes the whole block), the backward once
    f = lm_fields(name)
    for res in world.result():
        if f["attention"] == "ring":
            live = ring_launches(2, T // 2, causal=True,
                                 layout=f.get("seq_layout", "contiguous"),
                                 rank=res["rank"] % 2)
        else:
            live = 1
        L = f["n_layers"]
        want = ((2 if f["remat"] else 1) * L * live, L * live)
        assert res["calls"]["lm", name] == want, res["rank"]


def collectives(calls):
    return {k: v for k, v in calls.items() if not k.startswith("flash")}


@pytest.mark.parametrize("name", list(LM_CASES))
def test_dots_remat_is_full_remat_and_matches_jax(world, name):
    # "dots" at data=2, seq=2 (ring contiguous, zigzag, Ulysses): the
    # gradients bitwise full remat's; the recompute posts the same
    # collectives as full remat's, the same on every rank; the forward
    # kernel once a live pair a layer, never again in the recompute;
    # one AdamW step from them matches JAX's as the full-remat step
    # does (1e-5 relative L2)
    _, loss, params = jax_lm(name)
    f = lm_fields(name)
    results = world.result()
    want = collectives(results[0]["dots"][name]["calls"]["dots"])
    assert want.get("batch_isend_irecv" if f["attention"] == "ring"
                    else "all_to_all_single")
    for res in results:
        d = res["dots"][name]
        assert d["bitwise"], res["rank"]
        calls = d["calls"]
        assert collectives(calls["dots"]) == collectives(calls["full"]) \
            == want, res["rank"]
        live = ring_launches(2, T // 2, causal=True,
                             layout=f.get("seq_layout", "contiguous"),
                             rank=res["rank"] % 2) \
            if f["attention"] == "ring" else 1
        L = f["n_layers"]
        assert (calls["dots"]["flash_fwd"], calls["dots"]["flash_bwd"]) \
            == (L * live, L * live), res["rank"]
        assert calls["full"]["flash_fwd"] == 2 * L * live, res["rank"]
    first = results[0]["dots"][name]
    np.testing.assert_allclose(first["step_loss"], loss, rtol=1e-5)
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(first["params"]),
            jax.tree.leaves(params)):
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err < 1e-5, (jax.tree_util.keystr(path), err)


# --------------------------------------------------------------------- #
# decoding over the data and seq axes
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(GEN_CASES))
def test_generate_matches_jax(world, name):
    jcfg = JaxConfig(**GEN_CASES[name])
    mc = jax_mesh(data=2) if name == "data2" else jax_mesh(data=2, seq=2)
    tree, prompt = tree_of(GEN_CASES[name]), gen_prompt()
    results = world.result()
    # rank r holds data shard r % 2 (data2: each half of the world is a
    # mesh) or r // 2 (data2_seq2, its seq members alike)
    shard = (lambda r: r % 2) if name == "data2" else (lambda r: r // 2)
    lead = [next(res["gen"][name] for res in results
                 if shard(res["rank"]) == d) for d in (0, 1)]
    for res in results:
        mine = res["gen"][name]
        for key in ("plain", "tokens", "done", "gen_len"):
            np.testing.assert_array_equal(mine[key],
                                          lead[shard(res["rank"])][key])
    plain = np.asarray(jax_gen(mc, jcfg, max_len=GEN_MAX_LEN)(tree, prompt))
    np.testing.assert_array_equal(
        np.concatenate([g["plain"] for g in lead]), plain)
    eos = lead[0]["eos"]
    ref = [np.asarray(a) for a in jax_gen(
        mc, jcfg, max_len=GEN_MAX_LEN, eos_id=eos, pad_id=GEN_PAD,
        with_row_state=True)(tree, prompt)]
    for key, want in zip(("tokens", "done", "gen_len"), ref):
        np.testing.assert_array_equal(
            np.concatenate([g[key] for g in lead]), want)
    # eos was reached in the first shard's rows only: the second kept
    # decoding to the end, so every rank ran every step
    assert ref[1][:2].any() and not ref[1][2:].any()


# --------------------------------------------------------------------- #
# the example
# --------------------------------------------------------------------- #


def printed_losses(text):
    steps = [float(m) for m in re.findall(r"step +\d+  loss ([\d.]+)", text)]
    first, last = re.search(r"loss ([\d.]+) -> ([\d.]+) over", text).groups()
    return steps + [float(first), float(last)]


def test_train_lm_torch_zigzag_matches_jax(world):
    # the example's two steps on its own batches (make_batches, permuted
    # by zigzag_indices) against the JAX step on the same batches
    spec = importlib.util.spec_from_file_location(
        "train_lm", ROOT / "examples/transformer/train_lm.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    perm = np.asarray(jax_zigzag(2, T)).reshape(-1)
    batches = [(x[:, perm], y[:, perm])
               for x, y in ex.make_batches(VOCAB, 4, T, 2, seed=0)]
    jax_lm("ring_zigzag_rope")     # its compiled step, in _JAX_LM
    _, want, _ = jax_steps("ring_zigzag_rope", batches)
    results = world.result()
    got = results[0]["example"]
    np.testing.assert_array_equal(got["perm"], perm)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    np.testing.assert_allclose(printed_losses(got["printed"]),
                               [want[0], want[0], want[1]], atol=1e-4)
    for res in results[1:]:
        assert res["example"]["losses"] == got["losses"]
        assert res["example"]["printed"] == ""
