"""The hand-written Hopper kernels against their plain PyTorch versions,
on the card.  Every test here needs CUDA and skips without it.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX; skip the repository's JAX conftest there:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances (bf16/fp16 kernel against the plain version on the same
inputs and the same tiles): ``o`` is rounded to the operand dtype at the
end (one ulp is 2^-8 relative), and ``p`` before ``P·V``, where the
kernel's base-2 exponent and summation order may flip one ulp: ``o``
agrees to 1e-2 relative plus 2e-2 of the tensor's RMS absolute (so the
small late-row elements of causal attention, ~1/sqrt(row), are held
too), and to 1e-3 relative L2 over the tensor; ``lse`` is fp32
throughout and agrees to 1e-4.  The gradients are rounded to the
operand dtype at the end, and ``p`` and ``ds`` are rounded to it before
their products, where the kernels' ``exp`` and summation order may flip
one ulp: ``dq``, ``dk`` and ``dv`` agree to 2e-2 relative plus 2e-2 of
the tensor's RMS absolute (small elements are held too), and to 2e-3
relative L2 over the tensor (a fault spread thinly over many elements).
"""

import dataclasses

import numpy as np
import pytest
import torch

from chainermn_tpu_torch import training
from chainermn_tpu_torch.models import (
    TransformerConfig,
    init_numpy_params,
    make_forward_fn,
    make_train_step,
    make_value_and_grad_fn,
    params_from_jax,
)
from chainermn_tpu_torch.models.transformer import _lm_head
from chainermn_tpu_torch.ops import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
)


def _assert_o_close(got, want):
    got, want = got.float(), want.float()
    rms = want.pow(2).mean().sqrt().item()
    torch.testing.assert_close(got, want, rtol=1e-2, atol=2e-2 * rms)
    rel = (got - want).norm() / want.norm().clamp_min(1e-30)
    assert rel <= 1e-3, f"relative L2 {rel.item():.3e}"


def _assert_grad_close(got, want):
    got, want = got.float(), want.float()
    rms = want.pow(2).mean().sqrt().item()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2 * rms)
    rel = (got - want).norm() / want.norm().clamp_min(1e-30)
    assert rel <= 2e-3, f"relative L2 {rel.item():.3e}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    # fp32 references in full fp32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CASES = [
    dict(causal=False),
    dict(causal=True),
    dict(causal=True, window=37),
    dict(causal=True, q_offset=96, k_offset=40),
    dict(causal=True, q_offset=0, k_offset=100),   # fully masked rows
]


@pytest.mark.parametrize("kw", CASES, ids=[str(c) for c in CASES])
@pytest.mark.parametrize("t,d,dtype", [(64, 16, torch.bfloat16),
                                       (200, 64, torch.bfloat16),
                                       (130, 32, torch.float16),
                                       (256, 128, torch.float16)])
def test_cuda_kernel_matches_plain(cuda, kw, t, d, dtype):
    g = torch.Generator(device="cpu").manual_seed(t * d)
    q, k, v = (torch.randn(2, t, 3, d, generator=g).to(cuda, dtype)
               for _ in range(3))
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    o_ref, lse_ref = flash_attention_reference(q, k, v, **kw)
    _assert_o_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
    if kw.get("k_offset", 0) == 100:
        rows = min(t, 100)
        assert torch.all(o[:, :rows] == 0)
        assert torch.all(lse[:, :rows] <= -1e29)


# (Tq, Tk, mask) cases for the forward kernel's 128-row Q and 128-key K
# tiles and its tile classes (skipped, interior, edge)
TILE_CASES = {
    "T=1": (1, 1, dict(causal=True)),
    "T=1 non-causal": (1, 1, dict(causal=False)),
    "3 tiles + tail, window across tile edges": (
        400, 400, dict(causal=True, window=150)),
    "Tq != Tk, suffix queries": (200, 333, dict(causal=True, q_offset=133)),
    "Tq != Tk, non-causal": (77, 300, dict(causal=False)),
    "every tile of two CTAs skipped": (
        300, 300, dict(causal=True, q_offset=0, k_offset=260)),
    "window and offsets": (
        260, 260, dict(causal=True, window=100, q_offset=500,
                       k_offset=300)),
}


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("d", (16, 32, 64, 128))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_cuda_kernel_tile_classes(cuda, case, d, dtype):
    tq, tk, kw = TILE_CASES[case]
    g = torch.Generator(device="cpu").manual_seed(tq * d + tk)
    q = torch.randn(2, tq, 3, d, generator=g).to(cuda, dtype)
    k, v = (torch.randn(2, tk, 3, d, generator=g).to(cuda, dtype)
            for _ in range(2))
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    o_ref, lse_ref = flash_attention_reference(q, k, v, **kw)
    assert o.dtype == dtype and o.shape == q.shape
    _assert_o_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
    masked = kw.get("k_offset", 0) - kw.get("q_offset", 0)
    if masked > 0:   # rows that see no key: written as o = 0
        assert torch.all(o[:, :masked] == 0)
        assert torch.all(lse[:, :masked] <= -1e29)
        assert torch.all(o[:, masked:].abs().amax(dim=(2, 3)) > 0)


def _launch_counts():
    return (flash_attention.launches, flash_attention.dq_launches,
            flash_attention.dkv_launches)


def _kernel_and_plain_grads(q, k, v, do, dlse, **kw):
    """dq, dk, dv through the kernels (autograd) and through the plain
    backward on the kernels' own forward outputs."""
    ts = [x.detach().requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention(*ts, return_lse=True, **kw)
    before = _launch_counts()
    got = torch.autograd.grad((o, lse), ts, (do, dlse))
    torch.cuda.synchronize()
    after = _launch_counts()
    assert after == (before[0], before[1] + 1, before[2] + 1)
    want = flash_attention_bwd_reference(q, k, v, o.detach(), lse.detach(),
                                         do, dlse, **kw)
    return got, want


@pytest.mark.parametrize("kw", CASES, ids=[str(c) for c in CASES])
@pytest.mark.parametrize("t,d,dtype", [(64, 16, torch.bfloat16),
                                       (200, 64, torch.bfloat16),
                                       (130, 32, torch.float16),
                                       (256, 128, torch.float16)])
def test_cuda_backward_kernels_match_plain(cuda, kw, t, d, dtype):
    g = torch.Generator(device="cpu").manual_seed(t * d + 1)
    q, k, v, do = (torch.randn(2, t, 3, d, generator=g).to(cuda, dtype)
                   for _ in range(4))
    dlse = torch.randn(2, t, 3, generator=g).to(cuda)
    got, want = _kernel_and_plain_grads(q, k, v, do, dlse, **kw)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _assert_grad_close(a, b)
    if kw.get("k_offset", 0) == 100:
        assert torch.all(got[0][:, :min(t, 100)] == 0)


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("d", (16, 32, 64, 128))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_cuda_backward_tile_classes(cuda, case, d, dtype):
    # the backward kernels' tiles (dq: 128 query rows against 128 keys, 64
    # at D=128; dk/dv: 128 keys against 64 queries) and tile classes
    tq, tk, kw = TILE_CASES[case]
    g = torch.Generator(device="cpu").manual_seed(tq * d + tk + 1)
    q, do = (torch.randn(2, tq, 3, d, generator=g).to(cuda, dtype)
             for _ in range(2))
    k, v = (torch.randn(2, tk, 3, d, generator=g).to(cuda, dtype)
            for _ in range(2))
    dlse = torch.randn(2, tq, 3, generator=g).to(cuda)
    got, want = _kernel_and_plain_grads(q, k, v, do, dlse, **kw)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _assert_grad_close(a, b)
    masked = kw.get("k_offset", 0) - kw.get("q_offset", 0)
    if masked > 0:   # rows that see no key: dq = 0
        assert torch.all(got[0][:, :masked] == 0)
        assert torch.all(got[0][:, masked:].abs().amax(dim=(2, 3)) > 0)


@pytest.mark.parametrize("d", (16, 32, 64, 128))
def test_cuda_backward_is_deterministic(cuda, d):
    # two kernels, no atomics: the same inputs give the same bits
    g = torch.Generator(device="cpu").manual_seed(d)
    q, k, v, do = (torch.randn(2, 333, 4, d, generator=g).to(
        cuda, torch.bfloat16) for _ in range(4))
    runs = []
    for _ in range(2):
        ts = [x.detach().requires_grad_() for x in (q, k, v)]
        o = flash_attention(*ts, causal=True, window=200)
        runs.append(torch.autograd.grad(o, ts, do))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_cuda_backward_reads_strided_views(cuda):
    # q/k/v views of one fused projection; do a slice of a wider tensor
    # (strides the kernels read in place) and one with a stride of 65
    # elements (copied to a layout they read)
    g = torch.Generator(device="cpu").manual_seed(2)
    qkv = torch.randn(2, 96, 3, 4, 64, generator=g).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dlse = torch.zeros(2, 96, 4, device=cuda)
    for width in (128, 65):
        do = torch.randn(2, 96, 4, width, generator=g).to(
            cuda, torch.bfloat16)[..., :64]
        assert not do.is_contiguous()
        got, want = _kernel_and_plain_grads(q, k, v, do, dlse, causal=True)
        for a, b in zip(got, want):
            _assert_grad_close(a, b)


def test_cuda_kernel_reads_strided_views(cuda):
    # q/k/v as views into one fused projection, as the transformer has them
    g = torch.Generator(device="cpu").manual_seed(0)
    qkv = torch.randn(2, 96, 3, 4, 64, generator=g).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o = flash_attention(q, k, v, causal=True)
    o_ref, _ = flash_attention_reference(q, k, v, causal=True)
    _assert_o_close(o, o_ref)


def test_cuda_wrapper_refuses(cuda):
    q = torch.zeros(1, 64, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        flash_attention(q, q, q, causal=True)
    # inputs that need a gradient run the kernels, and a gradient flows
    q = q.to(torch.bfloat16).requires_grad_()
    flash_attention(q, q, q, causal=True).float().sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert bool(torch.isfinite(q.grad.float()).all())
    with pytest.raises(ValueError, match="unit stride"):
        p = torch.zeros(1, 64, 2, 128, device=cuda,
                        dtype=torch.bfloat16)[..., ::2]
        flash_attention(p, p, p, causal=True)


def test_cuda_lm_head_matches_fp32_product(cuda):
    # bf16 operands, fp32 output: the same function as the fp32 product
    # of the rounded operands, up to summation order
    g = torch.Generator(device="cpu").manual_seed(1)
    h = torch.randn(2, 50, 256, generator=g).to(cuda, torch.bfloat16)
    embed = torch.randn(1000, 256, generator=g).to(cuda)
    out = _lm_head(torch.bfloat16, h, embed)
    ref = h.float() @ embed.to(torch.bfloat16).float().T
    assert out.dtype == torch.float32 and out.shape == (2, 50, 1000)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


def test_cuda_forward_runs_every_layer_through_the_kernel(cuda):
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                            n_kv_heads=2, d_head=32, d_ff=256, n_layers=3,
                            max_seq=128, attention="flash",
                            dtype="bfloat16")
    params = params_from_jax(init_numpy_params(cfg, 0), cfg)
    toks = np.random.RandomState(0).randint(0, 256, (2, 100))
    flash_attention.launches = 0
    out = make_forward_fn(cfg)(params, toks)
    torch.cuda.synchronize()
    assert flash_attention.launches == cfg.n_layers
    local = make_forward_fn(dataclasses.replace(cfg, attention="local"))(
        params, toks)
    # bf16 activations through three layers, two attention paths
    torch.testing.assert_close(out, local, rtol=3e-2, atol=3e-2)


def test_cuda_flash_train_step_matches_local(cuda):
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                            n_kv_heads=2, d_head=32, d_ff=256, n_layers=3,
                            max_seq=128, attention="flash", remat=True,
                            dtype="bfloat16")
    local = dataclasses.replace(cfg, attention="local")
    toks = np.random.RandomState(1).randint(0, 256, (2, 101))
    x, y = toks[:, :-1], toks[:, 1:]
    params = params_from_jax(init_numpy_params(cfg, 0), cfg)
    flash_attention.launches = flash_attention.dq_launches = 0
    flash_attention.dkv_launches = 0
    loss, grads = make_value_and_grad_fn(cfg)(params, x, y)
    torch.cuda.synchronize()
    # remat runs each block's forward (and its kernel) again in backward
    assert _launch_counts() == (2 * cfg.n_layers, cfg.n_layers,
                                cfg.n_layers)
    # against the fp32 plain-attention gradients, the bf16 flash path is
    # as accurate as the bf16 plain path: both round every activation to
    # bf16 (2^-9 relative) through three layers and their backward
    exact_loss, exact = make_value_and_grad_fn(
        dataclasses.replace(local, dtype="float32"))(params, x, y)
    local_loss, plain = make_value_and_grad_fn(local)(params, x, y)
    torch.testing.assert_close(loss, exact_loss, rtol=1e-2, atol=1e-2)
    for name, g in grads["blocks"].items():
        err = ((g - exact["blocks"][name]).norm()
               / exact["blocks"][name].norm()).item()
        err_plain = ((plain["blocks"][name] - exact["blocks"][name]).norm()
                     / exact["blocks"][name].norm()).item()
        assert err < max(2 * err_plain, 1e-2), (name, err, err_plain)
    # and one SGD step through the port's train step moves the loss down
    opt = training.sgd(0.5)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    _, state, first = step(params, state, x, y)
    _, _, second = step(params, state, x, y)
    assert second.item() < first.item()


def test_cuda_remat_dots_launches_the_forward_once_a_layer(cuda):
    # "dots" keeps the flash forward's outputs (and the dense products):
    # its recompute launches no forward kernel, and the gradients are
    # bitwise those of "full", which recomputes them
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                            n_kv_heads=2, d_head=32, d_ff=256, n_layers=3,
                            max_seq=128, attention="flash", remat=True,
                            dtype="bfloat16")
    toks = np.random.RandomState(2).randint(0, 256, (2, 129))
    x, y = toks[:, :-1], toks[:, 1:]
    params = params_from_jax(init_numpy_params(cfg, 0), cfg)
    out = {}
    for policy in ("full", "dots"):
        flash_attention.launches = flash_attention.dq_launches = 0
        flash_attention.dkv_launches = 0
        out[policy] = make_value_and_grad_fn(dataclasses.replace(
            cfg, remat_policy=policy))(params, x, y)
        torch.cuda.synchronize()
        out[policy] += (_launch_counts(),)
    L = cfg.n_layers
    assert out["full"][2] == (2 * L, L, L)
    assert out["dots"][2] == (L, L, L)
    torch.testing.assert_close(out["dots"][0], out["full"][0], rtol=0,
                               atol=0)
    for name, g in out["dots"][1]["blocks"].items():
        torch.testing.assert_close(g, out["full"][1]["blocks"][name],
                                   rtol=0, atol=0)
    torch.testing.assert_close(out["dots"][1]["embed"],
                               out["full"][1]["embed"], rtol=0, atol=0)


def _moe_expert_fn(p, tokens):
    return torch.relu(tokens @ p["w1"]) @ p["w2"]


@pytest.mark.parametrize("top_k", [1, 2])
def test_cuda_moe_index_path_matches_dense_reference(cuda, top_k):
    # the index dispatch and combine against the one-hot einsums on the
    # card, bf16, at clipping capacity: the slots the same bits (a
    # one-hot product only selects), the drops the same, the outputs
    # within 1e-2 relative L2 (only a top-2 token's two fp32 terms may
    # sum in another order before the bf16 rounding), the gradients of
    # (out² + aux) within 2e-2 relative L2
    from chainermn_tpu_torch.parallel import expert as ep

    g = torch.Generator(device="cuda").manual_seed(0)
    N, D, F, E = 2048, 128, 256, 8

    def normal(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std) \
            .to(torch.bfloat16)

    x, rw = normal(N, D), normal(D, E, std=D ** -0.5)
    w = {"w1": normal(E, D, F, std=D ** -0.5),
         "w2": normal(E, F, D, std=F ** -0.5)}

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in
                  (x, rw, w["w1"], w["w2"])]
        out, aux, *rest = fn(leaves[0], leaves[1],
                             {"w1": leaves[2], "w2": leaves[3]},
                             _moe_expert_fn, capacity_factor=0.75,
                             top_k=top_k)
        ((out.float() ** 2).mean() + aux).backward()
        return out, aux, [t.grad for t in leaves], rest

    ep.expert_parallel_moe.routings = log = []
    out, aux, grads, _ = run(ep.expert_parallel_moe)
    ep.expert_parallel_moe.routings = None
    d_out, d_aux, d_grads, (d_slots,) = run(ep._moe_dense_reference)
    r = log[0]
    assert torch.equal(ep.dispatch(x, r), d_slots)
    assert int(r.dropped) > 0
    assert int(r.dropped) == N * top_k - int(
        (d_slots.float().abs().sum(-1) > 0).sum())
    assert bool((out[~r.keep.any(1)] == 0).all())
    rel = ((out.float() - d_out.float()).norm() / d_out.float().norm())
    assert rel.item() < 1e-2
    assert abs(aux.item() - d_aux.item()) < 1e-5
    for a, b in zip(grads, d_grads):
        rel = (a.float() - b.float()).norm() / b.float().norm()
        assert rel.item() < 2e-2


def test_cuda_moe_step_launches_the_dense_steps_kernels(cuda):
    # an MoE flagship step at a small width: the flash kernels launch as
    # the dense step's (forward twice under remat, dq and dk/dv once a
    # layer); its loss against the plain-attention loss
    from chainermn_tpu_torch.models.transformer import lm_loss

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                            n_kv_heads=2, d_head=32, d_ff=256, n_layers=4,
                            max_seq=128, attention="flash", remat=True,
                            dtype="bfloat16", moe=True, n_experts=4,
                            router_top_k=2)
    toks = np.random.RandomState(2).randint(0, 256, (8, 129))
    x, y = toks[:, :-1], toks[:, 1:]
    params = params_from_jax(init_numpy_params(cfg, 0), cfg)
    with torch.no_grad():
        want = lm_loss(dataclasses.replace(cfg, attention="local"), params,
                       torch.as_tensor(x, device="cuda"),
                       torch.as_tensor(y, device="cuda")).item()
    flash_attention.launches = flash_attention.dq_launches = 0
    flash_attention.dkv_launches = 0
    loss, _ = make_value_and_grad_fn(cfg)(params, x, y)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert _launch_counts() == (2 * L, L, L)
    assert abs(loss.item() - want) < 1e-2 * abs(want)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_cuda_pipeline_schedules_match_the_plain_step(cuda, schedule):
    # the pipe axis's schedules at pipe=1 over 4 micro-batches of two
    # rows against the plain step: bf16 products at other shapes and the
    # loss a mean of 4 means, so the bars of chip_smoke.py's phase 17
    # (loss 1e-3 relative, gradients 2e-2 relative L2 over the tree);
    # each layer's kernels on each micro-batch: the forward twice (the
    # stage's forward, then its recompute), dq and dk/dv once
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                            n_kv_heads=2, d_head=32, d_ff=256, n_layers=4,
                            max_seq=128, attention="flash", remat=True,
                            dtype="bfloat16")
    toks = np.random.RandomState(2).randint(0, 256, (8, 129))
    x, y = toks[:, :-1], toks[:, 1:]
    want_loss, want = make_value_and_grad_fn(cfg)(
        params_from_jax(init_numpy_params(cfg, 0), cfg), x, y)
    pcfg = dataclasses.replace(
        cfg, num_microbatches=4, pipeline_schedule=schedule,
        virtual_pipe=2 if schedule == "interleaved" else 1)
    params = params_from_jax(init_numpy_params(pcfg, 0), pcfg)
    flash_attention.launches = flash_attention.dq_launches = 0
    flash_attention.dkv_launches = 0
    loss, grads = make_value_and_grad_fn(pcfg)(params, x, y)
    torch.cuda.synchronize()
    L, M = cfg.n_layers, pcfg.num_microbatches
    assert _launch_counts() == (2 * L * M, L * M, L * M)
    assert abs(loss.item() - want_loss.item()) < 1e-3 * abs(want_loss.item())
    grads["blocks"] = {k: v.reshape(want["blocks"][k].shape)
                       for k, v in grads["blocks"].items()}
    pairs = [(grads[k], want[k]) for k in ("embed", "pos", "ln_f")] + [
        (grads["blocks"][k], w) for k, w in want["blocks"].items()]
    num = sum(((a - b).float().norm() ** 2).item() for a, b in pairs)
    den = sum((b.float().norm() ** 2).item() for _, b in pairs)
    assert (num / den) ** 0.5 < 2e-2


@pytest.mark.parametrize("layout,window", [("contiguous", None),
                                           ("zigzag", None),
                                           ("zigzag", 200)])
def test_cuda_ring_schedule_matches_plain(cuda, layout, window):
    # every rank's ring body of a 4-rank ring on the card, the kernels a
    # pair, against the same schedule over the kernels' plain versions
    # (the same inputs on the CPU); launches as the schedule predicts
    from chainermn_tpu_torch.parallel import simulate_ring
    from chainermn_tpu_torch.parallel.ring_attention import ring_launches

    S, T, H, G, D = 4, 512, 4, 2, 64
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn(2, T, h, D, generator=g).to(torch.bfloat16)
                   for h in (H, G, G, H))
    kw = dict(S=S, causal=True, window=window, layout=layout,
              use_flash=True)
    outs = {}
    for dev in ("cuda", "cpu"):
        qq, kk, vv = (t.to(dev).requires_grad_() for t in (q, k, v))
        flash_attention.launches = flash_attention.dq_launches = 0
        flash_attention.dkv_launches = 0
        o = simulate_ring(qq, kk, vv, **kw)
        grads = torch.autograd.grad((o * do.to(dev)).sum(), (qq, kk, vv))
        outs[dev] = [t.cpu() for t in (o, *grads)]
        if dev == "cuda":
            torch.cuda.synchronize()
            n = ring_launches(S, T // S, causal=True, window=window,
                              layout=layout)
            assert _launch_counts() == (n, n, n)
    _assert_o_close(outs["cuda"][0], outs["cpu"][0])
    for got, want in zip(outs["cuda"][1:], outs["cpu"][1:]):
        _assert_grad_close(got, want)


def test_cuda_ring_and_ulysses_paths_launch_the_kernels(cuda):
    # one rank: the ring's single pair is bitwise the flash path, and
    # Ulysses runs the kernel on the whole sequence
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                            n_kv_heads=2, d_head=32, d_ff=256, n_layers=2,
                            max_seq=128, attention="flash", remat=True,
                            dtype="bfloat16")
    toks = np.random.RandomState(4).randint(0, 256, (2, 129))
    x, y = toks[:, :-1], toks[:, 1:]
    params = params_from_jax(init_numpy_params(cfg, 0), cfg)
    out = {}
    for attention in ("flash", "ring", "ulysses"):
        flash_attention.launches = flash_attention.dq_launches = 0
        flash_attention.dkv_launches = 0
        out[attention] = make_value_and_grad_fn(dataclasses.replace(
            cfg, attention=attention))(params, x, y)
        torch.cuda.synchronize()
        L = cfg.n_layers
        assert _launch_counts() == (2 * L, L, L), attention
    for attention in ("ring", "ulysses"):
        torch.testing.assert_close(out[attention][0], out["flash"][0],
                                   rtol=0, atol=0)
        for name, g in out[attention][1]["blocks"].items():
            torch.testing.assert_close(
                g, out["flash"][1]["blocks"][name], rtol=0, atol=0)


# --------------------------------------------------------------------- #
# ChainerMN's data-parallel path: NCCL at one rank, the exchange, ResNet
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def nccl_comm(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on the card only")
    from chainermn_tpu_torch.communicators import (
        create_communicator,
        init_distributed,
    )

    store = tmp_path_factory.mktemp("nccl") / "store"
    init_distributed(init_method=f"file://{store}", world_size=1, rank=0)
    yield create_communicator()
    torch.distributed.destroy_process_group()


def test_cuda_nccl_world_of_one(nccl_comm):
    comm = nccl_comm
    assert torch.distributed.get_backend() == "nccl"
    assert (comm.size, comm.rank, comm.device.type) == (1, 0, "cuda")
    x = torch.randn(3, 4, device="cuda")
    for op in ("sum", "mean", "max", "min", "prod"):
        torch.testing.assert_close(comm.allreduce(x, op), x)
    torch.testing.assert_close(comm.bcast(x), x)
    torch.testing.assert_close(comm.allgather(x), x[None])
    torch.testing.assert_close(comm.alltoall(x[None]), x[None])
    torch.testing.assert_close(comm.reduce_scatter(x[None]), x)
    torch.testing.assert_close(comm.scatter(x[None]), x)
    assert comm.allgather_obj({"a": 1}) == [{"a": 1}]
    assert comm.alltoall_obj([("x", 2)]) == [("x", 2)]
    comm.barrier()
    with pytest.raises(ValueError, match="given to a communicator on cuda"):
        comm.allreduce(torch.ones(2))             # no gloo for CPU tensors


def test_cuda_dp_step_on_one_rank_is_the_plain_step(nccl_comm):
    # the data axis at one NCCL rank: the fp32 mean of the gradients and
    # of the loss is a copy, so the step is bitwise the step without comm
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                            n_kv_heads=2, d_head=32, d_ff=256, n_layers=2,
                            max_seq=128, attention="flash", remat=True,
                            dtype="bfloat16")
    toks = np.random.RandomState(3).randint(0, 256, (4, 129))
    x, y = toks[:, :-1], toks[:, 1:]
    runs = []
    for comm in (None, nccl_comm):
        params = params_from_jax(init_numpy_params(cfg, 0), cfg)
        opt = training.adamw(3e-4)
        state = opt.init(params)
        step = make_train_step(cfg, opt, comm=comm)
        losses = [step(params, state, x, y)[2] for _ in range(2)]
        runs.append((losses, params))
    (la, pa), (lb, pb) = runs
    for a, b in zip(la, lb):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    for name, t in pa["blocks"].items():
        torch.testing.assert_close(pb["blocks"][name], t, rtol=0, atol=0)
    for name in ("embed", "pos", "ln_f"):
        torch.testing.assert_close(pb[name], pa[name], rtol=0, atol=0)


def test_cuda_seq1_ring_step_and_dp_generate_on_one_rank(nccl_comm):
    # the mesh at one NCCL rank: the ring step at seq=1 is bitwise the
    # flash step, and data-axis decoding is bitwise the plain decoding
    from chainermn_tpu_torch.models import make_generate_fn
    from chainermn_tpu_torch.parallel import MeshConfig

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                            n_kv_heads=2, d_head=32, d_ff=256, n_layers=2,
                            max_seq=128, attention="flash", remat=True,
                            dtype="bfloat16")
    mesh = MeshConfig(nccl_comm, data=1, seq=1)
    toks = np.random.RandomState(5).randint(0, 256, (4, 129))
    x, y = toks[:, :-1], toks[:, 1:]
    runs = []
    for c, m in ((cfg, None), (dataclasses.replace(cfg, attention="ring"),
                               mesh)):
        params = params_from_jax(init_numpy_params(cfg, 0), cfg)
        opt = training.adamw(3e-4)
        state = opt.init(params)
        step = make_train_step(c, opt, mesh=m)
        runs.append(([step(params, state, x, y)[2] for _ in range(2)],
                     params))
    (la, pa), (lb, pb) = runs
    for a, b in zip(la, lb):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    for name, t in pa["blocks"].items():
        torch.testing.assert_close(pb["blocks"][name], t, rtol=0, atol=0)
    prompt = toks[:, :16]
    eos = int(make_generate_fn(cfg, max_len=48)(pa, prompt)[0, 20])
    kw = dict(max_len=48, eos_id=eos, with_row_state=True)
    plain = make_generate_fn(cfg, **kw)(pa, prompt)
    dp = make_generate_fn(cfg, mesh=mesh, **kw)(pa, prompt)
    for a, b in zip(plain, dp):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_cuda_exchange_is_bf16_bitwise(nccl_comm):
    from chainermn_tpu_torch.ops import fused

    g = torch.Generator(device="cpu").manual_seed(5)
    tree = {"big": torch.randn(3_000_001, generator=g).cuda(),
            "w": [torch.randn(64, 3, 7, 7, generator=g).cuda()
                  for _ in range(4)],
            "steps": torch.tensor([7, 1 << 20], device="cuda"),
            "empty": torch.zeros(0, 4, device="cuda")}
    before = nccl_comm.n_collectives
    out = nccl_comm.multi_node_mean_grad(
        {k: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
         for k, v in tree.items()}, torch.bfloat16)
    count = nccl_comm.n_collectives - before
    bf = lambda t: t.to(torch.bfloat16).to(t.dtype)
    assert torch.equal(out["big"], bf(tree["big"]))
    assert all(torch.equal(a, bf(b)) for a, b in zip(out["w"], tree["w"]))
    assert torch.equal(out["steps"], tree["steps"])   # ints never take bf16
    assert out["empty"].shape == (0, 4)
    wire = 2 * (tree["big"].numel() + 4 * 64 * 3 * 49) + 8 * 2
    assert 0 < count <= fused.fused_collective_budget(
        wire, fused.DEFAULT_BUCKET_BYTES, 2)


def test_cuda_sync_bn_through_nccl_equals_local(nccl_comm):
    from chainermn_tpu_torch.links import (
        init_batch_norm,
        multi_node_batch_normalization,
    )

    params, state = init_batch_norm(16, device="cuda")
    x = torch.randn(8, 16, 5, 5, device="cuda", dtype=torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    y1, s1 = multi_node_batch_normalization(params, state, x, nccl_comm)
    y0, s0 = multi_node_batch_normalization(params, state, x)
    assert y1.dtype == torch.bfloat16 and torch.equal(y1, y0)
    assert all(torch.equal(a, b) for a, b in zip(s1, s0))


def test_cuda_resnet_fp32_forward_matches_cpu(cuda):
    from chainermn_tpu_torch.models import (
        ResNetConfig,
        init_resnet_numpy,
        resnet_apply,
        resnet_params_from_jax,
    )

    cfg = ResNetConfig(depth=50, num_classes=8, width=8, dtype="float32")
    tree = init_resnet_numpy(cfg, 0)
    x = np.random.RandomState(0).randn(4, 33, 33, 3).astype(np.float32)
    for train in (True, False):
        got, _ = resnet_apply(cfg, *resnet_params_from_jax(*tree, cfg),
                              torch.tensor(x, device="cuda"), train=train)
        want, _ = resnet_apply(cfg, *resnet_params_from_jax(*tree, cfg,
                                                           device="cpu"),
                               torch.tensor(x), train=train)
        # cuDNN's fp32 algorithms (TF32 off) and the CPU's sum the same
        # products in other orders
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# checkpoints of tensors on the card
# --------------------------------------------------------------------- #

def test_cuda_snapshot_round_trip_is_bitwise(cuda, tmp_path):
    from chainermn_tpu_torch.utils import load_state, save_state

    g = torch.Generator(device="cuda").manual_seed(3)
    wide = torch.randn(64, 96, device="cuda", generator=g)
    conv = torch.randn(8, 16, 3, 3, device="cuda", generator=g)
    tree = {"fp32": torch.randn(1000, device="cuda", generator=g),
            "bf16": torch.randn(33, 7, device="cuda",
                                generator=g).to(torch.bfloat16),
            "bf16_t": wide.to(torch.bfloat16).t(),     # not contiguous
            "sliced": wide[:, 1::3],                    # not contiguous
            "channels_last": conv.contiguous(
                memory_format=torch.channels_last),
            "count": torch.tensor(5, dtype=torch.int32, device="cuda")}
    save_state(str(tmp_path / "s.npz"), tree)
    got = load_state(str(tmp_path / "s.npz"))
    for k, want in tree.items():
        back = torch.as_tensor(got[k]).to("cuda")
        assert back.dtype == want.dtype and back.shape == want.shape, k
        assert torch.equal(back, want), k


def test_cuda_async_save_survives_inplace_update(cuda, tmp_path):
    """The card's in-place hazard: the next step's optimizer mutates the
    parameters and momentum right after an async ``save`` returns; the
    file must hold the values before it, bitwise."""
    from types import SimpleNamespace

    from chainermn_tpu_torch.communicators import LoopbackCommunicator
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )

    comm = LoopbackCommunicator()
    g = torch.Generator(device="cuda").manual_seed(4)
    params = {"w": torch.randn(4_000_000, device="cuda", generator=g),
              "v": torch.randn(512, 512, device="cuda",
                               generator=g).to(torch.bfloat16)}
    opt = training.sgd(0.1, momentum=0.9)
    up = SimpleNamespace(comm=comm, iteration=7, params=params,
                         opt_state=opt.init(params), state=None)

    def step():
        opt.update({k: torch.ones_like(t) for k, t in params.items()},
                   up.opt_state, params)

    step()
    before = {k: t.clone() for k, t in params.items()}
    mom = [up.opt_state.state[t]["trace"].clone()
           for t in params.values()]
    cp = create_multi_node_checkpointer(comm, str(tmp_path),
                                        async_write=True)
    cp.save(up)
    for _ in range(3):
        step()                       # queued right behind the copies
    cp.finalize()
    fresh = {k: torch.zeros_like(t) for k, t in params.items()}
    up2 = SimpleNamespace(comm=comm, iteration=0, params=fresh,
                          opt_state=opt.init(fresh), state=None)
    assert create_multi_node_checkpointer(
        comm, str(tmp_path)).maybe_load(up2) == 7
    for k in params:
        assert torch.equal(fresh[k], before[k]), k
        assert not torch.equal(params[k], before[k]), k
    got = [up2.opt_state.state[t]["trace"] for t in fresh.values()]
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(got, mom))


# --------------------------------------------------------------------- #
# the host feed on the card
# --------------------------------------------------------------------- #

def _feed_arrays(n=64, side=64):
    rng = np.random.RandomState(2)
    return (rng.randn(n, side, side, 3).astype(np.float32),
            rng.randint(0, 1000, n).astype(np.int32))


def test_prefetch_delivers_on_the_card_from_its_stream(cuda):
    """Batches arrive on the card, copied on the worker's side stream
    (an event behind the copies), through a pinned staging ring, equal
    to the serial feed's, over the serial iterator and the C++ loader."""
    from chainermn_tpu_torch.communicators import LoopbackCommunicator
    from chainermn_tpu_torch.iterators import (
        PrefetchIterator, SerialIterator, StagingConverter)
    from chainermn_tpu_torch.native import NativeBatchIterator

    xs, ys = _feed_arrays()
    comm = LoopbackCommunicator(device="cuda")
    feeds = (lambda: SerialIterator((xs, ys), 16, shuffle=True, seed=1),
             lambda: NativeBatchIterator([xs, ys], 16, shuffle=True,
                                         seed=1))
    for make in feeds:
        pf, ref = PrefetchIterator(make(), comm, depth=2), make()
        conv = pf._converter
        assert isinstance(conv, StagingConverter) and conv.pin_memory
        assert pf._stream is not None \
            and pf._stream != torch.cuda.current_stream()
        for _ in range(6):
            rec = next(pf)
            want = tuple(np.array(a) for a in next(ref))
            assert isinstance(rec.event, torch.cuda.Event)
            for t, w in zip(rec.arrays, want):
                assert t.is_cuda
                np.testing.assert_array_equal(t.cpu().numpy(), w)
        bufs = [b for ring in conv._rings.values() for b in ring]
        assert bufs and all(b.tensor.is_pinned() for b in bufs)
        pf.close()


def test_recycled_staging_buffer_waits_for_its_copy(cuda):
    """A two-buffer ring and 48 MB batches: every reuse of a buffer finds
    the event of the copy that read it, and the copy has completed when
    the buffer is written again."""
    from chainermn_tpu_torch.communicators import LoopbackCommunicator
    from chainermn_tpu_torch.iterators import (
        PrefetchIterator, SerialIterator, StagingConverter)

    class Spy(StagingConverter):
        reuses = 0

        def _staging(self, key, shape, dtype):
            ring = self._rings.get(key, [])
            i = self._turn.get(key, 0)
            fence = ring[i].fence if i < len(ring) else None
            out = super()._staging(key, shape, dtype)
            if fence is not None:
                Spy.reuses += 1
                assert fence.query(), "buffer rewritten before its copy"
            return out

    rng = np.random.RandomState(3)
    xs = rng.randn(8 * 16, 256, 256, 3).astype(np.float32)  # 48 MB a batch
    comm = LoopbackCommunicator(device="cuda")
    pf = PrefetchIterator(SerialIterator((xs,), 16), comm,
                          converter=Spy(n_buffers=2, pin_memory=True),
                          depth=2)
    ref = SerialIterator((xs,), 16)
    for _ in range(8):
        got = next(pf).arrays[0]
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), next(ref)[0])
    pf.close()
    assert Spy.reuses >= 5


# --------------------------------------------------------------------- #
# the large-batch path: windows as CUDA graphs, double buffering's
# stream, the overlapped exchange
# --------------------------------------------------------------------- #

def _tiny_resnet_job(comm, opt, steps_per_execution=1, accum_steps=2,
                     loss_hook=None, n=64):
    """A width-4 ResNet-50 with sync BN over ``comm`` on 16 px images,
    fp32, cuDNN pinned; ``n`` images in batches of 8."""
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import (
        ResNetConfig, init_resnet_numpy, resnet_apply,
        resnet_params_from_jax, softmax_cross_entropy)

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    cfg = ResNetConfig(depth=50, num_classes=10, width=4, dtype="float32")
    params, state = resnet_params_from_jax(*init_resnet_numpy(cfg, 0), cfg,
                                           device="cuda")
    rng = np.random.RandomState(4)
    xs = rng.randn(n, 16, 16, 3).astype(np.float32)
    ys = rng.randint(0, 10, n).astype(np.int32)

    def loss_fn(p, s, x, y):
        logits, new_s = resnet_apply(cfg, p, s, x, train=True, comm=comm)
        loss = softmax_cross_entropy(logits, y)
        if loss_hook is not None:
            loss_hook(loss)
        return loss, new_s

    return training.StandardUpdater(
        SerialIterator((xs, ys), 8, shuffle=True, seed=1), opt, loss_fn,
        params, comm, state=state, steps_per_execution=steps_per_execution,
        accum_steps=accum_steps)


def _lars_opt(comm, **kw):
    sched = training.join_schedules(
        [training.linear_schedule(0.1, 0.4, 2),
         training.cosine_decay_schedule(0.4, 20)], [2])
    return training.create_multi_node_optimizer(
        training.lars(sched, weight_decay=1e-4), comm,
        allreduce_grad_dtype=torch.bfloat16, **kw)


def _same(a, b):
    import torch.utils._pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))


def test_cuda_window_graph_replays_bitwise_eager(nccl_comm):
    """Three windows of two updates of two microbatches (warm-up,
    capture and replay, replay) against six eager updates: parameters,
    BN state and optimizer state bitwise, with double buffering's stream
    and a scheduled LARS inside the graph."""
    graph = _tiny_resnet_job(nccl_comm, _lars_opt(nccl_comm,
                                                  double_buffering=True),
                             steps_per_execution=2)
    eager = _tiny_resnet_job(nccl_comm, _lars_opt(nccl_comm,
                                                  double_buffering=True))
    assert graph.graphs and not eager.graphs
    for _ in range(3):
        graph.update()
    for _ in range(6):
        eager.update()
    window = next(iter(graph._windows.values()))
    assert window.graph is not None and window.replays == 2
    assert graph.iteration == eager.iteration == 12
    assert _same(graph.params, eager.params)
    assert _same(graph.state, eager.state)
    assert _same(training.optimizer_state_tree(graph.opt_state),
                 training.optimizer_state_tree(eager.opt_state))


def test_cuda_stateless_window_graph_replays_bitwise_eager(nccl_comm):
    """A model without state (an MLP, ``state=None``): its captured
    window (warm-up, capture and replay, replay) is bitwise its eager
    run."""
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import (
        init_mlp_numpy, mlp_apply, mlp_params_from_jax,
        softmax_cross_entropy)

    rng = np.random.RandomState(6)
    xs = rng.randn(64, 16).astype(np.float32)
    ys = rng.randint(0, 4, 64).astype(np.int32)

    def job(spe):
        return training.StandardUpdater(
            SerialIterator((xs, ys), 8, shuffle=True, seed=1),
            _lars_opt(nccl_comm, double_buffering=True),
            lambda p, x, y: softmax_cross_entropy(mlp_apply(p, x), y),
            mlp_params_from_jax(init_mlp_numpy([16, 32, 4], 0), "cuda"),
            nccl_comm, steps_per_execution=spe, accum_steps=2)

    graph, eager = job(2), job(1)
    for _ in range(3):
        graph.update()
    for _ in range(6):
        eager.update()
    window = next(iter(graph._windows.values()))
    assert window.graph is not None and window.replays == 2
    assert graph.state is None and _same(graph.params, eager.params)
    assert _same(training.optimizer_state_tree(graph.opt_state),
                 training.optimizer_state_tree(eager.opt_state))


def test_cuda_double_buffering_stream_is_the_plain_order(nccl_comm):
    """Double buffering with the exchange on the communication stream
    equals the same optimizer with every operation on one stream."""
    on_side = _lars_opt(nccl_comm, double_buffering=True)
    plain = _lars_opt(nccl_comm, double_buffering=True)
    plain._side_stream = lambda device: None
    a = _tiny_resnet_job(nccl_comm, on_side, accum_steps=1)
    b = _tiny_resnet_job(nccl_comm, plain, accum_steps=1)
    for _ in range(4):
        a.update()
        b.update()
    assert on_side._stream is not None and plain._stream is None
    assert _same(a.params, b.params)
    assert _same(training.optimizer_state_tree(a.opt_state),
                 training.optimizer_state_tree(b.opt_state))


def test_cuda_overlap_hooks_fire_once_a_bucket(nccl_comm):
    """The overlapped exchange, bucket by bucket from the hooks of the
    last microbatch's backward on the communication stream, in schedule
    order, equals the window-end exchange bitwise."""
    opt = _lars_opt(nccl_comm, overlap=True, bucket_bytes=4096)
    seen = []
    make = opt.overlapped
    opt.overlapped = lambda p: seen.append(make(p)) or seen[-1]
    a = _tiny_resnet_job(nccl_comm, opt)
    b = _tiny_resnet_job(nccl_comm, _lars_opt(nccl_comm))
    for _ in range(2):
        a.update()
        b.update()
    n = len(opt.mean.schedule)
    assert n > 4 and len(seen) == 2
    assert all(ex.launched == list(range(n)) for ex in seen)
    assert _same(a.params, b.params) and _same(a.state, b.state)


def test_cuda_finalize_frees_captured_windows(nccl_comm):
    """``finalize()`` (the trainer's exit) frees each captured window's
    graph, whose NCCL collectives would keep ``destroy_process_group``
    waiting; training after it warms up and captures again, and stays
    bitwise the eager run."""
    import weakref

    graph = _tiny_resnet_job(nccl_comm, _lars_opt(nccl_comm,
                                                  double_buffering=True),
                             steps_per_execution=2)
    eager = _tiny_resnet_job(nccl_comm, _lars_opt(nccl_comm,
                                                  double_buffering=True))
    for _ in range(2):
        graph.update()
    window = weakref.ref(next(iter(graph._windows.values())))
    assert window().graph is not None
    graph.finalize()
    assert graph._windows == {} and window() is None
    for _ in range(2):
        graph.update()
    assert next(iter(graph._windows.values())).graph is not None
    for _ in range(8):
        eager.update()
    assert graph.iteration == eager.iteration == 16
    assert _same(graph.params, eager.params)
    assert _same(training.optimizer_state_tree(graph.opt_state),
                 training.optimizer_state_tree(eager.opt_state))


# --------------------------------------------------------------------- #
# the other example models and shard-only sets on the card
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,head,size", [
    ("alex", "gap", 32), ("nin", "gap", 32), ("vgg16", "gap", 32),
    ("googlenet", "gap", 32), ("alex", "flatten", 227),
    ("googlenet", "flatten", 224)])
def test_cuda_convnet_forward_matches_cpu(cuda, arch, head, size):
    """fp32 logits (and GoogLeNet's aux heads) on the card against the
    CPU's on the same numpy parameters: 1e-4 relative L2 (TF32 off; the
    convolution algorithms sum in other orders)."""
    from chainermn_tpu_torch.models import (
        ConvNetConfig, convnet_apply, convnet_params_from_jax,
        init_convnet_numpy)

    cfg = ConvNetConfig(arch=arch, head=head, image_size=size,
                        num_classes=10, dtype="float32")
    tree = init_convnet_numpy(cfg, 0)
    x = np.random.RandomState(1).randn(2, size, size, 3).astype(np.float32)
    aux = arch == "googlenet"
    with torch.no_grad():
        got = convnet_apply(cfg, convnet_params_from_jax(tree, cfg, cuda),
                            torch.tensor(x, device=cuda), with_aux=aux)
        want = convnet_apply(cfg, convnet_params_from_jax(tree, cfg, "cpu"),
                             torch.tensor(x), with_aux=aux)
    for g, w in zip(got if aux else (got,), want if aux else (want,)):
        assert g.device.type == "cuda" and g.dtype == torch.float32
        assert ((g.cpu() - w).norm() / w.norm()).item() < 1e-4


def test_cuda_seq2seq_matches_cpu(cuda):
    """The loss and every gradient leaf on the card against the CPU's to
    1e-5 relative (of the leaf's largest element), the greedy tokens
    equal."""
    import torch.utils._pytree as pytree

    from chainermn_tpu_torch.models import (
        Seq2seqConfig, init_seq2seq_numpy, seq2seq_loss,
        seq2seq_params_from_jax, seq2seq_translate)

    cfg = Seq2seqConfig(src_vocab=50, tgt_vocab=50, d_embed=32,
                        d_hidden=48, n_layers=2)
    tree = init_seq2seq_numpy(cfg, 0)
    rng = np.random.RandomState(0)
    src = np.zeros((8, 10), np.int32)
    tgt = np.zeros((8, 11), np.int32)
    for i in range(8):
        n = rng.randint(2, 11)
        s = rng.randint(3, 50, n)
        src[i, :n], tgt[i, :n], tgt[i, n] = s, s[::-1], 2
    out = {}
    for dev in (cuda, "cpu"):
        p = seq2seq_params_from_jax(tree, cfg, device=dev)
        leaves = pytree.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = seq2seq_loss(cfg, p, src, tgt)
        grads = torch.autograd.grad(loss, leaves)
        out[str(dev)] = (loss.item(), [g.cpu() for g in grads],
                         seq2seq_translate(cfg, p, src, max_len=11).cpu())
    (lc, gc, tc), (lh, gh, th) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    for a, b in zip(gc, gh):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert torch.equal(tc, th)


def test_cuda_shard_only_round_trip(nccl_comm, tmp_path):
    """A ZeRO-1 job's full and shard-only sets on the card, each resumed
    by an ``elastic=True`` checkpointer at the same topology: the exact
    path, bitwise the saved state."""
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )

    def opt():
        return training.create_multi_node_optimizer(
            training.sgd(0.1, momentum=0.9), nccl_comm, zero1=True)

    up = _tiny_resnet_job(nccl_comm, opt(), accum_steps=1)
    up.update()
    up.update()
    for shard_only in (False, True):
        path = str(tmp_path / f"ck{int(shard_only)}")
        create_multi_node_checkpointer(nccl_comm, path, elastic=True,
                                       shard_only=shard_only).save(up)
        again = _tiny_resnet_job(nccl_comm, opt(), accum_steps=1)
        cp = create_multi_node_checkpointer(nccl_comm, path, elastic=True,
                                            shard_only=shard_only)
        assert cp.maybe_load(again) == 2 and cp.last_resume_mode == "exact"
        assert _same(again.params, up.params)
        assert _same(again.state, up.state)
        assert _same(training.optimizer_state_tree(again.opt_state),
                     training.optimizer_state_tree(up.opt_state))


def test_cuda_failed_capture_raises(nccl_comm):
    """A step that reads a value on the host cannot be captured: the
    capture raises, and nothing runs the window eagerly in its place.
    Last in the file: a failed capture may leave the context unusable
    for later captures."""
    capturing = []

    def hook(loss):
        if torch.cuda.is_current_stream_capturing():
            capturing.append(True)
        float(loss)              # a host read: illegal in a capture

    up = _tiny_resnet_job(nccl_comm, _lars_opt(nccl_comm),
                          steps_per_execution=2, loss_hook=hook)
    up.update()                  # the warm-up window runs eagerly
    with pytest.raises(RuntimeError):
        up.update()
    assert capturing
    window = next(iter(up._windows.values()))
    assert window.graph is None and window.replays == 0
    assert up.iteration == 4
