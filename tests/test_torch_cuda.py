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
    mom = [up.opt_state.state[t]["momentum_buffer"].clone()
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
    got = [up2.opt_state.state[t]["momentum_buffer"] for t in fresh.values()]
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(got, mom))
