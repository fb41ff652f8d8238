"""The port's flash-attention gradients against the JAX package's VJP
(the Pallas ``_dq_kernel``/``_dkv_kernel`` in interpret mode) and, for
grouped K/V, against the gradients of its grouped ``local_attention``.

On the CPU the port's ``flash_attention`` backward runs
``flash_attention_bwd_reference``, which repeats the Hopper kernels'
arithmetic; the kernels themselves are held against it on the card in
``test_torch_cuda.py``.  The loss is the JAX package's own gradient test
loss, ``sum(o·cos o)`` (``tests/function_tests/test_pallas_attention.py``).

Tolerances: fp32 inputs differ only in summation order and tile size (the
JAX kernels sweep 32-row blocks, or one block of the whole length; the
port's dq sums 128-key tiles, 64 at D=128, and its dk/dv 64-query
tiles), so gradients
agree to rtol 5e-4 / atol 5e-5, the JAX package's own flash-vs-oracle
gradient bound.  bf16 inputs also round ``p`` and ``ds`` to bf16 before
their products, and the gradients themselves to bf16 (one ulp is 2^-8
relative); ``p`` is rebuilt from an ``lse`` that the two forwards sum in
other orders, so a rounding may flip by one ulp: 1e-2 relative and
absolute, the forward's bf16 bound (``test_torch_flash_attention.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.pallas_attention import flash_attention as jax_flash
from chainermn_tpu.parallel.ring_attention import local_attention as jax_local
from chainermn_tpu_torch.ops import (
    flash_attention,
    flash_attention_bwd_reference,
)
from chainermn_tpu_torch.parallel import broadcast_kv

B, T, H, D = 2, 64, 2, 16
FP32_TOL = dict(rtol=5e-4, atol=5e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def qkv(seed=0, heads=(H, H, H)):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, T, h, D) * 0.5).astype(np.float32) for h in heads]


def multi_tile_qkv(seed, tq, tk, d=D):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, tq, H, d) * 0.5).astype(np.float32)
    k, v = ((rng.randn(B, tk, H, d) * 0.5).astype(np.float32)
            for _ in range(2))
    return q, k, v


def jax_grads(q, k, v, dtype=jnp.float32, with_lse=False, block=32, **kw):
    def loss(q, k, v):
        o, lse = jax_flash(q, k, v, block_q=block, block_k=block,
                           interpret=True, return_lse=True, **kw)
        o = o.astype(jnp.float32)
        out = jnp.sum(o * jnp.cos(o))
        return out + jnp.sum(jnp.sin(lse)) if with_lse else out

    g = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in g]


def port_grads(q, k, v, dtype=torch.float32, with_lse=False, **kw):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention(*ts, return_lse=True, **kw)
    o = o.float()
    loss = (o * o.cos()).sum()
    if with_lse:
        loss = loss + lse.sin().sum()
    return [g.float().numpy() for g in torch.autograd.grad(loss, ts)]


CASES = [
    dict(causal=False),
    dict(causal=True),
    dict(causal=True, window=8),
    dict(causal=True, q_offset=64, k_offset=32),
    # k_offset > q_offset: rows 0..31 see no key at all
    dict(causal=True, q_offset=0, k_offset=32),
    dict(causal=True, window=8, q_offset=0, k_offset=32),
]


@pytest.mark.parametrize("kw", CASES, ids=[str(c) for c in CASES])
def test_grads_match_jax_fp32(kw):
    q, k, v = qkv(1)
    for got, want in zip(port_grads(q, k, v, **kw), jax_grads(q, k, v, **kw)):
        np.testing.assert_allclose(got, want, **FP32_TOL)


# the lse cotangent: sin(lse) needs rows that see keys (lse is finite)
LSE_CASES = [dict(causal=True), dict(causal=True, q_offset=64, k_offset=32)]


@pytest.mark.parametrize("kw", LSE_CASES, ids=[str(c) for c in LSE_CASES])
def test_grads_through_lse_match_jax(kw):
    q, k, v = qkv(2)
    got = port_grads(q, k, v, with_lse=True, **kw)
    want = jax_grads(q, k, v, with_lse=True, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **FP32_TOL)
    # and dlse really enters: without it the gradients differ
    plain = port_grads(q, k, v, **kw)
    assert np.abs(got[0] - plain[0]).max() > 1e-3


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=8)])
def test_grads_match_jax_bf16(kw):
    q, k, v = qkv(3)
    got = port_grads(q, k, v, torch.bfloat16, **kw)
    want = jax_grads(q, k, v, jnp.bfloat16, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **BF16_TOL)


# Cases over several of the backward kernels' tiles (dq: 128-key tiles,
# 64 at D=128; dk/dv: 64-query tiles): ragged tails, Tq != Tk, a window
# across tile edges, offsets, whole tiles masked.  The JAX kernels run
# them as one block per axis (their lengths must be multiples of 8).
TILE_CASES = {
    "ragged tail, causal": (200, 200, dict(causal=True)),
    "Tq != Tk, suffix queries": (160, 288, dict(causal=True, q_offset=128)),
    "Tq != Tk, non-causal": (96, 288, dict(causal=False)),
    "window across tile edges": (288, 288, dict(causal=True, window=100)),
    "window and offsets": (
        200, 288, dict(causal=True, window=70, q_offset=150, k_offset=40)),
    "whole tiles masked": (288, 288,
                           dict(causal=True, q_offset=0, k_offset=160)),
}


# every case at D=16, and two at D=128, where the dq kernel's K tiles
# are 64 keys
MULTI_TILE = [(case, D) for case in TILE_CASES] + [
    ("window across tile edges", 128), ("Tq != Tk, suffix queries", 128)]


@pytest.mark.parametrize("case,d", MULTI_TILE,
                         ids=[f"{c}, D={d}" for c, d in MULTI_TILE])
def test_multi_tile_grads_match_jax_fp32(case, d):
    tq, tk, kw = TILE_CASES[case]
    q, k, v = multi_tile_qkv(9, tq, tk, d)
    got = port_grads(q, k, v, **kw)
    want = jax_grads(q, k, v, block=max(tq, tk), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **FP32_TOL)


@pytest.mark.parametrize("case", ["window across tile edges",
                                  "Tq != Tk, suffix queries"])
def test_multi_tile_grads_match_jax_bf16(case):
    tq, tk, kw = TILE_CASES[case]
    q, k, v = multi_tile_qkv(11, tq, tk)
    got = port_grads(q, k, v, torch.bfloat16, **kw)
    want = jax_grads(q, k, v, jnp.bfloat16, block=max(tq, tk), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **BF16_TOL)


def test_multi_tile_grads_through_lse_match_jax():
    tq, tk, kw = TILE_CASES["window and offsets"]
    q, k, v = multi_tile_qkv(12, tq, tk)
    got = port_grads(q, k, v, with_lse=True, **kw)
    want = jax_grads(q, k, v, with_lse=True, block=max(tq, tk), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **FP32_TOL)


def test_gqa_grads_through_broadcast_kv_match_grouped_jax():
    q, k, v = qkv(4, heads=(4, 2, 2))

    def jax_loss(q, k, v):
        o = jax_local(q, k, v, causal=True)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    kb, vb = broadcast_kv(ts[1], ts[2], 2)
    o = flash_attention(ts[0], kb, vb, causal=True)
    got = torch.autograd.grad((o * o.cos()).sum(), ts)
    assert [g.shape for g in got] == [t.shape for t in ts]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FP32_TOL)


def test_fully_masked_rows_get_zero_dq():
    q, k, v = (torch.from_numpy(x) for x in qkv(5))
    o, lse = flash_attention(q, k, v, causal=True, k_offset=32,
                             return_lse=True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    dlse = torch.randn(lse.shape, generator=torch.Generator().manual_seed(1))
    dq, dk, dv = flash_attention_bwd_reference(
        q, k, v, o, lse, do, dlse, causal=True, k_offset=32)
    assert torch.all(dq[:, :32] == 0)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert torch.any(dq[:, 32:] != 0)


def test_cpu_backward_does_not_count_launches():
    before = (flash_attention.launches, flash_attention.dq_launches,
              flash_attention.dkv_launches)
    ts = [torch.from_numpy(x).requires_grad_() for x in qkv(6)]
    flash_attention(*ts, causal=True).sum().backward()
    assert (flash_attention.launches, flash_attention.dq_launches,
            flash_attention.dkv_launches) == before
    assert all(t.grad is not None for t in ts)
