"""The port's flash-attention forward and local attention against the JAX
package's (Pallas kernel in interpret mode, and the XLA oracle).

On the CPU the port's ``flash_attention`` runs its plain version, which
repeats the Hopper kernel's arithmetic; the kernel itself is held against
that plain version on the card in ``test_torch_cuda.py``.

Tolerances: fp32 inputs differ only in summation order and tile size
(the JAX kernel here sweeps 32-key blocks, or one block of the whole
length, the port 128-key tiles), so
``o`` agrees to 2e-5 (the JAX package's own flash-vs-oracle bound) and
``lse`` to 1e-5.  bf16 inputs also round ``p`` to bf16 relative to a
running max that depends on the tile size, and round ``o`` to bf16
(one ulp is 2^-8 ≈ 0.004 at magnitude 1): ``o`` agrees to 1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.pallas_attention import flash_attention as jax_flash
from chainermn_tpu.parallel.ring_attention import (
    broadcast_kv as jax_broadcast_kv,
    local_attention as jax_local,
)
from chainermn_tpu_torch.ops import (
    flash_attention,
    flash_attention_supported,
)
from chainermn_tpu_torch.parallel import broadcast_kv, local_attention

B, T, H, D = 2, 64, 2, 16
FP32_TOL = dict(rtol=2e-5, atol=2e-5)
LSE_TOL = dict(rtol=1e-5, atol=1e-5)


def qkv(seed=0, t=T, heads=(H, H, H), dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, t, h, D) * 0.5).astype(dtype) for h in heads]


def jax_run(q, k, v, dtype=jnp.float32, block=32, **kw):
    o, lse = jax_flash(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), block_q=block,
        block_k=block, interpret=True, return_lse=True, **kw)
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


def port_run(q, k, v, dtype=torch.float32, **kw):
    o, lse = flash_attention(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        return_lse=True, **kw)
    return o.float().numpy(), lse.numpy()


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
def test_flash_matches_jax_fp32(kw):
    q, k, v = qkv()
    o_ref, lse_ref = jax_run(q, k, v, **kw)
    o, lse = port_run(q, k, v, **kw)
    np.testing.assert_allclose(o, o_ref, **FP32_TOL)
    np.testing.assert_allclose(lse, lse_ref, **LSE_TOL)


def test_fully_masked_rows_are_zero():
    q, k, v = qkv(1)
    o, lse = port_run(q, k, v, causal=True, q_offset=0, k_offset=32)
    assert np.all(o[:, :32] == 0.0)
    assert np.all(lse[:, :32] <= -1e29)
    assert np.all(np.isfinite(o)) and np.all(np.isfinite(lse))
    # rows that do see keys are ordinary attention outputs
    assert np.all(lse[:, 32:] > -1e3)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=8)])
def test_flash_matches_jax_bf16(kw):
    q, k, v = qkv(2)
    o_ref, lse_ref = jax_run(q, k, v, jnp.bfloat16, **kw)
    o, lse = port_run(q, k, v, torch.bfloat16, **kw)
    np.testing.assert_allclose(o, o_ref, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(lse, lse_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 8)])
def test_local_attention_gqa_matches_jax(causal, window):
    q, k, v = qkv(3, heads=(4, 2, 2))
    ref = jax_local(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                    window=window)
    out = local_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32_TOL)


def test_flash_gqa_through_broadcast_kv():
    q, k, v = qkv(4, heads=(4, 2, 2))
    kb, vb = jax_broadcast_kv(jnp.asarray(k), jnp.asarray(v), 2)
    tk, tv = broadcast_kv(torch.from_numpy(k), torch.from_numpy(v), 2)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(kb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vb))
    o_ref, _ = jax_run(q, np.asarray(kb), np.asarray(vb), causal=True)
    o, _ = port_run(q, tk.numpy(), tv.numpy(), causal=True)
    np.testing.assert_allclose(o, o_ref, **FP32_TOL)
    # and the grouped oracle reads the shared heads in place
    grouped = local_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True)
    np.testing.assert_allclose(o, grouped.numpy(), **FP32_TOL)


def test_ragged_length_matches_local():
    # 72 keys: one ragged 128-key tile of the forward kernel
    q, k, v = qkv(5, t=72)
    for causal in (False, True):
        o, _ = port_run(q, k, v, causal=causal)
        ref = jax_local(*(jnp.asarray(x) for x in (q, k, v)),
                        causal=causal)
        np.testing.assert_allclose(o, np.asarray(ref), **FP32_TOL)


# Cases over several of the forward kernel's 128-key tiles: a ragged
# last tile, Tq != Tk, a window across tile edges, whole tiles masked.
# The JAX kernel runs them as one block per axis (its lengths must be
# multiples of 8), the XLA oracle on the rows that see a key.
TILE_CASES = {
    "ragged tail, causal": (288, 288, dict(causal=True)),
    "ragged tail, non-causal": (288, 288, dict(causal=False)),
    "Tq != Tk, suffix queries": (160, 288, dict(causal=True, q_offset=128)),
    "Tq != Tk, non-causal": (96, 288, dict(causal=False)),
    "window across tile edges": (288, 288, dict(causal=True, window=100)),
    "whole tiles masked": (288, 288,
                           dict(causal=True, q_offset=0, k_offset=160)),
    "window, whole tiles masked": (
        288, 288, dict(causal=True, window=40, q_offset=300, k_offset=0)),
}


def multi_tile_qkv(seed, tq, tk):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, tq, H, D) * 0.5).astype(np.float32)
    k, v = ((rng.randn(B, tk, H, D) * 0.5).astype(np.float32)
            for _ in range(2))
    return q, k, v


def seen_rows(tq, tk, causal=False, window=None, q_offset=0, k_offset=0):
    """Rows of the query block that see at least one key."""
    if not causal:
        return np.arange(tq)
    qpos = q_offset + np.arange(tq)
    newest = np.minimum(qpos - k_offset, tk - 1)
    oldest = 0 if window is None else np.maximum(qpos - window + 1 - k_offset,
                                                 0)
    return np.nonzero(newest >= oldest)[0]


@pytest.mark.parametrize("case", TILE_CASES)
def test_flash_multi_tile_matches_jax_fp32(case):
    tq, tk, kw = TILE_CASES[case]
    q, k, v = multi_tile_qkv(7, tq, tk)
    o_ref, lse_ref = jax_run(q, k, v, block=max(tq, tk), **kw)
    o, lse = port_run(q, k, v, **kw)
    np.testing.assert_allclose(o, o_ref, **FP32_TOL)
    np.testing.assert_allclose(lse, lse_ref, **LSE_TOL)
    rows = seen_rows(tq, tk, **kw)
    assert 0 < len(rows) <= tq
    oracle = np.asarray(jax_local(*(jnp.asarray(x) for x in (q, k, v)),
                                  **kw))
    np.testing.assert_allclose(o[:, rows], oracle[:, rows], **FP32_TOL)
    masked = np.setdiff1d(np.arange(tq), rows)
    assert np.all(o[:, masked] == 0.0) and np.all(lse[:, masked] <= -1e29)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 100)])
def test_flash_multi_tile_matches_jax_bf16(causal, window):
    q, k, v = multi_tile_qkv(8, 288, 288)
    kw = dict(causal=causal, window=window)
    o_ref, lse_ref = jax_run(q, k, v, jnp.bfloat16, block=288, **kw)
    o, lse = port_run(q, k, v, torch.bfloat16, **kw)
    np.testing.assert_allclose(o, o_ref, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(lse, lse_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=150),
                                dict(causal=True, q_offset=40, k_offset=0)])
def test_ragged_300_matches_local(kw):
    # T = 300: two full 128-key tiles and a 44-key tail, not a length the
    # JAX kernel takes (multiples of 8), so only the XLA oracle
    q, k, v = multi_tile_qkv(9, 300, 300)
    o, _ = port_run(q, k, v, **kw)
    ref = jax_local(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(o, np.asarray(ref), **FP32_TOL)


def test_supported_gate_and_raises():
    for d in (16, 32, 64, 128):
        assert flash_attention_supported(2048, 2048, d)
        assert flash_attention_supported(1, 77, d)
    for t_q, t_k, d in ((64, 64, 8), (64, 64, 96), (64, 64, 256),
                        (0, 64, 64), (64, 0, 64)):
        assert not flash_attention_supported(t_q, t_k, d)
    q = torch.zeros(1, 16, 2, 8)
    with pytest.raises(ValueError, match="unsupported"):
        flash_attention(q, q, q, causal=True)
    q = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="window requires causal"):
        flash_attention(q, q, q, window=4)
    with pytest.raises(ValueError, match="want"):
        flash_attention(q, q[:, :, :1], q[:, :, :1], causal=True)


def test_cpu_path_does_not_count_launches():
    before = flash_attention.launches
    q, k, v = (torch.from_numpy(x) for x in qkv(6))
    flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before

