"""The hand-written Hopper kernels against their plain PyTorch versions,
on the card.  Every test here needs CUDA and skips without it.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX; skip the repository's JAX conftest there:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances (bf16/fp16 kernel against the plain version on the same
inputs and the same 64-key tiles): ``o`` to 1e-2 absolute and relative,
for the final rounding of ``o`` (one ulp is 2^-8 relative) and rare
one-ulp flips of ``p`` where the fp32 sums differ in order; ``lse`` is
fp32 throughout and agrees to 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.models import (
    TransformerConfig,
    init_numpy_params,
    make_forward_fn,
    params_from_jax,
)
from chainermn_tpu_torch.models.transformer import _lm_head
from chainermn_tpu_torch.ops import flash_attention, flash_attention_reference


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
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=1e-2,
                               atol=1e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
    if kw.get("k_offset", 0) == 100:
        rows = min(t, 100)
        assert torch.all(o[:, :rows] == 0)
        assert torch.all(lse[:, :rows] <= -1e29)


def test_cuda_kernel_reads_strided_views(cuda):
    # q/k/v as views into one fused projection, as the transformer has them
    g = torch.Generator(device="cpu").manual_seed(0)
    qkv = torch.randn(2, 96, 3, 4, 64, generator=g).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o = flash_attention(q, k, v, causal=True)
    o_ref, _ = flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=1e-2,
                               atol=1e-2)


def test_cuda_wrapper_refuses(cuda):
    q = torch.zeros(1, 64, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        flash_attention(q, q, q, causal=True)
    q = q.to(torch.bfloat16).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward kernel"):
        flash_attention(q, q, q, causal=True)
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
