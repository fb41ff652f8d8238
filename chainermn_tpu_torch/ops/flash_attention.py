"""Flash-attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of the forward half of ``chainermn_tpu/ops/pallas_attention.py``
(``_fwd_kernel``, ``_fwd``, ``flash_attention_supported``,
``flash_attention``).  The kernel is ``csrc/flash_fwd.cu``; its source
note gives the bound and the design.  Tensors keep the JAX package's
``(B, T, H, D)`` layout at the public function.

- A CUDA tensor launches the kernel, or raises: nothing falls back.
- A CPU tensor runs :func:`flash_attention_reference`, which repeats the
  kernel's arithmetic (the same 64-key tiles, fp32 statistics, ``p``
  cast to V's dtype before the PV product, the explicit zeroing of
  masked ``p`` and the ``1e-30`` floor), so a fully masked row gives
  ``o = 0`` and ``lse ≈ -1e30`` on both.
- ``flash_attention.launches`` counts kernel launches.

The backward kernels (the TPU ``_dq_kernel`` and ``_dkv_kernel``) are
not ported yet: on CUDA the wrapper refuses inputs that need a gradient.
"""

from __future__ import annotations

import ctypes

import torch

from chainermn_tpu_torch._build import load_library

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_supported"]

_NEG = -1e30
BLOCK_K = 64                    # the kernel's K tile (kBlockK)
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
_INT32_MAX = 2 ** 31 - 1


def flash_attention_supported(T_q: int, T_k: int, D: int) -> bool:
    """Shapes the Hopper kernel takes: any lengths >= 1 (the last tile is
    masked) and a head dim of 16, 32, 64 or 128 (whole 16-wide k-slices
    of the tensor-core product, at most 128 so a tile's accumulator fits
    in registers).  Callers fall back to ``local_attention`` otherwise."""
    return T_q >= 1 and T_k >= 1 and D in SUPPORTED_HEAD_DIMS


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              window=None, q_offset: int = 0,
                              k_offset: int = 0):
    """The plain version: ``(o, lse)`` with ``o`` ``(B, Tq, H, D)`` in
    q's dtype and ``lse`` ``(B, Tq, H)`` fp32, computed over the kernel's
    64-key tiles in the kernel's order.  Products take the operands'
    values with fp32 accumulation."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = D ** -0.5
    qf = q.transpose(1, 2).float()                       # (B, H, Tq, D)
    kf = k.transpose(1, 2).float()
    vt = v.transpose(1, 2)
    qpos = q_offset + torch.arange(Tq, device=q.device)
    m = torch.full((B, H, Tq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    for j0 in range(0, Tk, BLOCK_K):
        kb, vb = kf[:, :, j0:j0 + BLOCK_K], vt[:, :, j0:j0 + BLOCK_K]
        s = (qf @ kb.transpose(-1, -2)) * scale
        allow = None
        if causal:
            kpos = k_offset + torch.arange(j0, j0 + kb.shape[2],
                                           device=q.device)
            allow = qpos[:, None] >= kpos[None, :]
            if window is not None:
                allow &= (qpos[:, None] - kpos[None, :]) < window
            s = s.masked_fill(~allow, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if allow is not None:
            p = p.masked_fill(~allow, 0.0)
        acc = acc * alpha[..., None] + p.to(v.dtype).float() @ vb.float()
        l = l * alpha + p.sum(dim=-1)
        m = m_new
    safe = l.clamp_min(1e-30)
    o = (acc / safe[..., None]).to(q.dtype).transpose(1, 2)
    return o, (m + torch.log(safe)).transpose(1, 2)


def _kernel():
    fn = load_library("flash_fwd").flash_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 5 + [i32] * 6 + [i64] * 12 + [i32] * 4
                       + [ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_operand(name, t):
    if t.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"flash_attention kernel takes bfloat16 or float16, got {name} "
            f"{t.dtype}")
    strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    if t.stride(3) != 1 or any(s % 8 for s in strides) \
            or t.data_ptr() % 16:
        raise ValueError(
            f"flash_attention kernel needs {name} with unit stride along "
            "D, other strides multiples of 8 elements and a 16-byte "
            f"aligned base; got strides {t.stride()}")


def _launch(q, k, v, causal, window, q_offset, k_offset):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward kernel yet (the training "
            "slice ports _dq_kernel/_dkv_kernel); call it under "
            "torch.inference_mode() or on tensors that need no gradient")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, t)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(
            f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if max(abs(q_offset) + Tq, abs(k_offset) + Tk) > _INT32_MAX:
        raise ValueError("positions must fit in int32")
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, H, Tq, Tk, D, _KERNEL_DTYPES[q.dtype],
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], int(causal), window or 0, q_offset,
                 k_offset, D ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return o, lse.transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = False, window=None,
                    q_offset: int = 0, k_offset: int = 0,
                    return_lse: bool = False):
    """Flash attention over ``(B, T, H, D)`` tensors, masking in global
    positions ``q_offset + i`` / ``k_offset + j``.  ``window`` (needs
    ``causal``): token t attends to ``(t - window, t]``.  A query row
    whose whole K range is masked returns zeros and ``lse ≈ -1e30``.
    With ``return_lse=True`` returns ``(o, lse)``, ``lse`` ``(B, Tq, H)``
    fp32.  K/V must already be at query width (see ``broadcast_kv``)."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding causal "
                         "window attention)")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
            "want (B, Tq, H, D) and two (B, Tk, H, D)")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if not flash_attention_supported(Tq, Tk, D):
        raise ValueError(
            f"shape (Tq={Tq}, Tk={Tk}, D={D}) unsupported: lengths must "
            f"be >= 1 and D one of {SUPPORTED_HEAD_DIMS} — gate on "
            "flash_attention_supported() and fall back to local_attention")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q/k/v on different devices: {devices}")
    device = q.device
    if device.type == "cuda":
        o, lse = _launch(q, k, v, causal, window, int(q_offset),
                         int(k_offset))
    elif device.type == "cpu":
        o, lse = flash_attention_reference(
            q, k, v, causal=causal, window=window, q_offset=int(q_offset),
            k_offset=int(k_offset))
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, not {device}")
    return (o, lse) if return_lse else o


flash_attention.launches = 0
