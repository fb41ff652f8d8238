"""Flash attention: hand-written Hopper kernels, forward and backward,
and their plain PyTorch versions.

Counterpart of ``chainermn_tpu/ops/pallas_attention.py``: ``_fwd_kernel``
(``csrc/flash_fwd.cu``), ``_dq_kernel`` and ``_dkv_kernel``
(``csrc/flash_bwd.cu``), the ``_flash`` custom VJP (here a
``torch.autograd.Function``), ``flash_attention_supported`` and
``flash_attention``.  Each source's note gives its bound and design.
Tensors keep the JAX package's ``(B, T, H, D)`` layout at the public
function.

- A CUDA tensor launches the kernels, or raises: nothing falls back.
- A CPU tensor runs :func:`flash_attention_reference` forward and
  :func:`flash_attention_bwd_reference` backward, which repeat the
  kernels' arithmetic (the same tiles in the same order: 128-key tiles
  forward; backward, 128-key tiles for dq (64 at D=128) and 64-query
  tiles for dk/dv; fp32 statistics and accumulators,
  ``p`` and ``ds`` cast to the operand dtype before their products, the
  explicit zeroing of masked ``p`` and the ``1e-30`` floor), so a fully
  masked row gives ``o = 0``, ``lse ≈ -1e30`` and ``dq = 0`` on both.
- The backward saves ``q, k, v, o, lse`` and computes the row term
  ``delta = rowsum(do·o in fp32) − dlse`` with torch ops, as the JAX
  package computes it outside its kernels; ``lse`` is differentiable.
- The forward is the operator :func:`flash_fwd`
  (``torch.ops.chainermn_tpu_torch.flash_fwd``), so a dispatch mode
  sees it as one op: the transformer's ``remat_policy="dots"`` saves
  its outputs instead of launching it again in the recompute.
- ``flash_attention.launches``, ``.dq_launches`` and ``.dkv_launches``
  count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from chainermn_tpu_torch._build import load_library

__all__ = ["flash_attention", "flash_attention_bwd_reference",
           "flash_attention_reference", "flash_attention_supported",
           "flash_fwd"]

_NEG = -1e30
FWD_BLOCK_K = 128               # the forward kernel's K tile
BWD_BLOCK_Q = 64                # the dk/dv kernel's Q tile
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
    128-key tiles in the kernel's order (``p``'s rounding to v's dtype
    is relative to the running max, which moves once a tile).  Products
    take the operands' values with fp32 accumulation."""
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
    for j0 in range(0, Tk, FWD_BLOCK_K):
        kb, vb = kf[:, :, j0:j0 + FWD_BLOCK_K], vt[:, :, j0:j0 + FWD_BLOCK_K]
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


def flash_attention_bwd_reference(q, k, v, o, lse, do, dlse=None, *,
                                  causal: bool = False, window=None,
                                  q_offset: int = 0, k_offset: int = 0):
    """The plain backward: ``(dq, dk, dv)`` in q/k/v's dtypes from the
    forward's ``o`` and ``lse`` ``(B, Tq, H)`` and the cotangents ``do``
    (and ``dlse`` of ``lse``), computed as the two kernels compute them
    (:func:`_dq_reference`, :func:`_dkv_reference`)."""
    mask = dict(causal=causal, window=window, q_offset=q_offset,
                k_offset=k_offset)
    lse = lse.transpose(1, 2)                            # (B, H, Tq)
    delta = _delta(o, do, dlse)
    return (_dq_reference(q, k, v, do, lse, delta, **mask),
            *_dkv_reference(q, k, v, do, lse, delta, **mask))


def _p_ds(qf, kf, vf, dof, lse, delta, qs, ks, *, causal=False,
          window=None, q_offset=0, k_offset=0):
    """``p`` and ``ds`` of the query rows ``qs`` against the keys ``ks``
    (fp32 ``(B, H, Tq, D)`` operands, ``lse``/``delta`` ``(B, H, Tq)``)."""
    scale = qf.shape[-1] ** -0.5
    s = (qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2)) * scale
    p = torch.exp(s - lse[:, :, qs, None].float())
    if causal:
        qpos = q_offset + torch.arange(qf.shape[2], device=qf.device)
        kpos = k_offset + torch.arange(kf.shape[2], device=qf.device)
        rel = qpos[qs, None] - kpos[None, ks]
        allow = rel >= 0
        if window is not None:
            allow &= rel < window
        p = p.masked_fill(~allow, 0.0)
    dp = dof[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
    return p, p * (dp - delta[:, :, qs, None]) * scale


def _dq_block_k(D: int) -> int:
    """The dq kernel's K tile at head dim ``D``: 128 keys, 64 at D=128
    (where S, dP and dQ of 128 keys would not fit in its registers)."""
    return 128 if D <= 64 else 64


def _dq_reference(q, k, v, do, lse, delta, **mask):
    """The dq kernel's arithmetic: its K tiles in order, ``ds`` cast to
    k's dtype, fp32 accumulation.  ``lse``/``delta`` ``(B, H, Tq)``."""
    qf, kf, vf, dof = (x.transpose(1, 2).float() for x in (q, k, v, do))
    dq = torch.zeros_like(qf)
    block = _dq_block_k(q.shape[-1])
    for j0 in range(0, kf.shape[2], block):
        ks = slice(j0, j0 + block)
        _, ds = _p_ds(qf, kf, vf, dof, lse, delta, slice(None), ks, **mask)
        dq += ds.to(k.dtype).float() @ kf[:, :, ks]
    return dq.to(q.dtype).transpose(1, 2).contiguous()


def _dkv_reference(q, k, v, do, lse, delta, **mask):
    """The dk/dv kernel's arithmetic: 64-query tiles in order, ``p`` cast
    to do's dtype for dv and ``ds`` to q's for dk, fp32 accumulation."""
    qf, kf, vf, dof = (x.transpose(1, 2).float() for x in (q, k, v, do))
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i0 in range(0, qf.shape[2], BWD_BLOCK_Q):
        qs = slice(i0, i0 + BWD_BLOCK_Q)
        p, ds = _p_ds(qf, kf, vf, dof, lse, delta, qs, slice(None), **mask)
        dv += p.to(do.dtype).float().transpose(-1, -2) @ dof[:, :, qs]
        dk += ds.to(q.dtype).float().transpose(-1, -2) @ qf[:, :, qs]
    return (dk.to(k.dtype).transpose(1, 2).contiguous(),
            dv.to(v.dtype).transpose(1, 2).contiguous())


def _delta(o, do, dlse):
    """``rowsum(do·o)`` in fp32 from the saved (bf16) ``o``, minus
    ``dlse``, as fp32 ``(B, H, Tq)``: the row term of ``ds``."""
    d = (do.float() * o.float()).sum(dim=-1)             # (B, Tq, H)
    if dlse is not None:
        d = d - dlse.float()
    return d.transpose(1, 2).contiguous()


def _kernel(lib: str, name: str, n_ptrs: int, n_strides: int):
    """The C entry point ``name`` of ``csrc/<lib>.cu``: ``n_ptrs``
    pointers, six ints (B, H, Tq, Tk, D, dtype), ``n_strides`` int64
    strides, four ints (causal, window, offsets), the scale, the
    stream."""
    fn = getattr(load_library(lib), name)
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * n_ptrs + [i32] * 6 + [i64] * n_strides
                       + [i32] * 4 + [ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
    return fn


def _kernel_layout_ok(t) -> bool:
    # what a TMA tensor map describes: unit stride along D, the other
    # strides nonzero multiples of 16 bytes (dims of extent 1 excepted)
    strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    return t.stride(3) == 1 and all(s > 0 and s % 8 == 0 for s in strides) \
        and t.data_ptr() % 16 == 0


def _check_kernel_operand(name, t):
    if t.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"flash_attention kernel takes bfloat16 or float16, got {name} "
            f"{t.dtype}")
    if not _kernel_layout_ok(t):
        raise ValueError(
            f"flash_attention kernel needs {name} with unit stride along "
            "D, other strides nonzero multiples of 8 elements and a "
            f"16-byte aligned base; got strides {t.stride()}")


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def _launch(q, k, v, causal, window, q_offset, k_offset):
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
    fn = _kernel("flash_fwd", "flash_fwd", 5, 12)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, H, Tq, Tk, D, _KERNEL_DTYPES[q.dtype],
                 *_strides(q, k, v, o), int(causal), window or 0, q_offset,
                 k_offset, D ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return o, lse


def _bwd_operands(q, o, lse, do, dlse):
    """The backward kernels' extra operands: ``do`` in a layout they read,
    ``lse`` and ``delta`` as fp32 ``(B, H, Tq)``."""
    if do.dtype != q.dtype:
        raise TypeError(f"do is {do.dtype}, the forward ran in {q.dtype}")
    if not _kernel_layout_ok(do):
        do = do.contiguous()        # a layout the kernels read; same values
    return do, lse.transpose(1, 2).contiguous(), _delta(o, do, dlse)


def _launch_dq(q, k, v, do, lse, delta, causal, window, q_offset,
               k_offset):
    """The dq kernel; ``lse``/``delta`` fp32 ``(B, H, Tq)`` contiguous."""
    B, Tq, H, D = q.shape
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    fn = _kernel("flash_bwd", "flash_bwd_dq", 7, 15)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Tq,
                 k.shape[1], D, _KERNEL_DTYPES[q.dtype],
                 *_strides(q, k, v, do, dq), int(causal), window or 0,
                 q_offset, k_offset, D ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash_bwd_dq launch failed: cudaError_t {err}")
    flash_attention.dq_launches += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal, window, q_offset,
                k_offset):
    """The dk/dv kernel; operands as for :func:`_launch_dq`."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    dk = torch.empty((B, Tk, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Tk, H, D), dtype=v.dtype, device=q.device)
    fn = _kernel("flash_bwd", "flash_bwd_dkv", 8, 18)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, H, Tq, Tk, D, _KERNEL_DTYPES[q.dtype],
                 *_strides(q, k, v, do, dk, dv), int(causal), window or 0,
                 q_offset, k_offset, D ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash_bwd_dkv launch failed: cudaError_t {err}")
    flash_attention.dkv_launches += 1
    return dk, dv


@torch.library.custom_op("chainermn_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, q_offset: int,
              k_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as one operator, ``(o, lse)`` with ``lse`` ``(B, H,
    Tq)``: the kernel on CUDA tensors, its plain version on CPU ones
    (``window`` 0 means none).  Being an operator of its own, it is one
    op to a dispatch mode, so a selective-checkpoint policy can save its
    outputs and the recompute then reuses them instead of launching the
    kernel again (the transformer's ``remat_policy="dots"``)."""
    win = window or None
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, win, q_offset, k_offset)
    o, lse = flash_attention_reference(
        q, k, v, causal=causal, window=win, q_offset=q_offset,
        k_offset=k_offset)
    return o, lse.transpose(1, 2).contiguous()


class _Flash(torch.autograd.Function):
    """``(o, lse)`` with the JAX package's VJP: the forward kernel, then
    the dq and dk/dv kernels off the saved ``lse`` (CUDA), or the plain
    versions of both (CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, k_offset):
        o, lse = flash_fwd(q, k, v, causal, window or 0, q_offset,
                           k_offset)
        lse = lse.transpose(1, 2)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, q_offset, k_offset)
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, q_offset, k_offset = ctx.mask
        if q.device.type == "cuda":
            do, lse, delta = _bwd_operands(q, o, lse, do, dlse)
            dq = _launch_dq(q, k, v, do, lse, delta, *ctx.mask)
            dk, dv = _launch_dkv(q, k, v, do, lse, delta, *ctx.mask)
        else:
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, o, lse, do, dlse, causal=causal, window=window,
                q_offset=q_offset, k_offset=k_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, window=None,
                    q_offset: int = 0, k_offset: int = 0,
                    return_lse: bool = False):
    """Flash attention over ``(B, T, H, D)`` tensors, masking in global
    positions ``q_offset + i`` / ``k_offset + j``.  ``window`` (needs
    ``causal``): token t attends to ``(t - window, t]``.  A query row
    whose whole K range is masked returns zeros and ``lse ≈ -1e30``.
    With ``return_lse=True`` returns ``(o, lse)``, ``lse`` ``(B, Tq, H)``
    fp32; both outputs are differentiable.  K/V must already be at query
    width (see ``broadcast_kv``)."""
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
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(
            f"flash_attention runs on cuda or cpu, not {q.device}")
    o, lse = _Flash.apply(q, k, v, causal, window, int(q_offset),
                          int(k_offset))
    return (o, lse) if return_lse else o


flash_attention.launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0
