#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``chainermn_tpu_torch``) on one NVIDIA
H100: the quickest proof that the port still starts on the card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. build every kernel under ``chainermn_tpu_torch/csrc`` with ``nvcc``;
2. hold the forward kernel against its plain PyTorch version on the
   card, at the flagship's shape and at every other head dim and in
   fp16 (every swizzle mode and wgmma descriptor), and time kernel,
   plain version and a library yardstick;
3. scoring at full width: the flagship GQA transformer (24 layers,
   d_model 1024, 16 query / 4 KV heads, vocab 32000) on 8 x 2048 tokens
   in bf16 through ``make_forward_fn``, every layer through the flash
   kernel, checked against an fp32 forward with plain attention;
4. answering requests: greedy ``make_generate_fn`` on 8 prompts of 128
   tokens, 64 new tokens, with ``eos_id`` set, its decode logits checked
   against the full forward on the generated sequence;
5. the backward kernels (dq; dk/dv) against their plain version on the
   card, on the forward's cases and a grouped-K/V case at the training
   shape and at every other head dim and in fp16, and on cases of
   several of their tiles and tile classes (Tq != Tk, ragged ends,
   windows across tile edges, offsets) at every head dim in both dtypes;
   two runs must give the same bits; timed at the training shape beside
   SDPA's backward;
6. training at full width: ``make_train_step`` with ``adamw(3e-4)`` on
   one batch of 8 x 2048 tokens (``bench_transformer.py``'s), remat on,
   one warm-up and five timed steps, every layer's forward, recompute
   and backward through the kernels, its first loss checked against the
   forward's cross-entropy and its gradients against an fp32
   plain-attention step;
7. ChainerMN's data-parallel path at the JAX package's headline config
   (``bench.py``): ResNet-50 with synchronised BN, 224 px, global batch
   256, bf16, ``sgd(0.1, momentum=0.9)`` and a bf16 gradient wire, through
   ``examples/imagenet/train_imagenet_torch.py``'s ``build`` (the
   example's ``init_distributed`` → ``create_communicator`` → lazy
   synthetic images → ``scatter_dataset`` → ``SerialIterator`` →
   ``create_multi_node_optimizer`` → ``StandardUpdater`` → ``Trainer``
   with the multi-node evaluator and ``LogReport``) in a one-rank NCCL
   world: a few iterations, then the step timed on a fixed batch on the
   card and through the host data path, the gradient exchange alone,
   and its checks (the exchange equals ``bf16(g)`` bitwise, its
   all-reduces within the fused budget, the BN statistics moved, fp32
   logits against the CPU forward, bf16 gradients against fp32);
8. the MNIST example (``examples/mnist/train_mnist_torch.py``) for one
   epoch in the same world, its validation accuracy above a floor.

Phases 3 and 6 are the main paths of the kernels: each starts with
every launch count at 0 and reads the counts when it ends; phases 7
and 8 run no hand-written kernel, and hold their counts at 0.  It
prints the card's name and power limit, a ``{"dp_resnet50": {...}}``
line of phase 7's metrics, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Weights are random, from numpy seed 0.  fp32
references run with TF32 off.
"""

import dataclasses
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
# bench.py:34: a ResNet-50 training step on one 224 px image
RESNET50_TRAIN_FLOPS = 3 * 2 * 4.089e9
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 rate
SEED = 0
# the flagship GQA config of bench_transformer.py:29,45-49, full width
# and depth
FLAGSHIP = dict(vocab_size=32000, d_model=1024, n_heads=16, n_kv_heads=4,
                d_head=64, d_ff=4096, n_layers=24, max_seq=2048,
                attention="flash", pos_embedding="learned",
                dtype="bfloat16")


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps=20, runs=5, warmup=3):
    """Milliseconds of one ``fn()`` on the card: ``reps`` calls enqueued
    back to back between two CUDA events, one synchronise, the elapsed
    time over ``reps``; the median of ``runs`` such runs.  The host's
    time to enqueue a call hides behind the card's work on the previous
    one, as it does on the main path."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def allowed_pairs(Tq, Tk, causal, window, q_off, k_off):
    """(query, key) pairs the mask lets through for one (batch, head)."""
    import numpy as np

    if not causal:
        return Tq * Tk
    rel = q_off + np.arange(Tq) - k_off          # newest key each row sees
    hi = np.minimum(rel, Tk - 1)
    lo = np.zeros_like(rel) if window is None else np.maximum(
        rel - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def bound_ms(flops, nbytes):
    """Least time for ``flops`` bf16 tensor-core operations and ``nbytes``
    of memory traffic: (ms, "operations" or "bytes", whichever binds)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes \
        else "bytes"


def flash_bound_ms(B, H, Tq, Tk, D, causal, window, q_off, k_off):
    """Least time for the call: tensor-core FLOPs of QK^T and PV over the
    allowed pairs, or the bytes of q, k, v, o (bf16) and lse (fp32)."""
    flops = 4 * B * H * D * allowed_pairs(Tq, Tk, causal, window, q_off,
                                          k_off)
    return bound_ms(flops, 2 * B * H * D * (2 * Tq + 2 * Tk) + 4 * B * H * Tq)


def phase_kernel(torch, fa):
    """The forward kernel against its plain version: five mask cases at
    the flagship's shape (B=8, H=16, D=64, bf16), then the same cases at
    D = 16, 32, 64 and 128 in bf16 and fp16 (B=2), so every swizzle mode
    and wgmma descriptor is held; returns the JSON fields of the row."""
    from chainermn_tpu_torch.ops import flash_attention_reference

    cases = [
        ("smoke causal", 2048, dict(causal=True)),
        ("non-causal", 2048, dict(causal=False)),
        ("window 256", 2048, dict(causal=True, window=256)),
        ("k_offset > q_offset", 2048,
         dict(causal=True, q_offset=0, k_offset=1024)),
        ("ragged T=2000", 2000, dict(causal=True)),
    ]
    bf16, fp16 = torch.bfloat16, torch.float16
    variants = [(8, 64, bf16)] + [
        (2, d, dt) for d in (16, 32, 64, 128) for dt in (bf16, fp16)
        if (d, dt) != (64, bf16)]
    H = 16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = worst_rel = 0.0
    row = None
    for B, D, dtype in variants:
        readings = []
        for name, T, kw in cases:
            q, k, v = (torch.randn(B, T, H, D, device="cuda", generator=gen,
                                   dtype=dtype) for _ in range(3))
            o, lse = fa(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            o_ref, lse_ref = flash_attention_reference(q, k, v, **kw)
            fault, err, rel, n_off = bar_fault(torch, o, o_ref, O_BAR)
            require(fault is None, f"{name} D={D} {dtype}: o: {fault}")
            err_lse = (lse - lse_ref).abs().max().item()
            torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
            require(bool(torch.isfinite(o.float()).all()),
                    f"{name}: o not finite")
            if kw.get("k_offset", 0) > kw.get("q_offset", 0):
                masked = kw["k_offset"] - kw.get("q_offset", 0)
                require(bool((o[:, :masked] == 0).all()),
                        f"{name}: fully masked rows are not zero")
                require(bool((lse[:, :masked] <= -1e29).all()),
                        f"{name}: fully masked rows' lse above -1e29")
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
            readings.append(f"{name}: max abs {err:.3e} rel L2 {rel:.3e} "
                            f"outside the band {n_off} lse {err_lse:.3e}")
            if row is None:   # the smoke shape: check the bar, time
                print("kernel flash_fwd [smoke causal] the bar fails o with "
                      "faults, relative L2: " + " ".join(
                          f"{f} {r:.3e}" for f, r in
                          bar_rejects_faults(torch, "o", o, o_ref,
                                             O_BAR).items()))
                row = time_forward(torch, fa, q, k, v, kw)
        print(f"kernel flash_fwd B={B} H={H} D={D} {str(dtype)[6:]} against "
              "the plain version: " + "; ".join(readings))
    row["max_abs_err"] = worst
    row["max_rel_l2"] = worst_rel
    return row


def time_forward(torch, fa, q, k, v, kw):
    from chainermn_tpu_torch.ops import flash_attention_reference

    B, T, H, D = q.shape
    ms = cuda_ms(lambda: fa(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, **kw),
                       reps=3, runs=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    bound, by = flash_bound_ms(B, H, T, T, D, True, None, 0, 0)
    print(f"kernel flash_fwd timing at B={B} H={H} T={T} D={D} causal "
          f"bf16: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms(sdpa)={library_ms:.4f} ({ms / library_ms:.2f}x) "
          f"bound={bound * 1e3:.1f} us ({by}) -> {bound / ms:.1%} of bound")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms)


def bwd_bound_ms(B, H, Tq, Tk, D, causal, window, q_off, k_off, dkv):
    """Least time of one backward kernel: its products over the allowed
    pairs (dq: QK^T, dO.V^T, dS.K; dk/dv: those two, P^T.dO, dS^T.Q), or
    the bytes it must move: q, k, v, do read and its outputs written
    (bf16), lse and delta read (fp32)."""
    pairs = allowed_pairs(Tq, Tk, causal, window, q_off, k_off)
    flops = (4 if dkv else 3) * 2 * B * H * D * pairs
    nbytes = 2 * B * H * D * (2 * Tq + 2 * Tk) + 8 * B * H * Tq \
        + 2 * B * H * D * (2 * Tk if dkv else Tq)
    return bound_ms(flops, nbytes)


@dataclasses.dataclass(frozen=True)
class Bar:
    """What a kernel's output must meet against its plain version: each
    element within ``rtol`` relative plus ``atol_rms`` of the reference's
    RMS absolute, at most ``off_share`` of the elements outside that band
    and none beyond ``off_tol`` absolute plus relative, and ``rel_l2``
    relative L2 over the tensor."""
    rtol: float
    atol_rms: float
    rel_l2: float
    off_share: float = 4e-6
    off_tol: float = 2e-2


# The kernels and their plain versions share tiles, order and the
# roundings of p (and ds) to the operand dtype; they differ by rare
# one-ulp flips where an fp32 exp or sum rounds the other way, and by the
# final rounding of the output.  rtol covers a flip of a large element.
# atol is a share of the tensor's RMS, so that small elements are held as
# well: late keys of dk and dv are ~0.01, and late causal rows of o
# ~1/sqrt(row), 0.02-0.05.  A flip of one large p or ds (one ulp is 2^-8
# of it) moves a gradient element by up to 2^-8 |p do|, which may exceed
# that band where the element's sum cancels (more often in a GQA sum of
# four copies): four millionths of the elements (67 of the 16.8 M at the
# training shape, 16 of a GQA sum's 4.2 M) may leave the band, and they
# stay within 2e-2 absolute plus relative.  The relative L2 bar catches a
# fault spread thinly over many elements.  ``bar_rejects_faults`` shows
# on the run's own outputs that the bar fails three such faults.
GRAD_BAR = Bar(rtol=2e-2, atol_rms=2e-2, rel_l2=2e-3)
O_BAR = Bar(rtol=1e-2, atol_rms=2e-2, rel_l2=1e-3)


def bar_fault(torch, got, want, bar):
    """What keeps ``got`` from meeting ``bar`` against the plain
    version's ``want`` (None if nothing), its max abs error, its relative
    L2 error and the count of elements outside the band."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    atol = bar.atol_rms * want.pow(2).mean().sqrt().item()
    n_off = int((err > atol + bar.rtol * want.abs()).sum())
    far = int((err > bar.off_tol * (1 + want.abs())).sum())
    rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    fault = None
    if not bool(torch.isfinite(got).all()):
        fault = "not finite"
    elif n_off > bar.off_share * got.numel() or far:
        fault = (f"{n_off} elements off by more than {bar.rtol} relative "
                 f"+ {atol:.3e}, {far} by more than {bar.off_tol} "
                 "absolute + relative")
    elif rel > bar.rel_l2:
        fault = f"relative L2 {rel:.3e} above {bar.rel_l2}"
    return fault, err.max().item(), rel, n_off


def bar_rejects_faults(torch, label, got, want, bar):
    """The bar must fail a result with a fault spread thinly: every
    element one ulp off, the elements under 0.02 zeroed, or 1e-2 added
    to the last 64 positions (one tile).  Returns the faults' relative
    L2 errors."""
    last_tile = got.clone()
    last_tile[:, -64:] += 1e-2
    faults = dict(
        ulp=(got.view(torch.int16) + 1).view(got.dtype),
        small_zeroed=torch.where(got.float().abs() < 0.02,
                                 torch.zeros_like(got), got),
        last_tile=last_tile)
    rels = {}
    for fault, bad in faults.items():
        verdict, _, rels[fault], _ = bar_fault(torch, bad, want, bar)
        require(verdict is not None,
                f"{label} with fault {fault} passes the bar")
    return rels


# (Tq, Tk, mask) cases of several of the backward kernels' tiles (dq: 128
# query rows against 128 keys, 64 at D=128; dk/dv: 128 keys against 64
# queries) and of their tile classes (skipped, interior, edge).  They run
# with a random cotangent of lse as well: without one, a row whose
# softmax has one key (T=1) has dq = 0 up to rounding, and the kernels'
# and the plain version's roundings would be compared.
BWD_TILE_CASES = {
    "T=1": (1, 1, dict(causal=True)),
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


def backward_case(torch, fa, name, B, Tq, Tk, H, Hkv, D, dtype, kw, gen,
                  with_dlse=False):
    """One backward through the kernels (autograd) against the plain
    version on the kernels' own forward outputs, under ``GRAD_BAR``, with
    a random cotangent of ``lse`` too if ``with_dlse``; returns
    (readings, worst abs, worst rel L2, the operands and the kernels' and
    plain version's dq, dk, dv)."""
    from chainermn_tpu_torch.ops import flash_attention_bwd_reference
    from chainermn_tpu_torch.parallel import broadcast_kv

    q = torch.randn(B, Tq, H, D, device="cuda", generator=gen, dtype=dtype)
    k, v = (torch.randn(B, Tk, Hkv, D, device="cuda", generator=gen,
                        dtype=dtype) for _ in range(2))
    do = torch.randn(B, Tq, H, D, device="cuda", generator=gen, dtype=dtype)
    dlse = torch.randn(B, Tq, H, device="cuda", generator=gen) \
        if with_dlse else None
    ts = [x.requires_grad_() for x in (q, k, v)]
    kb, vb = broadcast_kv(ts[1], ts[2], H // Hkv)
    o, lse = fa(ts[0], kb, vb, return_lse=True, **kw)
    # the kernels' own outputs (dk, dv per broadcast copy) and, for
    # GQA, the KV heads' gradients autograd sums from them
    got = torch.autograd.grad(
        (o, lse) if with_dlse else o,
        [ts[0], kb, vb] + (ts[1:] if Hkv != H else []),
        (do, dlse) if with_dlse else do)
    torch.cuda.synchronize()
    kb, vb, o, lse = (x.detach() for x in (kb, vb, o, lse))
    want = list(flash_attention_bwd_reference(q.detach(), kb, vb, o, lse,
                                              do, dlse, **kw))
    checks = list(zip(("dq", "dk", "dv"), got, want))
    if Hkv != H:   # the KV heads' sums, by the same autograd of
        # broadcast_kv on the plain version's copies
        k2, v2 = (x.detach().requires_grad_() for x in ts[1:])
        sums = torch.autograd.grad(broadcast_kv(k2, v2, H // Hkv),
                                   (k2, v2), want[1:])
        checks += zip(("dk(KV heads)", "dv(KV heads)"), got[3:], sums)
    readings, worst, worst_rel = [], 0.0, 0.0
    for label, a, b in checks:
        fault, err, rel, n_off = bar_fault(torch, a, b, GRAD_BAR)
        require(fault is None,
                f"{name} D={D} {dtype}: {label}: {fault}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        rms = b.float().pow(2).mean().sqrt().item()
        readings.append(f"{label} max abs {err:.3e} rel L2 {rel:.3e} "
                        f"outside the band {n_off} (rms {rms:.3e})")
    masked = kw.get("k_offset", 0) - kw.get("q_offset", 0)
    if masked > 0:
        require(bool((got[0][:, :masked] == 0).all()),
                f"{name} D={D} {dtype}: dq of fully masked rows is not "
                "zero")
    return (readings, worst, worst_rel, (q.detach(), kb, vb, o, lse, do),
            got[:3], want)


def phase_backward(torch, fa):
    """Backward kernels against their plain version: the mask cases at
    the training shape (B=8, H=16, D=64, bf16), then at D = 16, 32, 64
    and 128 in bf16 and fp16 (B=2), and the tile cases at every D in
    both dtypes; two runs give the same bits; returns the JSON fields of
    the dq and dk/dv rows."""
    # the wrapper module (the package exports its function of that name)
    ops = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    cases = [
        ("smoke causal", 2048, 16, dict(causal=True)),
        ("non-causal", 2048, 16, dict(causal=False)),
        ("window 256", 2048, 16, dict(causal=True, window=256)),
        ("k_offset > q_offset", 2048, 16,
         dict(causal=True, q_offset=0, k_offset=1024)),
        ("ragged T=2000", 2000, 16, dict(causal=True)),
        ("GQA 4 KV heads via broadcast_kv", 2048, 4, dict(causal=True)),
    ]
    bf16, fp16 = torch.bfloat16, torch.float16
    variants = [(8, 64, bf16)] + [
        (2, d, dt) for d in (16, 32, 64, 128) for dt in (bf16, fp16)
        if (d, dt) != (64, bf16)]
    H = 16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = worst_rel = 0.0
    rows = None
    for B, D, dtype in variants:
        for name, T, Hkv, kw in cases:
            readings, err, rel, operands, got, want = backward_case(
                torch, fa, name, B, T, T, H, Hkv, D, dtype, kw, gen)
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
            print(f"kernel flash_bwd [{name}] B={B} T={T} H={H} Hkv={Hkv} "
                  f"D={D} {str(dtype)[6:]} against the plain version: "
                  + "; ".join(readings))
            if rows is None:   # the training shape: check the bar, time
                for label, a, b in zip(("dq", "dk", "dv"), got, want):
                    print(f"kernel flash_bwd [{name}] the bar fails {label} "
                          "with faults, relative L2: " + " ".join(
                              f"{f} {r:.3e}" for f, r in
                              bar_rejects_faults(torch, label, a, b,
                                                 GRAD_BAR).items()))
                require(backward_is_deterministic(torch, fa, operands, kw),
                        f"{name}: two backward runs differ")
                print(f"kernel flash_bwd [{name}] two runs give the same "
                      "dq, dk and dv bits")
                rows = time_backward(torch, ops, *operands, kw)
    for D in (16, 32, 64, 128):
        for dtype in (bf16, fp16):
            readings = []
            for name, (tq, tk, kw) in BWD_TILE_CASES.items():
                _, err, rel, *_ = backward_case(
                    torch, fa, name, 2, tq, tk, 3, 3, D, dtype, kw, gen,
                    with_dlse=True)
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
                readings.append(f"{name}: max abs {err:.3e} rel L2 "
                                f"{rel:.3e}")
            print(f"kernel flash_bwd tile cases B=2 H=3 D={D} "
                  f"{str(dtype)[6:]}, worst of dq, dk, dv against the "
                  "plain version: " + "; ".join(readings))
    for row in rows.values():
        row["max_abs_err"] = worst
        row["max_rel_l2"] = worst_rel
    return rows


def backward_is_deterministic(torch, fa, operands, kw):
    """Two backward runs through the kernels on the same inputs give
    bitwise-equal dq, dk and dv."""
    q, k, v, _, _, do = operands
    runs = []
    for _ in range(2):
        ts = [x.detach().requires_grad_() for x in (q, k, v)]
        runs.append(torch.autograd.grad(fa(*ts, **kw), ts, do))
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(*runs))


def time_backward(torch, ops, q, k, v, o, lse, do, kw):
    B, T, H, D = q.shape
    mask = (kw["causal"], None, 0, 0)
    dlse = torch.zeros_like(lse)
    do_, lse_, delta = ops._bwd_operands(q, o, lse, do, dlse)
    delta_ms = cuda_ms(lambda: ops._bwd_operands(q, o, lse, do, dlse))
    ms = dict(dq=cuda_ms(lambda: ops._launch_dq(q, k, v, do_, lse_, delta,
                                                 *mask)),
              dkv=cuda_ms(lambda: ops._launch_dkv(q, k, v, do_, lse_, delta,
                                                   *mask)))
    plain = dict(dq=cuda_ms(lambda: ops._dq_reference(
                     q, k, v, do_, lse_, delta, causal=True), reps=5),
                 dkv=cuda_ms(lambda: ops._dkv_reference(
                     q, k, v, do_, lse_, delta, causal=True), reps=5))
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True))
    total = delta_ms + ms["dq"] + ms["dkv"]
    rows = {}
    for name in ("dq", "dkv"):
        bound, by = bwd_bound_ms(B, H, T, T, D, True, None, 0, 0,
                                 name == "dkv")
        # SDPA's backward computes dq, dk and dv in one call: its time
        # stands against the port's delta op and both kernels together
        rows[name] = dict(ms=ms[name], plain_ms=plain[name], bound_ms=bound,
                          bound_by=by, library_ms=library_ms,
                          library_covers=["delta", "dq", "dkv"],
                          port_ms_total=total)
        print(f"kernel flash_bwd_{name} timing at B={B} H={H} T={T} D={D} "
              f"causal bf16: kernel_ms={ms[name]:.4f} plain_ms="
              f"{plain[name]:.4f} bound={bound * 1e3:.1f} us ({by}) -> "
              f"{bound / ms[name]:.1%} of bound")
    least = 5 * 2 * B * H * D * allowed_pairs(T, T, True, None, 0, 0) \
        / PEAK_BF16_FLOPS * 1e3
    print(f"backward at B={B} H={H} T={T} D={D} causal bf16: delta op "
          f"{delta_ms:.4f} ms + dq + dk/dv = {total:.4f} ms; "
          f"library_ms(sdpa backward)={library_ms:.4f} "
          f"({total / library_ms:.2f}x); least work of the whole backward "
          f"(5 products) {least * 1e3:.1f} us")
    return rows


def rel_err(a, b):
    return ((a - b).norm() / b.norm()).item()


def phase_training(torch, np, cfg, params, forward):
    """Training at full width; returns the launch counts of the run."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        make_train_step,
        make_value_and_grad_fn,
    )
    from chainermn_tpu_torch.ops import flash_attention as fa

    B, T = 8, 2048
    toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size,
                                               (B, T + 1))
    x = torch.as_tensor(toks[:, :T], device="cuda")
    y = torch.as_tensor(toks[:, 1:], device="cuda")
    with torch.inference_mode():
        ce = torch.nn.functional.cross_entropy(
            forward(params, x).reshape(-1, cfg.vocab_size),
            y.reshape(-1)).item()

    # gradients of rows 0-1: bf16 flash and bf16 plain attention against
    # fp32 plain attention
    def grads(**kw):
        fn = make_value_and_grad_fn(dataclasses.replace(cfg, **kw))
        return fn(params, x[:2], y[:2])[1]

    g32 = grads(dtype="float32", attention="local")
    g16 = grads()
    errs = {f"blocks/{n}": rel_err(g, g32["blocks"][n])
            for n, g in g16["blocks"].items()}
    errs.update({n: rel_err(g16[n], g32[n]) for n in g16 if n != "blocks"})
    total = tree_rel_err(g16, g32)
    plain = tree_rel_err(grads(attention="local"), g32)
    worst = max(errs, key=errs.get)
    print("training gradients, rows 0-1, against fp32 plain attention: "
          f"bf16 flash rel L2 over all leaves {total:.3e} (bf16 plain "
          f"attention {plain:.3e}), worst leaf {worst} {errs[worst]:.3e}; "
          + " ".join(f"{n}={e:.2e}" for n, e in sorted(errs.items())))
    # bf16 activations and gradients through 24 layers and their
    # backward: at the CPU tests' small config the JAX package's bf16
    # step and the port's both sit ~7.5 % from fp32; the kernels may add
    # no error beyond what bf16 plain attention has
    require(total < 0.15, f"gradients off the fp32 step: {total}")
    require(total < 1.5 * plain + 5e-3,
            f"flash gradients ({total}) worse than bf16 plain attention's "
            f"({plain})")
    del g16, g32

    opt = training.adamw(3e-4)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    _, state, loss0 = step(params, state, x, y)          # warm-up
    loss0 = loss0.item()
    # the same kernels on the same weights: only the reduction order of
    # the mean over 16384 fp32 token losses differs
    require(abs(loss0 - ce) < 1e-4 * abs(ce),
            f"first training loss {loss0} != forward cross-entropy {ce}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the path starts
    losses, times, per_step = [loss0], [], []
    for _ in range(5):
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        t0 = time.perf_counter()
        _, state, loss = step(params, state, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        per_step.append(tuple(a - b for a, b in zip(
            (fa.launches, fa.dq_launches, fa.dkv_launches), before)))
    counts = dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                  flash_bwd_dkv=fa.dkv_launches)          # the path ended
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    require(all(c == (2 * L, L, L) for c in per_step),
            f"launches per step {per_step}, want {(2 * L, L, L)}")
    require(all(np.isfinite(losses)), f"losses not finite: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_s = statistics.median(times)
    print(f"training: first loss {loss0:.6f} vs forward cross-entropy "
          f"{ce:.6f}; losses {[round(v, 6) for v in losses]}; step "
          f"{step_s * 1e3:.2f} ms (median of 5; "
          f"{[round(t * 1e3, 2) for t in times]}) = "
          f"{B * T / step_s:.0f} training tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB, launches per step (flash_fwd, dq, "
          f"dk/dv) {per_step[0]}")
    return counts


def load_example(root, rel, name):
    spec = importlib.util.spec_from_file_location(name, root / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def event_ms(torch, fn):
    """Milliseconds of one ``fn()`` between two CUDA events, the card
    idle before it."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_dp_resnet(torch, np, root, smi):
    """ChainerMN's data-parallel path: ResNet-50, sync BN, batch 256,
    bf16, bf16 wire, one NCCL rank.  Returns the printed metrics."""
    import itertools

    import torch.utils._pytree as pytree

    from chainermn_tpu_torch.links import BatchNormState
    from chainermn_tpu_torch.models import resnet_apply, \
        softmax_cross_entropy
    from chainermn_tpu_torch.ops import fused
    from chainermn_tpu_torch.ops import flash_attention as fa

    ex = load_example(root, "examples/imagenet/train_imagenet_torch.py",
                      "train_imagenet_torch")
    iters = 3
    # 2000 synthetic images: 1800 to train (the trainer's 3 iterations,
    # 3 more through the host path), 200 to validate
    args = ex.parse_args(["--grad-dtype", "bfloat16", "--iterations",
                          str(iters), "--n-images", "2000", "--out",
                          str(root / "build" / "chip_smoke" / "imagenet")])
    torch.backends.cudnn.benchmark = True
    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the path starts
    t0 = time.perf_counter()
    run = ex.build(args, quiet=True)
    comm, cfg, up = run.comm, run.cfg, run.updater
    require(comm.size == 1 and comm.device.type == "cuda",
            f"world of {comm.size} on {comm.device}")
    n_params = sum(p.numel() for p in pytree.tree_leaves(up.params))
    state0 = pytree.tree_map(torch.clone, up.state)
    print(f"dp resnet50: {n_params / 1e6:.2f} M params, world "
          f"{comm.size} rank on {comm.device}, set up in "
          f"{time.perf_counter() - t0:.1f} s")

    losses = []
    run.trainer.extend(lambda tr: losses.append(
        float(tr.observation["main/loss"])), trigger=(1, "iteration"),
        name="losses")
    t0 = time.perf_counter()
    run.trainer.run()
    log = run.log.log[-1]
    print(f"dp resnet50 trainer: {iters} iterations in "
          f"{time.perf_counter() - t0:.1f} s (cuDNN autotuning, synthetic "
          f"images made on the host), losses {losses}, log {log}")
    require(len(losses) == iters and all(np.isfinite(losses)),
            f"losses {losses}")
    require(np.isfinite(log["validation/loss"]), f"validation {log}")
    bn = pytree.tree_leaves(up.state,
                            is_leaf=lambda t: isinstance(t, BatchNormState))
    require(len(bn) == 53 and all(int(s.n) == iters for s in bn),
            f"BN counts {sorted({int(s.n) for s in bn})} after {iters} "
            "iterations")
    moved = [float((a - b).abs().max()) for a, b in zip(
        pytree.tree_leaves(up.state), pytree.tree_leaves(state0))
        if a.dtype == torch.float32]
    require(min(moved) > 0, "a BN running statistic did not move")

    # the host data path: pull, make 256 synthetic images, move, step
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        up.update()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host)
    host_pull = up.observation["main/host_time"] * 1e3

    # a fixed batch on the card through updater.update()
    batch = args.batchsize // comm.size
    rng = np.random.RandomState(SEED)
    x = torch.as_tensor(rng.randn(batch, run.image, run.image, 3).astype(
        np.float32), device=comm.device)
    y = torch.as_tensor(rng.randint(0, cfg.num_classes, batch),
                        device=comm.device)
    up.iterator = itertools.repeat((x, y))
    for _ in range(2):
        up.update()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, per_step = [], []
    for _ in range(5):
        before = comm.n_collectives
        steps.append(event_ms(torch, up.update))
        per_step.append(comm.n_collectives - before)
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(steps)
    images_s = batch * comm.size / (step_ms / 1e3)
    mfu = images_s * RESNET50_TRAIN_FLOPS / PEAK_BF16_FLOPS

    # the gradient exchange alone, on this batch's gradients
    leaves, treedef = pytree.tree_flatten(up.params)
    loss, _ = up.loss_fn(up.params, up.state, x, y)
    grads = pytree.tree_unflatten(
        list(torch.autograd.grad(loss, leaves)), treedef)
    bf16 = torch.bfloat16
    before = comm.n_collectives
    mean = comm.multi_node_mean_grad(pytree.tree_map(torch.clone, grads),
                                     bf16)
    n_exchange = comm.n_collectives - before
    bitwise = all(torch.equal(m, g.to(bf16).to(g.dtype)) for m, g in zip(
        pytree.tree_leaves(mean), pytree.tree_leaves(grads)))
    wire_bytes = sum(g.numel() * 2 for g in pytree.tree_leaves(grads))
    budget = fused.fused_collective_budget(wire_bytes,
                                           fused.DEFAULT_BUCKET_BYTES)
    print(f"dp resnet50 exchange: {n_exchange} NCCL all-reduces for "
          f"{wire_bytes / 2**20:.1f} MiB of bf16 wire (budget {budget}); "
          f"equal to bf16(g) bitwise: {bitwise}; collectives in one step "
          f"(exchange, sync BN forward and backward, the loss) {per_step}")
    require(bitwise, "the size-1 exchange is not bf16(g) bitwise")
    require(0 < n_exchange <= budget,
            f"{n_exchange} all-reduces, budget {budget}")

    g_clone = pytree.tree_map(torch.clone, grads)
    buckets, spec = fused.flatten_buckets(g_clone, fused.DEFAULT_BUCKET_BYTES,
                                          bf16)

    def nccl():
        for b in buckets:
            comm.allreduce_sum_(b)
            b.div_(comm.size)

    ex_parts = dict(
        total=cuda_ms(lambda: comm.multi_node_mean_grad(g_clone, bf16),
                      reps=5),
        pack_cast=cuda_ms(lambda: fused.flatten_buckets(
            g_clone, fused.DEFAULT_BUCKET_BYTES, bf16), reps=5),
        nccl=cuda_ms(nccl, reps=5),
        unpack=cuda_ms(lambda: fused.unflatten_buckets(buckets, spec),
                       reps=5))
    share = ex_parts["total"] / step_ms

    # bf16 against fp32 gradients (32 images, local BN), and fp32 logits
    # on the card against the CPU forward (2 images), TF32 off
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def grad_tree(c, n):
        lg, _ = resnet_apply(c, up.params, up.state, x[:n])
        return torch.autograd.grad(softmax_cross_entropy(lg, y[:n]),
                                   leaves)

    g16, g32 = grad_tree(cfg, 32), grad_tree(cfg32, 32)
    grad_err = (sum(((a - b).float().norm() ** 2).item()
                    for a, b in zip(g16, g32))
                / sum((b.norm() ** 2).item() for b in g32)) ** 0.5
    del g16, g32
    with torch.no_grad():
        lg_card, _ = resnet_apply(cfg32, up.params, up.state, x[:2])
        to_cpu = lambda t: t.detach().cpu() if torch.is_tensor(t) else t
        lg_cpu, _ = resnet_apply(cfg32, pytree.tree_map(to_cpu, up.params),
                                 pytree.tree_map(to_cpu, up.state),
                                 x[:2].cpu())
    logit_err = rel_err(lg_card.cpu(), lg_cpu)
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)  # path ended
    metrics = dict(
        device=smi, batch=batch * comm.size, world=comm.size,
        step_ms=step_ms, steps_ms=steps, images_per_s=images_s, mfu=mfu,
        host_path_step_ms=host_ms, host_path_steps_ms=host,
        host_pull_ms=host_pull,
        host_path_images_per_s=batch * comm.size / (host_ms / 1e3),
        exchange_ms=ex_parts, exchange_share=share,
        exchange_allreduces=n_exchange, exchange_budget=budget,
        collectives_per_step=per_step[0], peak_gib=peak / 2**30,
        bf16_vs_fp32_grad_rel_l2=grad_err, fp32_card_vs_cpu_logits=logit_err,
        flash_launches=counts)
    print(f"dp resnet50 step, fixed batch of {batch} on the card: "
          f"{step_ms:.2f} ms (median of 5, CUDA events; "
          f"{[round(t, 2) for t in steps]}) = {images_s:.1f} images/s, MFU "
          f"{mfu:.2%} of 989 TFLOP/s at 24.534 GFLOP an image; peak memory "
          f"{peak / 2**30:.2f} GiB; through the host data path "
          f"{host_ms:.1f} ms (pull and make {batch} images "
          f"{host_pull:.1f} ms); exchange {ex_parts['total']:.3f} ms = "
          f"{share:.2%} of the step (pack and cast "
          f"{ex_parts['pack_cast']:.3f}, NCCL {ex_parts['nccl']:.3f}, "
          f"unpack {ex_parts['unpack']:.3f} ms); bf16 against fp32 "
          f"gradients rel L2 {grad_err:.3e}; fp32 logits card vs CPU rel L2 "
          f"{logit_err:.3e}")
    print(json.dumps({"dp_resnet50": metrics}))
    require(counts == (0, 0, 0), f"flash launches {counts} on this path")
    # bf16 activations and weights through 53 conv/BN layers against the
    # same gradients in fp32: 4.103e-2 on the H100 (the flagship
    # transformer's bf16 step sits at 4.9e-2 from its fp32 step); the bar
    # leaves 2.4x for other batches and cuDNN's choice of algorithms
    require(grad_err < 0.1, f"bf16 gradients off fp32: {grad_err}")
    # cuDNN's fp32 algorithms (TF32 off) against the CPU's: the same
    # products summed in other orders, through 53 layers of BN (2.3e-7
    # on the H100); a layout or padding fault is of order one
    require(logit_err < 1e-4, f"fp32 logits card vs CPU: {logit_err}")
    torch.backends.cudnn.benchmark = False
    return metrics


def phase_mnist(torch, np, root):
    """The MNIST example, one epoch, in the same one-rank world."""
    from chainermn_tpu_torch.ops import flash_attention as fa

    ex = load_example(root, "examples/mnist/train_mnist_torch.py",
                      "train_mnist_torch")
    args = ex.parse_args(["--epoch", "1", "--out",
                          str(root / "build" / "chip_smoke" / "mnist")])
    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the path starts
    t0 = time.perf_counter()
    log = ex.train(args, quiet=True).log
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)  # path ended
    last = log[-1]
    print(f"mnist: 1 epoch in {time.perf_counter() - t0:.2f} s, log {log}")
    require(counts == (0, 0, 0), f"flash launches {counts} on this path")
    require(np.isfinite(last["main/loss"]), f"loss {last}")
    # the synthetic classes are separable: the JAX example and the port
    # reach 1.0 on the CPU after one epoch
    require(last["validation/accuracy"] >= 0.95,
            f"validation accuracy {last['validation/accuracy']}")
    return last


def clone_tree(torch, tree):
    """``tree`` with every tensor cloned."""
    from chainermn_tpu_torch.utils import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        t.detach().clone() if torch.is_tensor(t) else t for t in leaves])


def grab(torch, up):
    """Copies of everything a step reads and writes: the parameters, the
    BN state, the optimizer's tree, the iterator's state, the
    iteration."""
    from chainermn_tpu_torch.training import optimizer_state_tree

    it = up.iterator
    return dict(params=clone_tree(torch, up.params),
                state=clone_tree(torch, up.state),
                opt=clone_tree(torch, optimizer_state_tree(up.opt_state)),
                iterator=it.state_dict() if hasattr(it, "state_dict")
                else None, iteration=up.iteration,
                epoch_detail=up.epoch_detail)


def put(torch, up, g):
    """Load :func:`grab`'s copies back into ``up`` (the parameters in
    place, so the optimizer keeps its references)."""
    import numpy as np

    from chainermn_tpu_torch.training import load_optimizer_state_tree
    from chainermn_tpu_torch.training._resume import copy_tree_into

    copy_tree_into(up.params, g["params"], "params")
    copy_tree_into(up.state, g["state"], "state")
    load_optimizer_state_tree(up.opt_state, clone_tree(torch, g["opt"]))
    # the iterator keeps the arrays it is given: hand it copies
    up.iterator.load_state_dict({
        k: v.copy() if isinstance(v, np.ndarray) else v
        for k, v in g["iterator"].items()})
    up.iteration, up.epoch_detail = g["iteration"], g["epoch_detail"]


def tree_diff(torch, np, a, b):
    """``(bitwise equal, max abs difference)`` of two trees of tensors,
    arrays and numbers; numpy arrays and numbers must match exactly."""
    from chainermn_tpu_torch.utils import tree_flatten

    la, da = tree_flatten(a)
    lb, db = tree_flatten(b)
    if da != db or len(la) != len(lb):
        return False, float("inf")
    equal, worst = True, 0.0
    for x, y in zip(la, lb):
        if torch.is_tensor(x) or torch.is_tensor(y):
            x, y = torch.as_tensor(x), torch.as_tensor(y).to(x.device)
            if x.shape != y.shape or x.dtype != y.dtype:
                return False, float("inf")
            if not torch.equal(x, y):
                equal = False
                if x.is_floating_point():
                    worst = max(worst, (x.double() - y.double()).abs().max()
                                .item())
                else:
                    worst = float("inf")
        elif not np.array_equal(np.asarray(x), np.asarray(y)):
            equal, worst = False, float("inf")
    return equal, worst


def mnist_drill_args(ex, root, out):
    return ex.parse_args(["--epoch", "1", "--out",
                          str(root / "build" / "chip_smoke" / out)])


def kill_drill_child(ckpt_dir):
    """The killed half of phase 9's SIGKILL drill, in a process of its
    own: the MNIST example for one epoch with a sync checkpoint every 3
    iterations (``history=2``), SIGKILL after iteration 10."""
    import torch  # noqa: F401  (the card's runtime before the world)

    from chainermn_tpu_torch.communicators import init_distributed
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )
    from chainermn_tpu_torch.testing import FaultInjector, FaultPlan

    root = Path(__file__).resolve().parent
    ex = load_example(root, "examples/mnist/train_mnist_torch.py",
                      "train_mnist_torch")
    init_distributed()
    run = ex.build(mnist_drill_args(ex, root, "mnist_killed"), quiet=True)
    cp = create_multi_node_checkpointer(run.comm, ckpt_dir, history=2)
    run.trainer.extend(cp, trigger=(3, "iteration"))
    run.trainer.extend(FaultInjector(FaultPlan(kill_at_iteration=10),
                                     run.comm, checkpointer=cp))
    run.trainer.run()
    return 0                          # not reached: the injector kills


def phase_mnist_kill_drill(torch, np, root):
    """A real SIGKILL on the card: the MNIST example killed after
    iteration 10 (last save at 9) in a child process, resumed here and
    finished; its final parameters, per-iteration losses and log must
    be bitwise those of an uninterrupted run."""
    import shutil

    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )

    ex = load_example(root, "examples/mnist/train_mnist_torch.py",
                      "train_mnist_torch")
    ckpt = root / "build" / "chip_smoke" / "mnist_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)

    def job(out):
        run = ex.build(mnist_drill_args(ex, root, out), quiet=True)
        losses = {}
        run.trainer.extend(lambda tr: losses.__setitem__(
            tr.updater.iteration, float(tr.observation["main/loss"])),
            trigger=(1, "iteration"), name="losses")
        return run, losses

    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--kill-drill",
         str(ckpt)], capture_output=True, text=True, timeout=300,
        cwd=str(root))
    child_s = time.perf_counter() - t0
    require(child.returncode == -9,
            f"the drill's child ended with {child.returncode}, not SIGKILL:"
            f"\n{child.stdout[-2000:]}\n{child.stderr[-2000:]}")
    files = sorted(f.name for f in ckpt.iterdir())
    require(files == ["snapshot_iter_6.0", "snapshot_iter_9.0"],
            f"the killed run left {files}")

    ref, ref_losses = job("mnist_ref")
    ref.trainer.run()
    run, losses = job("mnist_resumed")
    cp = create_multi_node_checkpointer(run.comm, str(ckpt), history=2)
    resumed = cp.maybe_load(run.updater, run.trainer)
    require(resumed == 9, f"resumed at {resumed}, want 9")
    run.trainer.extend(cp, trigger=(3, "iteration"))
    run.trainer.run()
    params_equal, worst = tree_diff(torch, np, run.updater.params,
                                    ref.updater.params)
    n = ref.updater.iteration
    tail = {i: ref_losses[i] for i in range(10, n + 1)}
    # the wall-clock entries (elapsed, host, device and step times) differ
    strip = lambda log: [{k: v for k, v in e.items()
                          if not k.endswith("_time")} for e in log]
    logs_equal = strip(run.log.log) == strip(ref.log.log)
    print(f"mnist SIGKILL drill: child killed after iteration 10 in "
          f"{child_s:.1f} s (files {files}); resumed at {resumed}, "
          f"finished at {run.updater.iteration} of {n}; params bitwise "
          f"{params_equal} (max |diff| {worst:.3e}); losses 10..{n} "
          f"bitwise {losses == tail}; log bitwise {logs_equal}")
    require(run.updater.iteration == n, "the resumed run did not finish")
    require(params_equal, f"resumed params differ by {worst}")
    require(losses == tail, "resumed losses differ from the straight run")
    require(logs_equal, f"log {run.log.log} vs {ref.log.log}")
    return dict(params_bitwise=params_equal, losses_bitwise=True,
                log_bitwise=logs_equal, child_s=child_s,
                iterations=n, resumed_at=resumed)


def phase_checkpoint(torch, np, root, smi):
    """9. ChainerMN's checkpoint and resume on phase 7's ResNet-50 (full
    width and depth, 224 px, batch 256, bf16, bf16 wire, sgd momentum,
    one NCCL rank), then the MNIST SIGKILL drill.  Returns the metrics
    line."""
    import itertools
    import os
    import shutil

    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.testing import corrupt_file
    from chainermn_tpu_torch.training._resume import updater_state
    from chainermn_tpu_torch.utils import load_state, tree_flatten
    from chainermn_tpu_torch.utils.serialization import (
        _host_array as host_array,
        _leaf_crc as leaf_crc,
    )

    ex = load_example(root, "examples/imagenet/train_imagenet_torch.py",
                      "train_imagenet_torch")
    # bitwise resume needs the same algorithms on every run: phase 7
    # autotunes cuDNN, this phase pins it
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    ckpt = root / "build" / "chip_smoke" / "ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t_phase = time.perf_counter()

    def job(seed):
        args = ex.parse_args([
            "--grad-dtype", "bfloat16", "--iterations", "2", "--n-images",
            "1000", "--seed", str(seed), "--out",
            str(root / "build" / "chip_smoke" / f"ckpt_out{seed}")])
        run = ex.build(args, quiet=True)
        cp = create_multi_node_checkpointer(run.comm, str(ckpt), history=2)
        return run, cp

    def timed(fn, box):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            box.append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the path starts
    a, cp_a = job(0)
    up = a.updater
    sync_ms = []
    cp_a.save = timed(cp_a.save, sync_ms)
    a.trainer.extend(cp_a, trigger=(2, "iteration"))
    a.trainer.run()                               # saves at iteration 2
    require(up.iteration == 2 and len(sync_ms) == 1,
            f"iteration {up.iteration}, saves {sync_ms}")
    path2 = ckpt / "snapshot_iter_2.0"
    nbytes = os.path.getsize(path2)
    saved = grab(torch, up)

    # 1. a fresh job from other weights resumes bitwise
    b, cp_b = job(1)
    fresh_equal, _ = tree_diff(torch, np, b.updater.params, saved["params"])
    require(not fresh_equal, "the fresh job's weights equal the saved ones")
    t0 = time.perf_counter()
    resumed = cp_b.maybe_load(b.updater, b.trainer)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    require(resumed == 2, f"maybe_load returned {resumed}, want 2")
    got = grab(torch, b.updater)
    checks = {k: tree_diff(torch, np, got[k], saved[k])[0]
              for k in ("params", "state", "opt", "iterator")}
    checks["iteration"] = got["iteration"] == saved["iteration"] \
        and got["epoch_detail"] == saved["epoch_detail"]
    checks["log"] = b.log.log == a.log.log
    print(f"checkpoint: saved iteration 2 ({nbytes / 1e6:.1f} MB a rank, "
          f"sync save {sync_ms[0]:.1f} ms), fresh job from seed 1 resumed "
          f"at {resumed} in {load_ms:.1f} ms; bitwise {checks}")
    require(all(checks.values()), f"the loaded state differs: {checks}")

    # 2. step 3: twice straight from the same state, once resumed
    up.update()
    torch.cuda.synchronize()
    straight1 = grab(torch, up)
    put(torch, up, saved)
    up.update()
    torch.cuda.synchronize()
    straight2 = grab(torch, up)
    b.updater.update()
    torch.cuda.synchronize()
    resumed3 = grab(torch, b.updater)
    keys = ("params", "state", "opt")
    straight_equal = all(tree_diff(torch, np, straight1[k], straight2[k])[0]
                         for k in keys)
    spread = max(tree_diff(torch, np, straight1[k], straight2[k])[1]
                 for k in keys)
    resumed_equal = all(tree_diff(torch, np, resumed3[k], straight1[k])[0]
                        for k in keys)
    resumed_diff = max(tree_diff(torch, np, resumed3[k], straight1[k])[1]
                       for k in keys)
    print(f"checkpoint: step 3 twice straight bitwise {straight_equal} "
          f"(spread {spread:.3e}); resumed step 3 bitwise {resumed_equal} "
          f"(max |diff| {resumed_diff:.3e})")
    if straight_equal:
        require(resumed_equal, f"resumed step 3 differs by {resumed_diff}"
                " where two straight runs agree bitwise")
    else:
        require(resumed_diff <= spread, f"resumed step 3 differs by "
                f"{resumed_diff}, beyond the straight runs' {spread}")

    # 3. async: the file holds the values before the next step
    cp_async = create_multi_node_checkpointer(up.comm, str(ckpt),
                                              history=2, async_write=True)
    async_ms, writer_ms = [], []
    cp_async._write_part = timed(cp_async._write_part, writer_ms)
    before = grab(torch, up)                       # iteration 3
    t0 = time.perf_counter()
    cp_async.save(up, a.trainer)
    async_ms.append((time.perf_counter() - t0) * 1e3)
    up.update()                                    # mutates in place
    cp_async.finalize()
    on_disk = load_state(str(ckpt / "snapshot_iter_3.0"))
    async_checks = {
        "params": tree_diff(torch, np, on_disk["params"],
                            before["params"])[0],
        "state": tree_diff(torch, np, on_disk["model_state"],
                           before["state"])[0],
        "opt": tree_diff(torch, np, on_disk["opt_state"], before["opt"])[0],
        "moved": not tree_diff(torch, np, up.params, before["params"])[0]}
    print(f"checkpoint: async save of iteration 3 took {async_ms[0]:.1f} ms "
          f"on the main thread, {writer_ms[0]:.1f} ms on the writer; the "
          f"file holds the pre-step values bitwise {async_checks}")
    require(all(async_checks.values()), f"async file: {async_checks}")

    # 4. corrupt the newest file: quarantine and fall back to iteration 2
    corrupt_file(str(ckpt / "snapshot_iter_3.0"), seed=SEED)
    resumed = cp_b.maybe_load(b.updater, b.trainer)
    files = sorted(f.name for f in ckpt.iterdir())
    fallback = tree_diff(torch, np, b.updater.params, saved["params"])[0]
    print(f"checkpoint: after corrupting iteration 3, maybe_load returned "
          f"{resumed}; files {files}; params of iteration 2 bitwise "
          f"{fallback}")
    require(resumed == 2 and fallback and files == [
        "snapshot_iter_2.0", "snapshot_iter_3.0.corrupt"],
        f"fallback: {resumed}, {files}, {fallback}")

    # where a sync save's time goes: the copies to the host, the CRCs,
    # the npz write
    leaves = tree_flatten(updater_state(up, a.trainer))[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = [host_array(x)[0] for x in leaves]
    parts = dict(copy_to_host=(time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for h in host:
        leaf_crc(h)
    parts["crc"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with open(ckpt / "parts.npz", "wb") as f:
        np.savez(f, **{f"leaf_{i:05d}": h for i, h in enumerate(host)})
    parts["npz_write"] = (time.perf_counter() - t0) * 1e3
    os.remove(ckpt / "parts.npz")
    del host
    print(f"checkpoint: a sync save's parts (ms): {parts}")

    # the step with and without a save on it, on a fixed batch on the card
    batch = 256 // up.comm.size
    rng = np.random.RandomState(SEED)
    x = torch.as_tensor(rng.randn(batch, a.image, a.image, 3).astype(
        np.float32), device=up.comm.device)
    y = torch.as_tensor(rng.randint(0, a.cfg.num_classes, batch),
                        device=up.comm.device)
    up.iterator = itertools.repeat((x, y))

    def step_ms(save=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        up.update()
        if save is not None:
            save(up)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    step_ms()
    plain = [step_ms() for _ in range(3)]
    with_sync = step_ms(cp_a.save)
    # the first async save that fills the second half of the double
    # buffer allocates it; later ones reuse a half, and each joins the
    # previous write before it starts its own
    copy_ms = []
    cp_async.save = timed(cp_async.save, async_ms)
    cp_async._host_snapshot = timed(cp_async._host_snapshot, copy_ms)
    with_async = [step_ms(cp_async.save) for _ in range(3)]
    cp_async.finalize()
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)  # path ended
    require(counts == (0, 0, 0), f"flash launches {counts} on this path")
    torch.backends.cudnn.deterministic = False
    resnet_s = time.perf_counter() - t_phase

    drill = phase_mnist_kill_drill(torch, np, root)
    metrics = dict(
        device=smi, snapshot_bytes_per_rank=nbytes, sync_save_ms=sync_ms[0],
        async_save_main_thread_ms=async_ms[0], async_writer_ms=writer_ms[0],
        maybe_load_ms=load_ms, step_ms=statistics.median(plain),
        steps_ms=plain, step_with_sync_save_ms=with_sync,
        step_with_async_save_ms=with_async, async_save_ms=async_ms,
        async_copy_ms=copy_ms, sync_save_parts_ms=parts,
        loaded_bitwise=checks,
        straight_step3_bitwise=straight_equal, straight_spread=spread,
        resumed_step3_bitwise=resumed_equal,
        resumed_step3_max_abs_diff=resumed_diff, async_pre_step_bitwise=
        async_checks, fallback_resumed_at=resumed, mnist_kill_drill=drill,
        resnet_part_s=resnet_s, flash_launches=counts)
    print(f"checkpoint: step {metrics['step_ms']:.1f} ms (fixed batch, host "
          f"clock, median of 3), with a sync save {with_sync:.1f} ms, with "
          f"an async save {[round(t, 1) for t in with_async]} ms (the save "
          f"itself {[round(t, 1) for t in async_ms[1:]]} ms, its copy "
          f"{[round(t, 1) for t in copy_ms]} ms); ResNet part {resnet_s:.1f} "
          f"s, phase {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps({"checkpoint": metrics}))
    return metrics


def tree_rel_err(a, b):
    """Relative L2 error of tree ``a`` against ``b`` over all leaves."""
    from chainermn_tpu_torch.training.optimizers import tree_leaves

    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    num = sum(((x - y).float().norm() ** 2).item() for x, y in pairs)
    return (num / sum((y.float().norm() ** 2).item()
                      for _, y in pairs)) ** 0.5


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on the "
              "card only", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "chainermn_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no chainermn_tpu_torch package beside "
              f"{Path(__file__).name}; run it from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    import numpy as np

    from chainermn_tpu_torch import _build
    from chainermn_tpu_torch.communicators import init_distributed
    from chainermn_tpu_torch.models import (
        TransformerConfig,
        init_numpy_params,
        make_forward_fn,
        make_generate_fn,
        params_from_jax,
    )
    from chainermn_tpu_torch.ops import flash_attention

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    # fp32 references in full fp32: TF32 off for matmuls and cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul False, cudnn False")

    # 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    names = _build.build_all()
    print(f"build: {names} in {time.perf_counter() - t0:.1f} s")

    # 2. kernel against plain version ----------------------------------
    row = phase_kernel(torch, flash_attention)

    # 3. scoring at full width ----------------------------------------
    cfg = TransformerConfig(**FLAGSHIP)
    t0 = time.perf_counter()
    params = params_from_jax(init_numpy_params(cfg, SEED), cfg)
    n_params = sum(p.numel() for p in params.values() if torch.is_tensor(p))
    n_params += sum(p.numel() for p in params["blocks"].values())
    print(f"params: {n_params / 1e6:.1f} M fp32, set up in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    B, T = 8, 2048
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                             device="cuda")
    forward = make_forward_fn(cfg)
    forward(params, tokens)                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0                 # the main path starts
    flash_attention.dq_launches = flash_attention.dkv_launches = 0
    t0 = time.perf_counter()
    logits = forward(params, tokens)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    launches = flash_attention.launches          # the main path ended
    bwd_launches = (flash_attention.dq_launches,
                    flash_attention.dkv_launches)
    peak = torch.cuda.max_memory_allocated()
    require(launches == cfg.n_layers and bwd_launches == (0, 0),
            f"scoring launched flash_fwd {launches} times and the "
            f"backward kernels {bwd_launches}, want {cfg.n_layers} and "
            "(0, 0)")
    require(logits.shape == (B, T, cfg.vocab_size)
            and logits.dtype == torch.float32, f"logits {logits.shape}")
    require(bool(torch.isfinite(logits).all()), "logits not finite")
    ref = make_forward_fn(dataclasses.replace(
        cfg, dtype="float32", attention="local"))(params, tokens[:2])
    err = rel_err(logits[:2], ref)
    agree = (logits[:2].argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"scoring: {B}x{T} tokens in {score_s * 1e3:.2f} ms = "
          f"{B * T / score_s:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB, flash_fwd launches {launches}; "
          f"rows 0-1 vs fp32 plain-attention forward: rel L2 {err:.3e}, "
          f"max abs {(logits[:2] - ref).abs().max().item():.3e}, "
          f"argmax agreement {agree:.4f}")
    # bf16 activations and weights through 24 layers against fp32: the
    # error is relative rounding (2^-9 per step) compounded over depth
    require(err < 5e-2, f"scoring logits off the fp32 forward: {err}")
    del logits, ref

    # 4. answering requests -------------------------------------------
    P, NEW = 128, 64
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)),
                              device="cuda")
    plain = make_generate_fn(cfg, max_len=P + NEW, with_logits=True)
    toks, step_logits = plain(params, prompts)
    # eos = a token row 0 generates, so at least that row stops early
    eos = int(toks[0, P + 10])
    gen = make_generate_fn(cfg, max_len=P + NEW, eos_id=eos, pad_id=0,
                           with_row_state=True)
    gen(params, prompts)                         # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, done, gen_len = gen(params, prompts)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n_gen = int(gen_len.sum())
    first = int((toks[0, P:] == eos).nonzero()[0])
    require(bool(done[0]) and int(gen_len[0]) == first + 1,
            f"row 0 did not stop at eos: done={done.tolist()} "
            f"gen_len={gen_len.tolist()}")
    for b in range(B):
        n = int(gen_len[b])
        require(bool((out[b, :P + n] == toks[b, :P + n]).all()),
                f"row {b}: eos run differs from the plain run")
    full = forward(params, toks[:, :-1])       # predicts positions 1..
    dec = step_logits
    fwd = full[:, P - 1:]
    gerr = rel_err(dec, fwd)
    gagree = (dec.argmax(-1) == fwd.argmax(-1)).float().mean().item()
    print(f"generate: {B} requests x {P} prompt + {NEW} new, eos={eos}: "
          f"{n_gen} tokens in {gen_s * 1e3:.1f} ms = {n_gen / gen_s:.1f} "
          f"generated tokens/s, gen_len={gen_len.tolist()}; decode vs "
          f"full-forward logits over {dec.shape[1]} steps: rel L2 "
          f"{gerr:.3e}, max abs {(dec - fwd).abs().max().item():.3e}, "
          f"argmax agreement {gagree:.4f}")
    # both bf16; they differ in rounding order (cache vs flash attention,
    # fp32 decode head vs bf16-operand head)
    require(gerr < 5e-2, f"decode logits off the full forward: {gerr}")

    del full, dec, fwd, step_logits

    # 5. backward kernels against their plain version ------------------
    bwd_rows = phase_backward(torch, flash_attention)

    # 6. training at full width ---------------------------------------
    counts = phase_training(torch, np, cfg, params, forward)
    del params, forward

    # 7. data-parallel ResNet-50 and 8. MNIST, one NCCL rank ------------
    init_distributed()
    phase_dp_resnet(torch, np, root, smi)
    phase_mnist(torch, np, root)

    # 9. checkpoint and resume, and a SIGKILL drill ---------------------
    phase_checkpoint(torch, np, root, smi)
    torch.distributed.destroy_process_group()

    src = "chainermn_tpu_torch/csrc/"
    tpu = "chainermn_tpu/ops/pallas_attention.py:"
    kernels = [
        dict(name="flash_fwd", route="cuda", source=src + "flash_fwd.cu",
             replaces=tpu + "65", launches=counts["flash_fwd"],
             launches_by_path=dict(scoring=launches,
                                   training=counts["flash_fwd"]),
             matched=True, **row),
        dict(name="flash_bwd_dq", route="cuda", source=src + "flash_bwd.cu",
             replaces=tpu + "151", launches=counts["flash_bwd_dq"],
             matched=True, **bwd_rows["dq"]),
        dict(name="flash_bwd_dkv", route="cuda",
             source=src + "flash_bwd.cu", replaces=tpu + "195",
             launches=counts["flash_bwd_dkv"], matched=True,
             **bwd_rows["dkv"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kill-drill"]:
        # phase 9's child: it never returns, the fault plan kills it
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(kill_drill_child(sys.argv[2]))
    sys.exit(main())
