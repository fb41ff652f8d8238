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
   epoch in the same world, its validation accuracy above a floor;
9. checkpoint and resume of phase 7's ResNet-50 and a SIGKILL drill of
   the MNIST example;
10. the host feed: phase 7's ResNet-50 step through the host over 1280
    images materialised by the example's ``--loader native``, fed by a
    ``SerialIterator``, by the C++ ``NativeBatchIterator``, and by the
    C++ loader behind a ``PrefetchIterator`` (pinned staging, a copy
    stream), with the batches, the parameters and a mid-run resume held
    bitwise;
11. ``MultiNodeChainList`` on one card: the model-parallel MNIST MLP as
    a one-rank chain of self-sends against the plain sequential MLP;
12. ChainerMN's large-batch recipe at full width: ResNet-50 with sync BN
    through ``examples/imagenet/train_imagenet_large_batch_torch.py``'s
    ``build`` — microbatch 256, ``accum_steps=4`` (an update of 1024
    images), LARS on the warm-up and cosine schedule, a bf16 wire,
    double buffering, ``steps_per_execution=2`` captured as one CUDA
    graph — fed by the C++ loader behind ``PrefetchIterator`` over phase
    10's images, with five checks held bitwise: (a) the graph against
    the same updater run eagerly, (b) a window against an explicit
    accumulation loop, (c) double buffering against the inner optimizer
    applied to the previous update's stash (zeros first), (d) the
    backward-overlapped exchange against the window-end one, its hooks
    firing once a bucket in order, (e) the exchange's other forms
    against the flat one;
13. the flagship trained data-parallel through
    ``examples/transformer/train_lm_torch.py``'s ``build`` and ``train``
    on the one-rank NCCL world (8 x 2048 tokens, ``adamw(3e-4)``, bf16,
    remat): (a) its first step bitwise ``make_train_step`` without a
    communicator, (b) ten steps whose loss falls, (c) remat "dots"
    against "full" (gradients bitwise, forward launches 48 → 24 a step),
    (d) ms a step, tokens/s and peak memory of "full", "dots" and no
    remat, (e) ``--text-file SURVEY.md --tokenizer-vocab 512`` at a
    small width, saved, then ``generate_torch.py`` from the checkpoint,
    its decode logits against the full forward;
14. ROADMAP Queue C's drift on one card: the large-batch example
    (``--tiny --steps-per-execution 2 --epoch 3``, TF32 off) on one NCCL
    rank against one gloo rank on this machine's CPU: each epoch's loss
    differences printed, the parameters after the first window held to
    1e-5 relative L2;
15. the mesh's sequence axis on one card (run after phase 13, in its
    NCCL world): (a) the ring's pair schedule over 4 virtual ranks at
    the flagship's attention shape (B=8, T=2048, 16 query / 4 KV heads,
    D=64, bf16), contiguous, zigzag and windowed, forward and gradients
    against one flash call over the whole sequence and against the plain
    ring, its launches against the schedule's count, timed against the
    whole call; (b) Ulysses' head groups bitwise the whole-head call;
    (c) the flagship's ring step at mesh seq=1 bitwise the flash step
    over 2 steps; (d) data-axis decoding bitwise the plain decoding;
16. the mesh's model axis on one card (after phase 15, in its NCCL
    world): (a) the flagship's layer at full width split by
    ``shard_params`` into 4 members (4 query heads and 1 K/V head each),
    every member's attention and MLP with a loopback model
    communicator, the members' residual deltas summed against the whole
    layer in fp32 (plain attention) and bf16 (the kernel, one launch a
    member); (b) the 4 vocab shards' logits against the whole head; (c)
    the flagship's step at mesh model=1 bitwise the plain step over 2
    steps, and ``vocab_parallel`` at model=1 against the replicated
    head;
17. the mesh's pipe axis on one card (after phase 16): the flagship's
    step at full width under GPipe, 1F1B and interleaved (two virtual
    stages) at pipe=1 over 8 micro-batches of one row, each against the
    plain step (loss, gradients), its launches against the schedule's
    count, its ms a step and peak memory.  Phases 2 and 5 also hold and
    time the kernels at such a micro-batch (B=1);
18. MoE at full width on one card (after phase 17): (a) the Switch
    layer alone (16384 tokens, d_model 1024, d_ff 4096, 8 experts,
    bf16) at top-1 and top-2, the index dispatch's slots bitwise the
    one-hot einsums', outputs and drop counts against them, both
    timed; (b) the flagship with ``moe=True`` (8 experts, capacity
    factor 1.25, 1.71 B parameters) trained at top-1 and top-2: its
    loss against plain attention's, its flash launches a step against
    the dense step's, the drops a layer, ms a step, tokens/s and peak
    memory; (c) an expert=4 grouping simulated on the card against the
    unsharded layer at ample capacity;
19. ZeRO-1/2 and FSDP on one card (after phase 16, in its NCCL world):
    (a) the flagship at full width with ``fsdp=True`` over the mesh's
    data group of one, bitwise the plain step, its launches (48, 24, 24)
    a step; (b) ``fsdp_gather``'s bf16 wire over that group: the weights
    and the gradient bf16-rounded element by element; (c) ResNet-50
    under ``StandardUpdater`` with ZeRO-1 and ZeRO-2, bitwise the
    replicated exchange, each one's ms an update, peak and resident
    bytes;
20. the flagship's decode options on one card (after phase 18; 8
    prompts of 128 tokens, 128 new): (a) the int8 tree's bytes and its
    first decode step's logits against bf16's; (b) greedy decoding in
    bf16, with int8 weights, with the int8 KV cache and with both, ms a
    step, tokens/s and peak memory; (c) in fp32 the tokens of
    speculative decoding (k=4, the first 2 blocks as the draft), prompt
    lookup (k=4, bigrams, a repeated 16-token pattern) and 1-beam search
    equal to greedy's; (d) the speculative, lookup and 4-beam runs timed
    in bf16, and one beam reorder of the cache;
21. seq2seq, the convnets and the seq2seq example; 22. shard-only sets
    (both after phase 19, in its NCCL world);
23. the metrics registry and the flight recorder, and the live resize,
    on one card (after phase 22, in its NCCL world): (a) phase 22's
    ResNet-50 ZeRO-1 save, integrity walk and resume with both sinks
    enabled, the Chrome trace and the Prometheus text exported and
    parsed back, each checkpoint span's duration, the updates timed
    with the sinks off and on, and the host cost of one ``span()``
    enabled and disabled; (b) a same-world live resize 1 → 1 (an epoch
    only) whose next 2 updates are bitwise the uninterrupted run.

Phases 3, 6, 13, 15 (a) and (c), 16 (a) and (c), 17, 18 (b) and 19 (a)
are the main paths of the kernels:
each starts with every launch count at 0 and reads the counts when it
ends; phases 7 to 12 and 20 to 23 run no hand-written kernel
(decoding attends the cache with plain products, as the JAX package
does), and hold their counts at 0.  It prints the card's name and power limit, a
``{"dp_resnet50": {...}}`` line of phase 7's metrics, a
``{"large_batch": {...}}`` line of phase 12's,
``{"lm_data_parallel": {...}}`` of phase 13's, ``{"seq_parallel":
{...}}`` of phase 15's, ``{"tensor_parallel_one_card": {...}}`` of
phase 16's, ``{"pipeline_one_card": {...}}`` of phase 17's,
``{"moe_one_card": {...}}`` of phase 18's,
``{"zero_one_card": {...}}`` of phase 19's,
``{"decode_options": {...}}`` of phase 20's,
``{"sinks_one_card": {...}}`` and ``{"live_one_card": {...}}`` of
phase 23's, ``{"drift_one_rank": {...}}`` of phase 14's, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Weights are random, from numpy seed 0.  fp32 references run with TF32
off.

``python3 chip_smoke.py --four-cards`` (four cards) runs the checks that
exist only across cards (:func:`four_cards`, then
:func:`four_cards_seq`, :func:`four_cards_tp`, :func:`four_cards_pp` and
:func:`four_cards_ep`);
``--four-cards seq``
runs the sequence axis's alone: the flagship's step on 4 ranks under
ring (contiguous, zigzag), Ulysses and data=2, seq=2 against one
card's, seq-KV decoding, and remat "dots" against "full" under the
ring (contiguous, zigzag) and Ulysses at seq=4 (:func:`four_cards_dots`:
the gradients of the two policies, the launches, ms and peak memory of
each, the ranks' leaves after a "dots" step); ``--four-cards tp`` the
model axis's alone: the flagship's step at model=4, data=2,model=2 (the
vocabulary sharded, the loss chunked) and model=2,seq=2 (the ring)
against one card's, and decoding at model=4 and data=2,model=2 (the
vocabulary sharded), greedy and int8 4-beam search; ``--four-cards pp`` the pipe axis's alone: the flagship's
step at pipe=4 under GPipe, 1F1B and interleaved and at pipe=2,data=2
under 1F1B against one card's, and decoding at pipe=4; ``--four-cards
ep`` the expert axis's alone: the MoE flagship's step at expert=4
(top-1), data=2,expert=2 (top-2), expert=2,model=2 and pipe=2,expert=2
(1F1B) against one card's simulation of the same per-rank routing, the
layer across the four ranks, decoding at expert=4, and remat "dots"
against "full" at expert=4 and data=2,expert=2 (top-2);
``--four-cards dots`` the five "dots" runs alone; ``--four-cards
zero`` the data axis's sharding alone: the flagship at data=4 with FSDP
(fp32 and bf16 wires), the MoE flagship at data=2,expert=2 (top-2) and
pipe=2,data=2 under 1F1B with FSDP, each against the same mesh without
it, and ResNet-50 under ``StandardUpdater`` at data=4 with ZeRO-1 and
ZeRO-2 against the replicated exchange; ``--four-cards elastic`` the
resume at another world size alone; ``--four-cards live`` the live
resize alone: ResNet-50 under ZeRO-1 on a global batch of 128, live
4 → 2 → 4 in one torchrun (ranks 2 and 3 parked in between) against the
save/restart chain at the same boundaries (three torchruns), then one
more 4 → 2 → 4 cycle with each card's used memory after every resize,
and the control plane over torchrun's store (:func:`four_cards_live`).
"""

import dataclasses
import gc
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
    and wgmma descriptor is held, then a model=4 member's heads (B=8,
    T=2048, 4 query heads and 1 K/V head); returns the JSON fields of
    the row."""
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
    # a model=4 member's heads (phase 16, --four-cards tp): 4 query heads
    # and 1 K/V head, broadcast
    from chainermn_tpu_torch.parallel import broadcast_kv

    q = torch.randn(8, 2048, 4, 64, device="cuda", generator=gen,
                    dtype=bf16)
    kb, vb = broadcast_kv(*(torch.randn(8, 2048, 1, 64, device="cuda",
                                        generator=gen, dtype=bf16)
                            for _ in range(2)), 4)
    o, lse = fa(q, kb, vb, return_lse=True, causal=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_reference(q, kb, vb, causal=True)
    fault, err, rel, n_off = bar_fault(torch, o, o_ref, O_BAR)
    require(fault is None, f"a model=4 member's heads: o: {fault}")
    err_lse = (lse - lse_ref).abs().max().item()
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
    worst, worst_rel = max(worst, err), max(worst_rel, rel)
    print(f"kernel flash_fwd [a model=4 member: H=4 from 1 K/V head] B=8 "
          f"T=2048 D=64 bfloat16 causal against the plain version: max abs "
          f"{err:.3e} rel L2 {rel:.3e} outside the band {n_off} lse "
          f"{err_lse:.3e}")
    # a pipeline micro-batch of the flagship (phase 17, --four-cards pp):
    # one row, 16 heads, causal; checked and timed there
    q, k, v = (torch.randn(1, 2048, H, 64, device="cuda", generator=gen,
                           dtype=bf16) for _ in range(3))
    o, lse = fa(q, k, v, return_lse=True, causal=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_reference(q, k, v, causal=True)
    fault, err, rel, n_off = bar_fault(torch, o, o_ref, O_BAR)
    require(fault is None, f"a micro-batch (B=1): o: {fault}")
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
    worst, worst_rel = max(worst, err), max(worst_rel, rel)
    print(f"kernel flash_fwd [a micro-batch] B=1 T=2048 H=16 D=64 bfloat16 "
          f"causal against the plain version: max abs {err:.3e} rel L2 "
          f"{rel:.3e} outside the band {n_off}")
    row["microbatch_b1"] = dict(time_forward(torch, fa, q, k, v,
                                             dict(causal=True)),
                                max_abs_err=err, rel_l2=rel)
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
    and 128 in bf16 and fp16 (B=2), the tile cases at every D in both
    dtypes, and a model=4 member's heads (B=8, T=2048, 4 query heads and
    1 K/V head); two runs give the same bits; returns the JSON fields
    of the dq and dk/dv rows."""
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
    # a model=4 member's heads (phase 16, --four-cards tp)
    name = "a model=4 member: H=4 from 1 K/V head"
    readings, err, rel, *_ = backward_case(
        torch, fa, name, 8, 2048, 2048, 4, 1, 64, bf16, dict(causal=True),
        gen)
    worst, worst_rel = max(worst, err), max(worst_rel, rel)
    print(f"kernel flash_bwd [{name}] B=8 T=2048 D=64 bfloat16 causal "
          "against the plain version: " + "; ".join(readings))
    # a pipeline micro-batch of the flagship (phase 17, --four-cards pp)
    name = "a micro-batch: B=1"
    readings, err, rel, operands, *_ = backward_case(
        torch, fa, name, 1, 2048, 2048, 16, 16, 64, bf16, dict(causal=True),
        gen)
    worst, worst_rel = max(worst, err), max(worst_rel, rel)
    print(f"kernel flash_bwd [{name}] T=2048 H=16 D=64 bfloat16 causal "
          "against the plain version: " + "; ".join(readings))
    micro = time_backward(torch, ops, *operands, dict(causal=True))
    for label in ("dq", "dkv"):
        rows[label]["microbatch_b1"] = dict(micro[label], max_abs_err=err,
                                            rel_l2=rel)
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


def phase_host_feed(torch, np, root, smi, dp):
    """10. The host feed at full width: phase 7's ResNet-50 (224 px,
    batch 256, bf16, bf16 wire, sgd momentum, one NCCL rank), cuDNN
    pinned as in phase 9, over 1280 synthetic images materialised once
    by the ImageNet example's ``--loader native``.  The host-path step
    (2 warm-ups, median of 5, each step synchronised) through (a) a
    ``SerialIterator`` over the arrays, (b) the example's serial
    ``NativeBatchIterator`` and (c) ``NativeBatchIterator`` +
    ``PrefetchIterator(depth=2)``, beside phase 7's fixed-batch step;
    the batches of (b) and (c) bitwise ``_native_perm``'s, the
    parameters after 5 steps of (c) bitwise (b)'s, and a save and resume
    in the middle of (c) continuing bitwise.  Returns the metrics."""
    import shutil

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )
    from chainermn_tpu_torch.iterators import PrefetchIterator
    from chainermn_tpu_torch.native import NativeBatchIterator, _native_perm
    from chainermn_tpu_torch.ops import flash_attention as fa

    ex = load_example(root, "examples/imagenet/train_imagenet_torch.py",
                      "train_imagenet_torch")
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    # 1423 images: 1280 to train (5 batches of 256), 143 to validate
    args = ex.parse_args([
        "--grad-dtype", "bfloat16", "--loader", "native", "--n-images",
        "1423", "--iterations", "1", "--out",
        str(root / "build" / "chip_smoke" / "feed")])
    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the path starts
    t0 = time.perf_counter()
    run = ex.build(args, quiet=True)
    build_s = time.perf_counter() - t0
    comm, up_b = run.comm, run.updater
    xs, ys = up_b.iterator._arrays
    batch = args.batchsize // comm.size
    require(xs.shape == (1280, run.image, run.image, 3)
            and xs.dtype == np.float32, f"materialised {xs.shape} {xs.dtype}")
    start = (clone_tree(torch, up_b.params), clone_tree(torch, up_b.state))

    def updater(it):
        opt = cmn.create_multi_node_optimizer(
            training.sgd(0.1, momentum=0.9), comm,
            allreduce_grad_dtype=torch.bfloat16)
        # one window in flight, as the port's updater had when these
        # feeds were first measured: the resume check reads each step's
        # own loss, where two in flight would show the one before
        return cmn.StandardUpdater(it, opt, up_b.loss_fn,
                                   clone_tree(torch, start[0]), comm,
                                   state=clone_tree(torch, start[1]),
                                   max_inflight=1)

    def native():
        return NativeBatchIterator([xs, ys], batch, shuffle=True, seed=1)

    def timed(up):
        steps, after5 = [], None
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            up.update()
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            if i == 4:
                # not grab(): the prefetcher's state_dict stops its worker
                after5 = dict(params=clone_tree(torch, up.params),
                              state=clone_tree(torch, up.state))
        return statistics.median(steps[2:]), steps, after5

    feeds = {}
    up_a = updater(cmn.SerialIterator((xs, ys), batch, shuffle=True,
                                      seed=1))
    feeds["a_serial_arrays"] = timed(up_a)
    del up_a
    feeds["b_native_serial"] = timed(up_b)
    up_c = updater(PrefetchIterator(native(), comm, depth=2))
    feeds["c_native_prefetch"] = timed(up_c)
    host = {k: up.observation["main/host_time"] * 1e3
            for k, up in (("b_native_serial", up_b),
                          ("c_native_prefetch", up_c))}
    params_equal, worst = tree_diff(
        torch, np, feeds["b_native_serial"][2]["params"],
        feeds["c_native_prefetch"][2]["params"])
    state_equal = tree_diff(torch, np, feeds["b_native_serial"][2]["state"],
                            feeds["c_native_prefetch"][2]["state"])[0]

    # the batches of (b) and (c): _native_perm's order, bitwise
    plain_b, plain_c = native(), PrefetchIterator(native(), comm, depth=2)
    batches_equal = []
    for step in range(7):
        ep, k = divmod(step, len(xs) // batch)
        idx = _native_perm(len(xs), 1, ep)[k * batch:(k + 1) * batch]
        got_b = next(plain_b)
        got_c = next(plain_c).arrays
        batches_equal.append(
            np.array_equal(got_b[0], xs[idx])
            and np.array_equal(got_b[1], ys[idx])
            and np.array_equal(got_c[0].cpu().numpy(), xs[idx])
            and np.array_equal(got_c[1].cpu().numpy(), ys[idx]))
    plain_c.close()
    del got_b, got_c, plain_b

    # where a host-path batch's time goes (median of 3, host clock,
    # synchronised): the gather of (a), the copy out of a C++ slot of
    # (b), a pageable copy to the card; (c)'s copy into pinned staging
    # and its copy to the card from there
    idx = _native_perm(len(xs), 1, 0)[:batch]
    loader = native()            # the slot's memory lives as long as it
    slot = next(loader)[0]
    pinned = torch.empty(slot.shape, dtype=torch.float32, pin_memory=True)

    def part(fn):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    parts = dict(
        gather=part(lambda: xs[idx]), slot_copy=part(lambda: np.array(slot)),
        pageable_to_card=part(lambda: torch.from_numpy(slot).to(comm.device)),
        pinned_stage=part(lambda: np.copyto(pinned.numpy(), slot)),
        pinned_to_card=part(lambda: pinned.to(comm.device, non_blocking=True)))
    del slot, loader, pinned

    # a restore 90 epochs (450 batches) in: the loader starts there and
    # replays nothing, so it costs a rebuild, not 450 gathers
    far = native()
    t0 = time.perf_counter()
    far.load_state_dict({"popped": 90 * (len(xs) // batch)})
    restore_far_ms = (time.perf_counter() - t0) * 1e3
    idx = _native_perm(len(xs), 1, 90)[:batch]
    got_far = next(far)
    far_equal = bool(np.array_equal(got_far[0], xs[idx])
                     and np.array_equal(got_far[1], ys[idx]))
    del got_far, far

    # save in the middle of (c) (iteration 7, the worker ahead), go on
    # two steps, resume from the file into the same job, replay them
    ckpt = root / "build" / "chip_smoke" / "feed_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    cp = create_multi_node_checkpointer(comm, str(ckpt))
    cp.save(up_c)
    straight = []
    for _ in range(2):
        up_c.update()
        straight.append(float(up_c.observation["main/loss"]))
    want = grab(torch, up_c)
    resumed_at = cp.maybe_load(up_c)
    replay = []
    for _ in range(2):
        up_c.update()
        replay.append(float(up_c.observation["main/loss"]))
    got = grab(torch, up_c)
    resume_equal = replay == straight and all(
        tree_diff(torch, np, got[k], want[k])[0]
        for k in ("params", "state", "opt"))
    up_c.finalize()
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)  # path ended
    torch.backends.cudnn.deterministic = False

    step = {k: v[0] for k, v in feeds.items()}
    metrics = dict(
        device=smi, batch=batch * comm.size, images=len(xs),
        materialise_s=build_s, host_path_step_ms=step,
        host_path_steps_ms={k: v[1] for k, v in feeds.items()},
        last_host_time_ms=host, batch_parts_ms=parts,
        images_per_s={k: batch * comm.size / (v / 1e3)
                      for k, v in step.items()},
        fixed_batch_step_ms_phase7=dp["step_ms"],
        lazy_host_path_step_ms_phase7=dp["host_path_step_ms"],
        # prefetch's own gain, over the same materialised arrays
        prefetch_speedup_c_over_a=step["a_serial_arrays"]
        / step["c_native_prefetch"],
        prefetch_speedup_c_over_b=step["b_native_serial"]
        / step["c_native_prefetch"],
        # materialising the images up front (outside the timed steps)
        # and prefetch together, against phase 7's lazy images
        materialised_c_over_lazy_phase7=dp["host_path_step_ms"]
        / step["c_native_prefetch"],
        restore_90_epochs_in_ms=restore_far_ms,
        restore_90_epochs_in_bitwise=far_equal,
        batches_bitwise=all(batches_equal),
        params_after5_b_c_bitwise=params_equal,
        params_after5_max_abs_diff=worst, bn_state_after5_bitwise=state_equal,
        resumed_at=resumed_at, resume_bitwise=resume_equal,
        flash_launches=counts)
    print(f"host feed: 1280 images materialised by --loader native in "
          f"{build_s:.1f} s; host-path step (median of 5 after 2 warm-ups, "
          f"each synchronised): (a) serial over the arrays "
          f"{step['a_serial_arrays']:.2f} ms, (b) native serial "
          f"{step['b_native_serial']:.2f} ms, (c) native + prefetch depth 2 "
          f"{step['c_native_prefetch']:.2f} ms; phase 7: fixed batch "
          f"{dp['step_ms']:.2f} ms, lazy images through the host "
          f"{dp['host_path_step_ms']:.1f} ms; a batch's parts (ms) "
          f"{ {k: round(v, 2) for k, v in parts.items()} }; prefetch's "
          f"gain (a)/(c) {metrics['prefetch_speedup_c_over_a']:.3f}x, "
          f"(b)/(c) {metrics['prefetch_speedup_c_over_b']:.3f}x; a restore "
          f"90 epochs in {restore_far_ms:.2f} ms (bitwise {far_equal}); "
          f"batches bitwise "
          f"{batches_equal}; params after 5 steps (b) = (c) bitwise "
          f"{params_equal} (max |diff| {worst:.3e}); resumed at "
          f"{resumed_at}, next 2 steps bitwise {resume_equal}")
    print(json.dumps({"host_feed": metrics}))
    require(counts == (0, 0, 0), f"flash launches {counts} on this path")
    require(all(batches_equal), f"batches off _native_perm: {batches_equal}")
    require(params_equal and state_equal,
            f"(c) after 5 steps differs from (b) by {worst}")
    require(resumed_at == 7 and resume_equal,
            f"resume at {resumed_at}: {replay} vs {straight}")
    require(far_equal, "the loader restored 90 epochs in is off "
            "_native_perm's order")
    return metrics, (xs, ys)


def phase_model_parallel(torch, np, root, smi):
    """11. ``MultiNodeChainList`` on one card: the model-parallel MNIST
    MLP's two stages (``[784, 256, 256]`` → ``[256, 10]``) as a one-rank
    chain (NCCL refuses two ranks on one GPU), every component on rank 0
    and the transfers self-sends, held against a plain sequential run of
    the same MLP on the card: loss and gradients."""
    import torch.utils._pytree as pytree

    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.links import MultiNodeChainList
    from chainermn_tpu_torch.models import (
        init_mlp_numpy, mlp_apply, softmax_cross_entropy)
    from chainermn_tpu_torch.ops import flash_attention as fa

    comm = create_communicator()
    mn = MultiNodeChainList(comm)
    mn.add_link(lambda s: init_mlp_numpy([784, 256, 256], s), mlp_apply,
                owner=0, rank_out=0, name="lower_half")
    mn.add_link(lambda s: init_mlp_numpy([256, 10], s), mlp_apply,
                owner=0, rank_in=0, name="upper_half")
    numpy_params = mn.init(seed=0)
    mn.load_params(numpy_params)
    dev = comm.device
    seq = [[{k: torch.tensor(v, device=dev, requires_grad=True)
             for k, v in layer.items()} for layer in part]
           for part in numpy_params]
    mnist = load_example(root, "examples/mnist/train_mnist_torch.py",
                         "train_mnist_torch")
    train, _ = mnist.make_dataset()
    x = torch.as_tensor(np.stack([a for a, _ in train[:128]]), device=dev)
    y = torch.as_tensor(np.stack([b for _, b in train[:128]]), device=dev)

    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the path starts
    t0 = time.perf_counter()
    loss = softmax_cross_entropy(mn(x), y)
    loss.backward()
    grads = mn.reduce_grads(mn.grads())
    torch.cuda.synchronize()
    mp_ms = (time.perf_counter() - t0) * 1e3
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)  # path ended
    ref = softmax_cross_entropy(mlp_apply(seq[1], mlp_apply(seq[0], x)), y)
    leaves = pytree.tree_leaves(seq)
    ref_grads = torch.autograd.grad(ref, leaves)
    got = pytree.tree_leaves(grads)
    loss_equal = torch.equal(loss.detach(), ref.detach())
    grads_equal = all(torch.equal(a, b) for a, b in zip(got, ref_grads))
    err = tree_rel_err(got, list(ref_grads))
    metrics = dict(device=smi, loss=loss.item(), loss_bitwise=loss_equal,
                   grads_bitwise=grads_equal, grads_rel_l2=err,
                   step_ms=mp_ms, flash_launches=counts)
    print(f"model parallel: one-rank chain (2 components, self-sends) on "
          f"{comm.device}: loss {loss.item():.6f} vs sequential "
          f"{ref.item():.6f} bitwise {loss_equal}; gradients bitwise "
          f"{grads_equal} (rel L2 {err:.3e}); forward and backward "
          f"{mp_ms:.1f} ms (first call)")
    print(json.dumps({"model_parallel": metrics}))
    require(counts == (0, 0, 0), f"flash launches {counts} on this path")
    require(len(got) == len(ref_grads) == 6, f"{len(got)} gradients")
    # the same kernels on the same inputs; the transfers are copies and
    # the ties add zeros
    require(abs(loss.item() - ref.item()) <= 1e-6 * abs(ref.item())
            and err <= 1e-6, f"chain off the sequential MLP: {err}")
    return metrics


def host_launches(torch, fn):
    """``(host launch calls, device kernels)`` of one ``fn()``, read
    from ``torch.profiler``'s CUDA trace: the CUDA API calls that
    enqueue work (kernels, graphs, copies, memsets) and the kernels the
    card ran."""
    from torch.profiler import ProfilerActivity, profile

    calls = ("LaunchKernel", "GraphLaunch", "MemcpyAsync", "MemsetAsync")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host = device = 0
    for e in prof.key_averages():
        if any(c in e.key for c in calls):
            host += e.count
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device += e.count
    return host, device


def phase_large_batch(torch, np, root, smi, arrays):
    """12. ChainerMN's large-batch recipe (``train_imagenet_large_batch``
    of the JAX package, BASELINE.md config 5) at full width on one NCCL
    rank: ResNet-50, sync BN, 224 px, bf16, microbatch 256 with
    ``accum_steps=4``, LARS on the warm-up and cosine schedule, a bf16
    wire, double buffering and ``steps_per_execution=2`` (a window of 8
    microbatches, one CUDA graph), fed by the C++ loader behind
    ``PrefetchIterator`` over phase 10's 1280 images.  cuDNN is pinned;
    checks (a)-(e) are bitwise.  Returns the printed metrics."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.iterators import PrefetchIterator
    from chainermn_tpu_torch.native import NativeBatchIterator
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.ops import fused
    import torch.utils._pytree as pytree

    from chainermn_tpu_torch.training import optimizer_state_tree

    ex = load_example(root,
                      "examples/imagenet/train_imagenet_large_batch_torch.py",
                      "train_imagenet_large_batch_torch")
    xs, ys = arrays
    M, S, B = 4, 2, 256
    bf16 = torch.bfloat16
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the path starts
    t_phase = time.perf_counter()
    device_comm = cmn.create_communicator()

    def feed():
        return PrefetchIterator(
            NativeBatchIterator([xs, ys], B, shuffle=True, seed=1),
            device_comm, steps_per_execution=S * M, depth=2)

    def recipe(spe):
        args = ex.parse_args([
            "--optimizer", "lars", "--steps-per-execution", str(spe),
            "--grad-dtype", "bfloat16", "--out",
            str(root / "build" / "chip_smoke" / "large_batch")])
        it = feed() if spe == S else PrefetchIterator(
            NativeBatchIterator([xs, ys], B, shuffle=True, seed=1),
            device_comm, steps_per_execution=M, depth=2)
        return ex.build(args, quiet=True, accum_steps=M, iterator=it,
                        n_images=2000)

    run = recipe(S)
    comm, up, loss_fn = run.comm, run.updater, run.updater.loss_fn
    schedule = run.schedule
    require(up.graphs and up.window_steps == S * M and comm.size == 1,
            f"graphs {up.graphs}, window {up.window_steps}")
    start = (clone_tree(torch, up.params), clone_tree(torch, up.state))
    del run

    # times: a window's microbatches, host clock around a synchronised
    # update, the prefetch feed on
    def per_microbatch(u, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u.update()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3 / u.window_steps)
        return out

    # memory: each mode measured with only its own updater alive, after
    # the cache of freed blocks is returned; a graph's private pool is
    # reserved, not allocated, between replays, so its peak is the
    # reserved one
    def release():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    def measured(u, n):
        release()
        torch.cuda.reset_peak_memory_stats()
        ms = per_microbatch(u, n)
        return ms, torch.cuda.max_memory_allocated(), \
            torch.cuda.max_memory_reserved()

    # (a) three windows: a warm-up on a side stream, a capture and its
    # replay, a replay; against six updates of the eager updater, run
    # after this one is released
    for _ in range(3):
        up.update()
    torch.cuda.synchronize()
    fused_win = next(iter(up._windows.values()))
    replays = getattr(fused_win, "replays", 0)
    captured = getattr(fused_win, "graph", None) is not None
    graph_iter = up.iteration
    graph_trees = clone_tree(torch, dict(
        params=up.params, bn_state=up.state,
        opt_state=optimizer_state_tree(up.opt_state)))
    graph_ms, graph_peak, graph_reserved = measured(up, 2)
    launches_graph = host_launches(torch, up.update)
    up.finalize()
    del up, fused_win
    released = release()

    eager = recipe(1).updater
    require(not eager.graphs, "spe=1 updater captures")
    for _ in range(3 * S):
        eager.update()
    torch.cuda.synchronize()
    a_checks = {k: tree_diff(torch, np, graph_trees[k], y)[0] for k, y in (
        ("params", eager.params), ("bn_state", eager.state),
        ("opt_state", optimizer_state_tree(eager.opt_state)))}
    a_worst = tree_diff(torch, np, graph_trees["params"], eager.params)[1]
    require(graph_iter == eager.iteration == 3 * S * M,
            f"iterations {graph_iter} {eager.iteration}")
    require(captured and replays == 2,
            f"no captured window, or {replays} replays, not 2")
    del graph_trees
    eager_ms, eager_peak, eager_reserved = measured(eager, 2 * S)
    launches_eager = host_launches(torch, eager.update)
    eager.finalize()
    del eager
    release()

    # (b) one update of 4 microbatches against an explicit loop: fp32
    # sums in order, divided, cast, one exchange, one LARS step
    batches = [(xs[i * B:(i + 1) * B], ys[i * B:(i + 1) * B])
               for i in range(M)]

    def updater(opt, m=M):
        return cmn.StandardUpdater(iter(batches * 2), opt, loss_fn,
                                   clone_tree(torch, start[0]), comm,
                                   state=clone_tree(torch, start[1]),
                                   accum_steps=m)

    def optimizer(**kw):
        return cmn.create_multi_node_optimizer(
            ex.make_inner("lars", schedule), comm,
            allreduce_grad_dtype=bf16, **kw)

    up_b = updater(optimizer())
    up_b.update()
    params = clone_tree(torch, start[0])
    # torch's pytree order: the optimizers' and the state trees' order
    leaves, treedef = pytree.tree_flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    st, acc = clone_tree(torch, start[1]), None
    for x, y in batches:
        x = torch.as_tensor(x, device=comm.device)
        y = torch.as_tensor(y, device=comm.device)
        loss, st = loss_fn(params, st, x, y)
        g = [t.float() for t in torch.autograd.grad(loss, leaves)]
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
    mean = pytree.tree_unflatten([(a / M).to(t.dtype)
                                  for a, t in zip(acc, leaves)], treedef)
    inner = ex.make_inner("lars", schedule)
    inner_state = inner.init(params)
    inner.update(comm.multi_node_mean_grad(mean, bf16), inner_state, params)
    b_checks = dict(params=tree_diff(torch, np, up_b.params, params)[0],
                    bn_state=tree_diff(torch, np, up_b.state, st)[0])

    # (c) double buffering: update 0 is the inner optimizer on zeros (it
    # moves LARS's weight-decayed parameters), update 1 on update 0's
    # stash
    up_c = updater(optimizer(double_buffering=True), m=1)
    ref = clone_tree(torch, start[0])
    ref_opt = ex.make_inner("lars", schedule)
    ref_state = ref_opt.init(ref)
    zeros = pytree.tree_unflatten([torch.zeros_like(t) for t in leaves],
                                  treedef)
    up_c.update()
    ref_opt.update(zeros, ref_state, ref)
    c_moved = not tree_diff(torch, np, ref, start[0])[0]
    c_checks = {"update0": tree_diff(torch, np, up_c.params, ref)[0]}
    stash = clone_tree(torch, optimizer_state_tree(up_c.opt_state)[
        "prev_grads"])
    up_c.update()
    ref_opt.update(pytree.tree_unflatten(stash, treedef), ref_state, ref)
    c_checks["update1"] = tree_diff(torch, np, up_c.params, ref)[0]
    del up_c, ref, ref_opt, ref_state, zeros

    # (d) the overlapped exchange: hooks on the last microbatch's
    # backward, against (b)'s window-end exchange
    opt_d = optimizer(overlap=True)
    seen = []
    make = opt_d.overlapped
    opt_d.overlapped = lambda p: seen.append(make(p)) or seen[-1]
    up_d = updater(opt_d)
    up_d.update()
    n_buckets = len(opt_d.mean.schedule)
    d_checks = dict(
        params=tree_diff(torch, np, up_d.params, up_b.params)[0],
        bn_state=tree_diff(torch, np, up_d.state, up_b.state)[0],
        in_order=len(seen) == 1
        and seen[0].launched == list(range(n_buckets)),
        every_leaf=len(seen) == 1
        and len(seen[0]._bucket_of) == len(leaves),
        # one rank: each leaf's mean is bf16(g) cast back, as phase 7's
        bf16_of_mean=len(seen) == 1 and all(
            torch.equal(o, m.to(bf16).to(m.dtype))
            for o, m in zip(seen[0]._out, pytree.tree_leaves(mean))))
    del up_d, opt_d, seen, up_b

    # (e) the other forms against the flat exchange, on (b)'s mean
    flat = comm.multi_node_mean_grad(clone_tree(torch, mean), bf16)
    intra, inter = comm.hierarchy()
    sched = fused.build_overlap_schedule(mean, wire_dtype=bf16)
    vec = torch.cat([t.reshape(-1) for t in pytree.tree_leaves(mean)]).to(
        bf16)
    e_checks = dict(
        rs_ag_bucket=torch.equal(fused.reduce_scatter_allgather(vec, comm),
                                 comm.allreduce(vec, "mean")),
        overlap_rs=tree_diff(torch, np, fused.overlap_exchange(
            mean, comm, schedule=sched, wire_dtype=bf16), flat)[0],
        overlap_ar=tree_diff(torch, np, fused.overlap_exchange(
            mean, comm, schedule=[dict(e, via="ar") for e in sched],
            wire_dtype=bf16), flat)[0],
        two_stage=tree_diff(torch, np, fused.fused_allreduce(
            clone_tree(torch, mean), intra, wire_dtype=bf16,
            inter_comm=inter), flat)[0])
    del flat, vec, mean, params, st, acc, leaves
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)  # path ended
    torch.backends.cudnn.deterministic = False
    phase_s = time.perf_counter() - t_phase

    g_ms, e_ms = statistics.median(graph_ms), statistics.median(eager_ms)
    metrics = dict(
        device=smi, microbatch=B, accum_steps=M, steps_per_execution=S,
        effective_batch=B * M * comm.size, optimizer="lars",
        wire="bfloat16", double_buffering=True,
        eager_ms_per_microbatch=e_ms, graph_ms_per_microbatch=g_ms,
        eager_ms_runs=eager_ms, graph_ms_runs=graph_ms,
        images_per_s_eager=B * comm.size / (e_ms / 1e3),
        images_per_s_graph=B * comm.size / (g_ms / 1e3),
        host_launches_per_microbatch_eager=launches_eager[0] / M,
        host_launches_per_microbatch_replay=launches_graph[0] / (S * M),
        device_kernels_per_microbatch_eager=launches_eager[1] / M,
        device_kernels_per_microbatch_replay=launches_graph[1] / (S * M),
        # each with only its own updater alive; the graph's peak is its
        # reserved memory (the private pool's intermediates are not
        # counted as allocated)
        peak_gib_graph=graph_reserved / 2**30,
        peak_gib_eager=eager_peak / 2**30,
        allocated_gib_graph=graph_peak / 2**30,
        reserved_gib_eager=eager_reserved / 2**30,
        graph_released_gib=[b / 2**30 for b in released],
        overlap_buckets=n_buckets, lr_moved_params_at_update0=c_moved,
        checks=dict(a_graph_vs_eager=a_checks, b_accumulation=b_checks,
                    c_double_buffering=c_checks, d_overlap=d_checks,
                    e_forms=e_checks),
        a_params_max_abs_diff=a_worst, flash_launches=counts,
        phase_s=phase_s)
    print(f"large batch: ResNet-50 microbatch {B} x accum {M} x "
          f"{S} updates a window, LARS, bf16 wire, double buffering: "
          f"eager {e_ms:.2f} ms a microbatch, graph {g_ms:.2f} ms "
          f"({metrics['images_per_s_graph']:.1f} images/s); host launches "
          f"a microbatch eager {launches_eager[0] / M:.1f}, replay "
          f"{launches_graph[0] / (S * M):.2f}; memory, each mode alone: "
          f"graph {graph_reserved / 2**30:.2f} GiB reserved (its pool), "
          f"eager {eager_peak / 2**30:.2f} GiB allocated "
          f"({eager_reserved / 2**30:.2f} reserved); checks "
          f"{metrics['checks']}"
          f"; phase {phase_s:.1f} s")
    print(json.dumps({"large_batch": metrics}))
    require(counts == (0, 0, 0), f"flash launches {counts} on this path")
    require(all(a_checks.values()),
            f"(a) graph against eager: {a_checks} (params {a_worst})")
    require(all(b_checks.values()), f"(b) accumulation: {b_checks}")
    require(c_moved and all(c_checks.values()),
            f"(c) double buffering: {c_checks}, moved {c_moved}")
    require(all(d_checks.values()), f"(d) overlap: {d_checks}")
    require(all(e_checks.values()), f"(e) forms: {e_checks}")
    return metrics


# the flagship through train_lm_torch.py's flags: 8 x 2048 tokens a rank,
# bf16 compute, flash attention, remat, adamw(3e-4)
FLAGSHIP_ARGV = ["--vocab", "32000", "--d-model", "1024", "--n-heads", "16",
                 "--n-kv-heads", "4", "--n-layers", "24", "--seq", "2048",
                 "--attention", "flash", "--dtype", "bfloat16", "--remat",
                 "--lr", "3e-4"]


def trees_equal(torch, a, b):
    from chainermn_tpu_torch.training.optimizers import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def time_steps(torch, step, params, state, x, y, n=5):
    """A warm-up step, then ``n`` timed ones (host clock around a
    synchronised step, as phase 6): their ms, the peak memory of the
    timed steps in GiB, the memory resident between steps (parameters,
    optimizer state, whatever else is alive) and the losses."""
    _, state, loss = step(params, state, x, y)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], [loss.item()]
    for _ in range(n):
        t0 = time.perf_counter()
        _, state, loss = step(params, state, x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    return times, torch.cuda.max_memory_allocated() / 2**30, resident, \
        losses


def phase_lm_data_parallel(torch, np, root, smi):
    """13. The flagship trained data-parallel through
    ``examples/transformer/train_lm_torch.py``'s ``build`` and ``train``
    on the one-rank NCCL world: (a) the example's first step bitwise
    ``make_train_step`` without a communicator on the same batch, (b) ten
    steps whose loss falls, (c) remat "dots" against "full" (gradients
    bitwise, forward launches halved), (d) ms a step, tokens/s and peak
    memory of "full", "dots" and no remat, (e) ``--text-file`` with a BPE
    vocabulary at a small width, saved and read back by
    ``generate_torch.py``, its decode logits against the full forward.
    Returns the launch counts of the ten steps and the printed metrics."""
    import shutil

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        make_forward_fn, make_train_step, make_value_and_grad_fn)
    from chainermn_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    ex = load_example(root, "examples/transformer/train_lm_torch.py",
                      "train_lm_torch")
    B, steps = 8, 10
    args = ex.parse_args(FLAGSHIP_ARGV + ["--batchsize", str(B),
                                          "--steps", str(steps)])
    run = ex.build(args, quiet=True)
    cfg, dev, T = run.cfg, run.comm.device, run.cfg.max_seq
    require(run.comm.size == 1 and dev.type == "cuda",
            f"phase 13 wants one NCCL rank, got {run.comm}")
    x0, y0 = next(ex.make_batches(cfg.vocab_size, B, T, 1, seed=0))

    # (a) the plain step from the same weights on the same first batch
    plain_params = clone_tree(torch, run.params)
    opt = training.adamw(3e-4)
    plain_state = opt.init(plain_params)
    _, _, plain_loss = make_train_step(cfg, opt, device=dev)(
        plain_params, plain_state, x0, y0)
    del plain_state
    first = {}
    dp_step = run.step

    def step_and_keep(params, state, x, y):
        out = dp_step(params, state, x, y)
        if not first:
            first.update(loss=out[2].clone(), params=clone_tree(torch, out[0]))
        return out

    run.step = step_and_keep
    torch.cuda.synchronize()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the path starts
    t0 = time.perf_counter()
    losses = ex.train(run)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                  flash_bwd_dkv=fa.dkv_launches)          # the path ended
    L = cfg.n_layers
    require(counts == dict(flash_fwd=2 * L * steps, flash_bwd_dq=L * steps,
                           flash_bwd_dkv=L * steps),
            f"phase 13 launches {counts}, want {(2 * L, L, L)} a step")
    bitwise = bool(torch.equal(first["loss"], plain_loss)) \
        and trees_equal(torch, first["params"], plain_params)
    print(f"lm data-parallel (a): the example's first step against "
          f"make_train_step without comm: loss {first['loss'].item():.6f} "
          f"vs {plain_loss.item():.6f}, bitwise {bitwise}")
    require(bitwise, "the one-rank data-parallel step is not the plain one")
    del first, plain_params
    # (b)
    print(f"lm data-parallel (b): {steps} steps through train_lm_torch "
          f"({train_s:.1f} s): losses {[round(v, 5) for v in losses]}")
    require(len(losses) == steps and all(np.isfinite(losses))
            and losses[-1] < losses[0], f"loss did not fall: {losses}")

    # (c) remat "dots" against "full" on the same weights and batch
    grads, per_policy = {}, {}
    for policy in ("full", "dots"):
        fn = make_value_and_grad_fn(dataclasses.replace(
            cfg, remat_policy=policy), device=dev)
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        grads[policy] = fn(run.params, x0, y0)
        torch.cuda.synchronize()
        per_policy[policy] = (fa.launches, fa.dq_launches, fa.dkv_launches)
    same = bool(torch.equal(grads["dots"][0], grads["full"][0])) \
        and trees_equal(torch, grads["dots"][1], grads["full"][1])
    worst = tree_rel_err(grads["dots"][1], grads["full"][1])
    print(f"lm data-parallel (c): remat dots against full: loss and "
          f"gradients bitwise {same} (rel L2 {worst:.3e}); launches a step "
          f"(flash_fwd, dq, dk/dv) full {per_policy['full']}, dots "
          f"{per_policy['dots']}")
    require(same, f"dots gradients differ from full: rel L2 {worst}")
    require(per_policy["full"] == (2 * L, L, L)
            and per_policy["dots"] == (L, L, L),
            f"launches a step {per_policy}")
    del grads

    # (d) each remat mode's step, time and memory, with one optimizer
    # state alive (the mode's own)
    modes = {}
    run.opt_state = None
    for name, kw in (("full", dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots")),
                     ("none", dict(remat=False))):
        mcfg = dataclasses.replace(cfg, **kw)
        opt = training.adamw(3e-4)
        state = opt.init(run.params)
        gc.collect()
        torch.cuda.empty_cache()
        times, peak, resident, mlosses = time_steps(
            torch, make_train_step(mcfg, opt, comm=run.comm), run.params,
            state, x0, y0)
        del state
        ms = statistics.median(times)
        modes[name] = dict(ms=ms, times_ms=times, tokens_per_s=B * T / ms
                           * 1e3, peak_gib=peak, resident_gib=resident)
        require(all(np.isfinite(mlosses)), f"{name}: losses {mlosses}")
        print(f"lm data-parallel (d): remat {name}: step {ms:.2f} ms "
              f"(median of 5; {[round(t, 2) for t in times]}) = "
              f"{B * T / ms * 1e3:.0f} tokens/s, peak {peak:.2f} GiB "
              f"({resident:.2f} GiB resident between steps)")
    del run

    # (e) a text file with a BPE vocabulary, saved, then generation
    ck = root / "build" / "chip_smoke" / "lm_text"
    shutil.rmtree(ck, ignore_errors=True)
    small = ["--d-model", "256", "--n-heads", "4", "--n-layers", "4",
             "--dtype", "bfloat16"]
    text = ex.main(["--text-file", str(root / "SURVEY.md"),
                    "--tokenizer-vocab", "512", "--seq", "256",
                    "--batchsize", "8", "--steps", "30", "--lr", "3e-3",
                    "--attention", "flash", "--checkpoint", str(ck)] + small)
    require(text.perplexity is not None
            and all(np.isfinite(text.perplexity))
            and text.losses[-1] < text.losses[0],
            f"text run: losses {text.losses}, perplexity {text.perplexity}")
    gen_ex = load_example(root, "examples/transformer/generate_torch.py",
                          "generate_torch")
    res = gen_ex.main(["--checkpoint", str(ck), "--tokenizer",
                       str(ck / "bpe.json"), "--vocab",
                       str(text.cfg.vocab_size), "--prompt-text",
                       "ChainerMN", "--max-len", "128", "--batchsize", "4"]
                      + small, keep_logits=True)
    full = make_forward_fn(res.cfg, device=dev)(res.params,
                                                res.tokens[:, :-1].long())
    fwd = full[:, res.prompt.shape[1] - 1:]
    gerr = rel_err(res.logits, fwd)
    gagree = (res.logits.argmax(-1) == fwd.argmax(-1)).float().mean().item()
    print(f"lm data-parallel (e): text run {len(text.losses)} steps, "
          f"losses {text.losses[0]:.4f} -> {text.losses[-1]:.4f}, held-out "
          f"token/byte perplexity {text.perplexity[0]:.2f}/"
          f"{text.perplexity[1]:.2f}; generate_torch from its checkpoint: "
          f"decode vs full-forward logits rel L2 {gerr:.3e}, argmax "
          f"agreement {gagree:.4f}")
    require(gerr < 5e-2, f"decode logits off the full forward: {gerr}")
    metrics = dict(step_ms=modes, train_10_steps_s=train_s,
                   first_step_bitwise=bitwise, dots_bitwise_full=same,
                   launches_per_step=per_policy, losses=losses,
                   text_perplexity=text.perplexity,
                   seconds=time.perf_counter() - t_phase, card=smi)
    print(json.dumps({"lm_data_parallel": metrics}))
    return counts, metrics


def param_leaves(np, up):
    """The updater's parameters as numpy arrays, in tree order."""
    import torch.utils._pytree as pytree

    return [t.detach().float().cpu().numpy()
            for t in pytree.tree_leaves(up.params)]


def drift_child(device, out, spe, wire="bfloat16"):
    """One rank (under torchrun, or a one-rank world of its own) of the
    large-batch example ``--tiny`` on ``device`` for 3 epochs, TF32 off,
    its gradient wire ``wire`` (the example's bf16, or float32), built as
    the script builds it.  Rank 0 writes ``out/first.npz`` (the
    parameters after the first two updates, one window of two: double
    buffering's zeros, then the first mean gradient) and
    ``out/drift.json`` (the log, and whether the ranks' parameters were
    bitwise equal after each epoch)."""
    import hashlib

    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent
    ex = load_example(root,
                      "examples/imagenet/train_imagenet_large_batch_torch.py",
                      "train_imagenet_large_batch_torch")
    out = Path(out)
    argv = ["--tiny", "--steps-per-execution", str(spe), "--epoch", "3",
            "--grad-dtype", "" if wire == "float32" else wire,
            "--out", str(out)]
    run = ex.build(ex.parse_args(argv + (["--platform", "cpu"]
                                         if device == "cpu" else [])),
                   quiet=True)
    comm, record = run.comm, {"ranks_equal": []}

    def first_window(trainer):
        # after two updates, a window of two or two eager ones
        if "first" not in record and run.updater.iteration >= 2:
            record["first"] = run.updater.iteration
            if comm.rank == 0:
                np.savez(out / "first.npz", *param_leaves(np, run.updater))

    def ranks_agree(trainer):
        digest = hashlib.sha256(b"".join(
            a.tobytes() for a in param_leaves(np, run.updater))).hexdigest()
        record["ranks_equal"].append(len(set(comm.allgather_obj(digest)))
                                     == 1)

    run.trainer.extend(first_window, trigger=(1, "iteration"),
                       name="first_window")
    run.trainer.extend(ranks_agree, trigger=(1, "epoch"), name="ranks_agree")
    run.trainer.run()
    if comm.rank == 0:
        record["log"] = run.log.log
        record["world"] = comm.size
        (out / "drift.json").write_text(json.dumps(record))
    torch.distributed.destroy_process_group()
    return 0


def drift_compare(np, out, a, b):
    """``a``'s run against ``b``'s: the relative difference of each
    epoch's ``main/loss`` and ``validation/loss``, and the relative L2 of
    the parameters after the first window."""
    keys = ("main/loss", "validation/loss")
    ra = json.loads((out / a / "drift.json").read_text())
    rb = json.loads((out / b / "drift.json").read_text())
    diffs = [{k: abs(x[k] - y[k]) / max(abs(y[k]), 1e-12) for k in keys}
             for x, y in zip(ra["log"], rb["log"])]
    fa, fb = np.load(out / a / "first.npz"), np.load(out / b / "first.npz")
    num = sum(float(((fa[k] - fb[k]).astype(np.float64) ** 2).sum())
              for k in fa.files)
    den = sum(float((fb[k].astype(np.float64) ** 2).sum()) for k in fb.files)
    return dict(epoch_rel_diffs=diffs, first_window_rel_l2=(num / den) ** 0.5,
                epochs=(len(ra["log"]), len(rb["log"])),
                ranks_equal=(ra["ranks_equal"], rb["ranks_equal"]))


WITNESS_SEEDS = (0, 1, 2)
# the most a mean of four shares is off the exact mean by rounding, in
# ulps of its wire's type at the largest share (wire_witness_compare)
WITNESS_BOUND = {"bfloat16": 1.75, "float32": 1.25}


def witness_shares(np, shapes, rank, seed):
    """Rank ``rank``'s share of the exchange witness's tree ``seed``: a
    normal draw for each leaf of ``shapes``, each leaf at a scale of its
    own between 1e-3 and 1 (the same on every rank), in fp32."""
    scales = np.random.RandomState(seed).uniform(-3, 0, len(shapes))
    rng = np.random.RandomState(1000 * seed + 1 + rank)
    return [(rng.randn(*s) * 10.0 ** c).astype(np.float32)
            for s, c in zip(shapes, scales)]


def wire_witness_child(device, out):
    """One rank (under torchrun) of the exchange witness: the large-batch
    example's ``--tiny`` parameter tree (its leaf shapes, so its
    buckets) filled with :func:`witness_shares`, which differ by rank,
    and meaned by ``comm.multi_node_mean_grad`` as the example's
    optimizer calls it, over a bf16 wire and over an fp32 one.  Rank 0
    writes ``out/witness.npz`` (each mean) and ``out/witness.json`` (the
    shapes, and whether the ranks' means were bitwise equal)."""
    import hashlib

    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    root = Path(__file__).resolve().parent
    ex = load_example(root,
                      "examples/imagenet/train_imagenet_large_batch_torch.py",
                      "train_imagenet_large_batch_torch")
    run = ex.build(ex.parse_args(
        ["--tiny", "--out", str(out)]
        + (["--platform", "cpu"] if device == "cpu" else [])), quiet=True)
    comm = run.comm
    shapes = [list(t.shape) for t in pytree.tree_leaves(run.updater.params)]
    means, ranks_equal = {}, []
    for seed in WITNESS_SEEDS:
        mine = witness_shares(np, shapes, comm.rank, seed)
        for wire in ("bfloat16", "float32"):
            mean = comm.multi_node_mean_grad(
                [torch.as_tensor(a, device=comm.device) for a in mine],
                getattr(torch, wire))
            got = [t.cpu().numpy() for t in mean]
            digest = hashlib.sha256(
                b"".join(a.tobytes() for a in got)).hexdigest()
            ranks_equal.append(len(set(comm.allgather_obj(digest))) == 1)
            means.update({f"{seed}_{wire}_{i}": a for i, a in enumerate(got)})
    if comm.rank == 0:
        Path(out).mkdir(parents=True, exist_ok=True)
        np.savez(Path(out) / "witness.npz", **means)
        (Path(out) / "witness.json").write_text(json.dumps(dict(
            shapes=shapes, ranks_equal=ranks_equal, world=comm.size)))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def wire_witness_compare(np, out, names=("nccl", "gloo")):
    """The witness's means against the exact mean of the shares (in
    float64), each element in units of one ulp of the wire's type at the
    element's largest share G = max_r |g_r| (2^(e-7) for bf16, 2^(e-23)
    for fp32, where 2^e <= G < 2^(e+1)).  A sum of four shares in any
    order is off the exact sum by at most 7 such ulps: the four casts to
    the wire (a half ulp each) and three additions whose partial sums
    stay at most 2^(e+2), 2^(e+3) and 2^(e+3), where a rounding is off by
    at most 1, 2 and 2 ulps; the mean, a divide by four, by at most 1.75
    (:data:`WITNESS_BOUND`; 1.25 on the fp32 wire, which casts nothing).
    The ulp is taken at G, not at the mean, because shares of opposite
    signs cancel.  A fault (a share missing,
    a bucket misplaced, a wrong divisor) is off by a share's size, about
    G/4: 32 bf16 ulps.  Returns, for each wire, each name's largest
    error in those ulps, and the two names' largest difference, their
    share of differing elements and their relative L2."""
    z = {n: np.load(out / n / "witness.npz") for n in names}
    meta = {n: json.loads((out / n / "witness.json").read_text())
            for n in names}
    shapes, world = meta[names[0]]["shapes"], meta[names[0]]["world"]
    got = {}
    for wire, bits in (("bfloat16", 8), ("float32", 24)):
        worst = dict.fromkeys(names, 0.0)
        apart = differ = count = num = den = 0.0
        for seed in WITNESS_SEEDS:
            shares = [witness_shares(np, shapes, r, seed)
                      for r in range(world)]
            for i in range(len(shapes)):
                stack = np.stack([sh[i] for sh in shares]).astype(np.float64)
                exact = stack.mean(0)
                big = np.maximum(np.abs(stack).max(0),
                                 np.finfo(np.float32).tiny)
                ulp = 2.0 ** (np.floor(np.log2(big)) - (bits - 1))
                mean = {n: z[n][f"{seed}_{wire}_{i}"].astype(np.float64)
                        for n in names}
                for n in names:
                    worst[n] = max(worst[n],
                                   float((np.abs(mean[n] - exact)
                                          / ulp).max()))
                a, b = (mean[n] for n in names)
                apart = max(apart, float((np.abs(a - b) / ulp).max()))
                differ += float((a != b).sum())
                count += a.size
                num += float(((a - b) ** 2).sum())
                den += float((b ** 2).sum())
        got[wire] = dict(max_err_ulps=worst, max_apart_ulps=apart,
                         differing_share=differ / count,
                         rel_l2=(num / den) ** 0.5)
    got["ranks_equal"] = {n: meta[n]["ranks_equal"] for n in names}
    got["world"] = world
    return got


def phase_drift(np, root, smi):
    """14. Queue C's drift on one card: the large-batch example
    (``--tiny --steps-per-execution 2 --epoch 3``, TF32 off) on one NCCL
    rank and on one gloo rank on this machine's CPU.  Prints
    each epoch's relative loss differences and the relative L2 of the
    parameters after the first window, which must be under 1e-5."""
    import os

    out = root / "build" / "chip_smoke" / "drift"
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    seconds = {}
    # one after the other: the CPU run's threads would slow the card's
    # host side
    for name, device in (("nccl", "cuda"), ("gloo", "cpu")):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, __file__, "--drift-child", device,
                        str(out / name), "2"], check=True, timeout=300,
                       env=env)
        seconds[name] = time.perf_counter() - t0
    got = drift_compare(np, out, "nccl", "gloo")
    print(json.dumps({"drift_one_rank": dict(got, seconds=seconds,
                                             card=smi)}))
    require(got["epochs"] == (3, 3), f"epochs logged {got['epochs']}")
    require(got["first_window_rel_l2"] < 1e-5,
            f"first window off the CPU's: {got['first_window_rel_l2']}")
    return got


# the ring's pair schedule at full width: S virtual ranks on one card,
# the flagship's attention shape (bench_transformer.py:29,45-49)
SEQ_SHAPE = dict(S=4, B=8, T=2048, H=16, G=4, D=64)
# (layout, window) of phase 15 (a): both layouts, and a window that
# reaches back over two blocks of 512
SEQ_CASES = (("contiguous", None), ("zigzag", None), ("contiguous", 700))
# The ring's bf16 outputs against one kernel call over the whole
# sequence: both round o to bf16 once (2^-9 relative RMS) and p before
# P·V; the ring rounds each pair's o to bf16 before its fp32 merge, and
# autograd sums the pairs' bf16 gradients of one block (S-1 more bf16
# additions).  Against the fp32 plain ring (the einsum scan on the same
# bf16 values) the kernels' own bf16 roundings count too.
SEQ_O_REL = 1e-2
SEQ_GRAD_REL = 2e-2


def _ring_run(torch, fn, q, k, v, do):
    """``fn(q, k, v)`` and the gradients of ``sum(o · do)``."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(q, k, v)
    return [o.detach()] + list(torch.autograd.grad((o * do).sum(),
                                                   (q, k, v)))


def phase_seq_parallel(torch, np, root, smi):
    """15. The mesh's sequence axis on one card.  (a) The ring's pair
    schedule over ``S`` = 4 virtual ranks (every rank's ring body on
    this card, the visiting blocks read locally: ``simulate_ring``) at
    the flagship's attention shape, contiguous, zigzag and windowed:
    forward and the three gradients against one flash call over the
    whole sequence and against the plain ring (the einsum scan in
    fp32), and the kernels' launches against what the schedule
    predicts; timed against the whole-sequence call.  (b) The head
    groups Ulysses' kernel call sees after its exchange: each group's
    call (its query heads, its K/V heads broadcast to them) bitwise the
    whole-head call's slice, forward and backward; the exchange itself
    (``ulysses_attention`` over NCCL) runs only under ``--four-cards``,
    one card holding one rank.  (c) The flagship's ``make_train_step`` with
    ``attention="ring"`` at mesh ``seq=1`` on the one-rank NCCL world
    bitwise the ``attention="flash"`` step over 2 steps.  (d) The
    data-axis ``make_generate_fn`` on the same rank bitwise the plain
    one.  Returns the launch counts of (a) and (c) and the printed
    metrics."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_generate_fn,
        make_train_step, params_from_jax)
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel import (
        MeshConfig, broadcast_kv, simulate_ring, zigzag_indices)
    from chainermn_tpu_torch.parallel.ring_attention import ring_launches

    t_phase = time.perf_counter()
    S, B, T, H, G, D = (SEQ_SHAPE[k] for k in "S B T H G D".split())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, do = (torch.randn(B, T, H, D, device=dev, generator=gen,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, T, G, D, device=dev, generator=gen,
                        dtype=torch.bfloat16) for _ in range(2))
    metrics = dict(card=smi, shape=SEQ_SHAPE, ring={})
    counts = {}

    # (a) the ring's pair schedule against the whole-sequence call
    def whole(q, k, v, window):
        kb, vb = broadcast_kv(k, v, H // G)
        return fa(q, kb, vb, causal=True, window=window)

    for layout, window in SEQ_CASES:
        name = layout + ("" if window is None else f"_window{window}")
        perm = torch.as_tensor(zigzag_indices(S, T).reshape(-1),
                               device=dev) if layout == "zigzag" \
            else torch.arange(T, device=dev)
        lq, lk, lv, ldo = (t[:, perm].contiguous() for t in (q, k, v, do))
        kw = dict(S=S, causal=True, window=window, layout=layout)
        torch.cuda.synchronize()
        fa.launches = fa.dq_launches = fa.dkv_launches = 0  # path starts
        ring = _ring_run(torch, lambda a, b, c: simulate_ring(
            a, b, c, use_flash=True, **kw), lq, lk, lv, ldo)
        torch.cuda.synchronize()
        got = (fa.launches, fa.dq_launches, fa.dkv_launches)  # path ended
        n = ring_launches(S, T // S, causal=True, window=window,
                          layout=layout)
        counts["simulated_ring_" + name] = got
        require(got == (n, n, n), f"(a) {name}: launches {got}, the "
                f"schedule predicts {(n, n, n)}")
        one = [t[:, perm] for t in _ring_run(
            torch, lambda a, b, c: whole(a, b, c, window), q, k, v, do)]
        plain = _ring_run(torch, lambda a, b, c: simulate_ring(
            a, b, c, use_flash=False, remat=False, **kw),
            lq.float(), lk.float(), lv.float(), ldo.float())
        row = dict(launches=got, predicted=n, pairs_unmasked=S * S * (
            4 if layout == "zigzag" else 1))
        for ref_name, ref in (("whole_kernel", one), ("plain", plain)):
            for t_name, a, b, bar in zip(
                    ("o", "dq", "dk", "dv"), ring, ref,
                    (SEQ_O_REL,) + (SEQ_GRAD_REL,) * 3):
                rel = rel_err(a.float(), b.float())
                row[f"{t_name}_vs_{ref_name}_rel_l2"] = rel
                row[f"{t_name}_vs_{ref_name}_max_abs"] = (
                    a.float() - b.float()).abs().max().item()
                require(rel < bar, f"(a) {name}: {t_name} against the "
                        f"{ref_name}: relative L2 {rel:.3e} >= {bar}")
        del plain, one, ring
        # times: the whole schedule (every rank's body, one after the
        # other) against the one call, forward and forward + backward
        with torch.no_grad():
            row["ring_fwd_ms"] = cuda_ms(lambda: simulate_ring(
                lq, lk, lv, use_flash=True, **kw), reps=5, runs=3)
            row["whole_fwd_ms"] = cuda_ms(
                lambda: whole(q, k, v, window), reps=5, runs=3)
        row["ring_fwd_bwd_ms"] = cuda_ms(lambda: _ring_run(
            torch, lambda a, b, c: simulate_ring(a, b, c, use_flash=True,
                                                 **kw), lq, lk, lv, ldo),
            reps=3, runs=3)
        row["whole_fwd_bwd_ms"] = cuda_ms(lambda: _ring_run(
            torch, lambda a, b, c: whole(a, b, c, window), q, k, v, do),
            reps=3, runs=3)
        metrics["ring"][name] = row
        print(f"seq-parallel (a) {name}: the ring over {S} virtual ranks "
              f"at B={B} T={T} H={H} G={G} D={D} bf16: launches {got} "
              f"(predicted {n} of {row['pairs_unmasked']} pairs); o, dq, "
              f"dk, dv against the whole-sequence call rel L2 "
              + ", ".join(f"{row[t + '_vs_whole_kernel_rel_l2']:.3e}"
                          for t in ("o", "dq", "dk", "dv"))
              + "; against the fp32 plain ring "
              + ", ".join(f"{row[t + '_vs_plain_rel_l2']:.3e}"
                          for t in ("o", "dq", "dk", "dv"))
              + f"; forward {row['ring_fwd_ms']:.4f} ms against "
              f"{row['whole_fwd_ms']:.4f}, forward+backward "
              f"{row['ring_fwd_bwd_ms']:.4f} against "
              f"{row['whole_fwd_bwd_ms']:.4f} ms")
        del lq, lk, lv, ldo

    # (b) the head groups of Ulysses' kernel call: after the exchange
    # (not run here) rank j holds query heads [j·H/S, (j+1)·H/S) and
    # their K/V heads, broadcast to them; the kernels' outputs (o; dq,
    # dk, dv at query width) of each group against the whole-head call's
    kb, vb = broadcast_kv(k, v, H // G)

    def call(a, b, c):
        return fa(a, b, c, causal=True)

    whole_out = _ring_run(torch, call, q, kb, vb, do)
    hs = H // S
    same = True
    for j in range(S):
        sl = slice(j * hs, (j + 1) * hs)
        part = _ring_run(torch, call, q[:, :, sl], kb[:, :, sl],
                         vb[:, :, sl], do[:, :, sl])
        same &= all(bool(torch.equal(a, b[:, :, sl]))
                    for a, b in zip(part, whole_out))
    metrics["ulysses_groups_bitwise"] = same
    print(f"seq-parallel (b): the {S} head groups of Ulysses' kernel call "
          f"({hs} query heads each, their K/V broadcast; no exchange on "
          f"one card) against the whole-head call: the kernels' o, dq, "
          f"dk, dv bitwise: {same}")
    require(same, "(b) a head group's kernel output differs from the "
                  "whole-head call's")
    del whole_out, q, k, v, do, kb, vb

    # (c) the ring at mesh seq=1 on the one-rank NCCL world against the
    # flash step: the ring's single pair is the flash call
    comm = cmn.create_communicator(device=dev.type)
    mesh = MeshConfig(comm, data=1, seq=1)
    cfg = TransformerConfig(**dict(FLAGSHIP, remat=True))
    tree = init_numpy_params(cfg, SEED)
    rng = np.random.RandomState(SEED)
    toks = rng.randint(0, cfg.vocab_size, (8, cfg.max_seq + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    steps = {}
    for name, c, m in (("flash", cfg, None),
                       ("ring", dataclasses.replace(cfg, attention="ring"),
                        mesh)):
        params = params_from_jax(tree, cfg, dev)
        opt = training.adamw(3e-4)
        state = opt.init(params)
        step = make_train_step(c, opt, device=dev, mesh=m)
        torch.cuda.synchronize()
        fa.launches = fa.dq_launches = fa.dkv_launches = 0  # path starts
        losses = [step(params, state, x, y)[2] for _ in range(2)]
        torch.cuda.synchronize()
        if name == "ring":                                # path ended
            counts["seq1_ring_train"] = (fa.launches, fa.dq_launches,
                                         fa.dkv_launches)
        steps[name] = (losses, params)
        del state
    L = cfg.n_layers
    require(counts["seq1_ring_train"] == (4 * L, 2 * L, 2 * L),
            f"(c) launches over 2 steps {counts['seq1_ring_train']}, want "
            f"{(4 * L, 2 * L, 2 * L)}")
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(
        steps["ring"][0], steps["flash"][0])) and trees_equal(
        torch, steps["ring"][1], steps["flash"][1])
    metrics["seq1_ring_step_bitwise"] = bitwise
    metrics["seq1_losses"] = [v.item() for v in steps["ring"][0]]
    print(f"seq-parallel (c): the flagship's ring step at mesh seq=1 on one "
          f"NCCL rank against the flash step, 2 steps: losses "
          f"{metrics['seq1_losses']} vs "
          f"{[v.item() for v in steps['flash'][0]]}, bitwise {bitwise}; "
          f"launches {counts['seq1_ring_train']}")
    require(bitwise, "(c) the seq=1 ring step is not the flash step")
    params = steps["flash"][1]
    del steps

    # (d) the data axis of decoding on one rank against the plain one
    P, NEW = 128, 64
    prompts = rng.randint(0, cfg.vocab_size, (8, P))
    plain = make_generate_fn(cfg, max_len=P + NEW, device=dev)(params,
                                                              prompts)
    eos = int(plain[0, P + 10])
    kw = dict(max_len=P + NEW, eos_id=eos, with_row_state=True,
              device=dev)
    want = make_generate_fn(cfg, **kw)(params, prompts)
    got = make_generate_fn(cfg, mesh=mesh, **kw)(params, prompts)
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    metrics["dp_generate_bitwise"] = same
    print(f"seq-parallel (d): data-axis make_generate_fn on one NCCL rank "
          f"against the plain one, eos={eos}, gen_len "
          f"{got[2].tolist()}: tokens, done, gen_len bitwise {same}")
    require(same, "(d) data-axis decoding differs from the plain one")
    del params
    metrics["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"seq_parallel": metrics}))
    print(f"seq-parallel: phase {metrics['seconds']:.1f} s ({smi})")
    return counts, metrics


# phase 16 (a): the flagship's layer split over a model axis of TP_M
# members.  Each bar is a relative L2 error of the summed members' residual
# deltas against the whole layer's.  fp32, plain attention: the members'
# partial products summed in another order (~1e-7).  bf16 through the
# kernel: each member's residual output rounds to bf16 (2^-9 relative to
# the attention or MLP output, which outweighs the residual stream at
# init), four of them summed, against the whole layer's one rounding.
TP_M = 4
TP_SHAPE = dict(B=8, T=2048)
TP_LAYER_REL = {"float32": 1e-5, "bfloat16": 2e-2}
# (b) the vocab shards' fp32 logits, concatenated, against the whole
# head's: the same dot products, cuBLAS may tile them otherwise
TP_VOCAB_REL = 1e-6
# (c) vocab_parallel at model=1 against the replicated head: the same
# logits; the lse from an exp-sum and the head's backward from softmax -
# onehot, where log_softmax's autograd rounds otherwise.  In fp32 (plain
# attention on both sides) the two must agree to fp32's rounding; in
# bf16 the head's cotangent is cast to bf16 before its products, where
# such a rounding difference can flip an element by one ulp, and the
# flips run through the 24 layers' backward
TP_VP1_LOSS_REL = 1e-5
TP_VP1_GRAD_REL = {"float32": 1e-5, "bfloat16": 1e-2}


def phase_tensor_parallel(torch, np, root, smi):
    """16. The model axis on one card (run after phase 15, in its NCCL
    world).  (a) The flagship's layer at full width (B=8, T=2048) split
    by ``shard_params``'s split into ``TP_M`` members: each member's
    ``_attention`` and ``_mlp`` with a loopback model communicator (its
    row products then return the member's partial, the all-reduce's
    summand), the members' residual deltas summed against the whole
    layer's, in fp32 with plain attention and in bf16 through the
    kernel on each member's 4 query heads and 1 K/V head (its launches
    counted, one a member); each member's layer timed against the
    whole layer's.  (b) The ``TP_M`` vocab shards' fp32 logits slices
    (``_lm_head`` on each shard), concatenated, against the whole
    head.  (c) The flagship's step at ``MeshConfig(comm, data=1,
    model=1)`` through the model axis's code bitwise the plain step
    over 2 steps, and with ``vocab_parallel`` its loss and gradients
    against the replicated head's, in fp32 and in bf16.  Returns the
    launch counts of (a) and (c) and the printed metrics."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.communicators import LoopbackCommunicator
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_train_step,
        make_value_and_grad_fn, params_from_jax)
    from chainermn_tpu_torch.models.transformer import (
        _attention, _layer, _lm_head, _mlp, _rms_norm, _shard_tree)
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel import MeshConfig

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    loop = LoopbackCommunicator(device=dev)
    B, T = TP_SHAPE["B"], TP_SHAPE["T"]
    metrics = dict(card=smi, M=TP_M, shape=TP_SHAPE, layer={})
    counts = {}

    # (a) the layer's members against the whole layer
    one = TransformerConfig(**dict(FLAGSHIP, n_layers=1))
    params = params_from_jax(init_numpy_params(one, SEED), one, dev)
    rng = np.random.RandomState(SEED)
    toks = torch.as_tensor(rng.randint(0, one.vocab_size, (B, T)),
                           device=dev)
    members = [_shard_tree(one, params, TP_M, m) for m in range(TP_M)]
    for dtype, attention in (("float32", "local"), ("bfloat16", "flash")):
        cfg = dataclasses.replace(one, dtype=dtype, attention=attention)
        cd = cfg.compute_dtype
        h = (params["embed"][toks] + params["pos"][:T]).to(cd)

        def layer(p, h=h, cfg=cfg):
            blk = _layer(p, 0)
            a = _attention(cfg, h, blk, loop, loop)
            return a, _mlp(cfg, a, blk, loop, loop)[0]

        with torch.no_grad():
            a, m = layer(params)
            want = (a.float() - h.float(), m.float() - a.float())
            torch.cuda.synchronize()
            fa.launches = fa.dq_launches = fa.dkv_launches = 0  # starts
            parts = []
            for p in members:
                blk = _layer(p, 0)
                pa = _attention(cfg, h, blk, loop, loop)
                # each member's MLP reads the all-reduced attention output
                pm = _mlp(cfg, a, blk, loop, loop)[0]
                parts.append((pa.float() - h.float(), pm.float() - a.float()))
            torch.cuda.synchronize()
            got_counts = (fa.launches, fa.dq_launches,            # ended
                          fa.dkv_launches)
            got = [sum(p[i] for p in parts) for i in range(2)]
            row = dict(
                attention_rel_l2=rel_err(got[0], want[0]),
                mlp_rel_l2=rel_err(got[1], want[1]),
                attention_max_abs=(got[0] - want[0]).abs().max().item(),
                mlp_max_abs=(got[1] - want[1]).abs().max().item(),
                launches=got_counts,
                member_ms=cuda_ms(lambda: layer(members[0]), reps=3, runs=3),
                whole_ms=cuda_ms(lambda: layer(params), reps=3, runs=3))
        del parts, got, want, a, m
        metrics["layer"][dtype] = row
        bar = TP_LAYER_REL[dtype]
        print(f"tensor-parallel (a) {dtype}, {attention} attention: the "
              f"flagship's layer at B={B} T={T} as {TP_M} members' partials "
              f"against the whole layer: residual deltas rel L2 attention "
              f"{row['attention_rel_l2']:.3e}, MLP {row['mlp_rel_l2']:.3e} "
              f"(bar {bar}); launches {got_counts}; a member's layer "
              f"{row['member_ms']:.4f} ms, the whole layer "
              f"{row['whole_ms']:.4f} ms")
        for part in ("attention", "mlp"):
            require(row[f"{part}_rel_l2"] < bar,
                    f"(a) {dtype}: the members' {part} deltas off the whole "
                    f"layer's: {row[f'{part}_rel_l2']} >= {bar}")
        want_launches = (TP_M, 0, 0) if attention == "flash" else (0, 0, 0)
        require(got_counts == want_launches,
                f"(a) {dtype}: launches {got_counts}, want {want_launches}")
        if attention == "flash":
            counts["tp_layer_members"] = got_counts

    # (b) the vocab shards' logits against the whole head
    with torch.no_grad():
        hN = _rms_norm(torch.randn(
            h.shape, device=dev, generator=torch.Generator(
                device=dev).manual_seed(SEED)), params["ln_f"])
        whole = _lm_head(torch.float32, hN, params["embed"])
        vp = dataclasses.replace(one, vocab_parallel=True)
        sliced = torch.cat([_lm_head(torch.float32, hN, _shard_tree(
            vp, params, TP_M, m)["embed"], loop) for m in range(TP_M)],
            dim=-1)
        vrel = rel_err(sliced, whole)
        metrics["vocab_shards_rel_l2"] = vrel
        metrics["vocab_shards_max_abs"] = (sliced - whole).abs().max().item()
    print(f"tensor-parallel (b): {TP_M} vocab shards' fp32 logits (B={B} "
          f"T={T} V={one.vocab_size}) concatenated against the whole head: "
          f"rel L2 {vrel:.3e}, max abs {metrics['vocab_shards_max_abs']:.3e}"
          f" (bar {TP_VOCAB_REL})")
    require(vrel < TP_VOCAB_REL, f"(b) vocab shards off the whole head: "
            f"{vrel}")
    del whole, sliced, hN, h, members, params

    # (c) the model=1 mesh through the model axis's code on the one-rank
    # NCCL world: bitwise the plain step; vocab_parallel at model=1
    comm = cmn.create_communicator(device=dev.type)
    mesh = MeshConfig(comm, data=1, model=1)
    cfg = TransformerConfig(**dict(FLAGSHIP, remat=True))
    tree = init_numpy_params(cfg, SEED)
    toks = rng.randint(0, cfg.vocab_size, (8, cfg.max_seq + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    steps = {}
    for name, m in (("plain", None), ("model1", mesh)):
        params = params_from_jax(tree, cfg, dev, mesh=m)
        opt = training.adamw(3e-4)
        state = opt.init(params)
        step = make_train_step(cfg, opt, device=dev, mesh=m)
        torch.cuda.synchronize()
        fa.launches = fa.dq_launches = fa.dkv_launches = 0  # path starts
        losses = [step(params, state, x, y)[2] for _ in range(2)]
        torch.cuda.synchronize()
        if name == "model1":                              # path ended
            counts["tp_model1_train"] = (fa.launches, fa.dq_launches,
                                         fa.dkv_launches)
        steps[name] = (losses, params)
        del state
    L = cfg.n_layers
    require(counts["tp_model1_train"] == (4 * L, 2 * L, 2 * L),
            f"(c) launches over 2 steps {counts['tp_model1_train']}, want "
            f"{(4 * L, 2 * L, 2 * L)}")
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(
        steps["model1"][0], steps["plain"][0])) and trees_equal(
        torch, steps["model1"][1], steps["plain"][1])
    metrics["model1_step_bitwise"] = bitwise
    metrics["model1_losses"] = [v.item() for v in steps["model1"][0]]
    print(f"tensor-parallel (c): the flagship's step at mesh model=1 on one "
          f"NCCL rank against the plain step, 2 steps: losses "
          f"{metrics['model1_losses']} vs "
          f"{[v.item() for v in steps['plain'][0]]}, bitwise {bitwise}; "
          f"launches {counts['tp_model1_train']}")
    require(bitwise, "(c) the model=1 step is not the plain step")
    del steps
    metrics["vocab_parallel_model1"] = {}
    for dtype, attention in (("float32", "local"), ("bfloat16", "flash")):
        c = dataclasses.replace(cfg, dtype=dtype, attention=attention)
        params = params_from_jax(tree, c, dev)
        want = make_value_and_grad_fn(c, device=dev)(params, x, y)
        got = make_value_and_grad_fn(dataclasses.replace(
            c, vocab_parallel=True), mesh=mesh)(params, x, y)
        lrel = abs(got[0].item() - want[0].item()) / abs(want[0].item())
        grel = tree_rel_err(got[1], want[1])
        metrics["vocab_parallel_model1"][dtype] = dict(loss_rel=lrel,
                                                       grads_rel_l2=grel)
        bar = TP_VP1_GRAD_REL[dtype]
        print(f"tensor-parallel (c): vocab_parallel at model=1 against the "
              f"replicated head, {dtype}: loss {got[0].item():.6f} vs "
              f"{want[0].item():.6f} (rel {lrel:.3e}, bar "
              f"{TP_VP1_LOSS_REL}), gradients rel L2 {grel:.3e} (bar "
              f"{bar})")
        require(lrel < TP_VP1_LOSS_REL and grel < bar,
                f"(c) vocab_parallel at model=1, {dtype}: loss rel {lrel}, "
                f"gradients rel L2 {grel}")
        del params, got, want
    metrics["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"tensor_parallel_one_card": metrics}))
    print(f"tensor-parallel: phase {metrics['seconds']:.1f} s ({smi})")
    return counts, metrics


def tree_rel_err(a, b):
    """Relative L2 error of tree ``a`` against ``b`` over all leaves."""
    from chainermn_tpu_torch.training.optimizers import tree_leaves

    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    num = sum(((x - y).float().norm() ** 2).item() for x, y in pairs)
    return (num / sum((y.float().norm() ** 2).item()
                      for _, y in pairs)) ** 0.5


# phase 17: the pipe axis's schedules on one card (pipe=1) at the
# flagship's full width, 8 micro-batches of one row: (name, config fields)
PP_ONE = (("gpipe", dict(num_microbatches=8)),
          ("1f1b", dict(num_microbatches=8, pipeline_schedule="1f1b")),
          ("interleaved", dict(num_microbatches=8, virtual_pipe=2,
                               pipeline_schedule="interleaved")))
# bf16, eight micro-batches of one row against one batch of eight: the
# products run at other shapes (cuBLAS may tile and sum them otherwise)
# and the loss is the mean of eight means.  Through 24 layers such
# roundings reach the gradients as phase 16 (c)'s bf16 head did (6.25e-3)
PP_LOSS_REL, PP_GRAD_REL = 1e-3, 2e-2


def pp_predicted_launches(cfg, S, s, steps):
    """The flash kernels' launches ``(forward, dq, dk/dv)`` that
    ``steps`` training steps of ``cfg`` make on stage ``s`` of ``S``,
    counted from the schedule's tables: each forward slot runs the
    stage's (under ``virtual_pipe`` the chunk's) layers once; each
    backward slot runs them again (the 1F1B slot's recompute, GPipe's
    under remat) and then backward.  GPipe: ``M`` forward ticks and
    ``M`` reverse ones."""
    from chainermn_tpu_torch.parallel.pipeline import _interleaved_tables

    M, V = cfg.num_microbatches, cfg.virtual_pipe
    per_slot = cfg.n_layers // (S * V)
    if cfg.pipeline_schedule == "interleaved":
        _, f_act, _, _, b_act, *_ = _interleaved_tables(S, V, M)
        fwd, bwd = int(f_act[s].sum()), int(b_act[s].sum())
    elif cfg.pipeline_schedule == "1f1b":
        ticks = range(M + 2 * (S - 1))
        fwd = sum(0 <= t - s < M for t in ticks)
        bwd = sum(0 <= t - (2 * S - 2 - s) < M for t in ticks)
    else:
        fwd = bwd = M
    again = cfg.remat or cfg.pipeline_schedule != "gpipe"
    n = steps * bwd * per_slot
    return (steps * per_slot * (fwd + (bwd if again else 0)), n, n)


def pp_bubble(cfg, S):
    """The schedule's idle share of its ticks on one stage: ``(S-1)/(M+S-1)``
    for GPipe, ``2(S-1)/(M+2(S-1))`` for 1F1B, and the interleaved
    table's idle slots over its slots."""
    M, V = cfg.num_microbatches, cfg.virtual_pipe
    if cfg.pipeline_schedule == "gpipe":
        return (S - 1) / (M + S - 1)
    if cfg.pipeline_schedule == "1f1b":
        return 2 * (S - 1) / (M + 2 * (S - 1))
    from chainermn_tpu_torch.parallel.pipeline import _interleaved_tables

    T, f_act, _, _, b_act, *_ = _interleaved_tables(S, V, M)
    return 1 - (f_act[0].sum() + b_act[0].sum()) / (2 * T)


def blocks_in_layer_order(cfg, blocks, S):
    """Block leaves in the JAX layout grouped for ``S`` stages (and
    ``cfg.virtual_pipe`` chunks) as ``(L, ...)`` in global layer order."""
    from chainermn_tpu_torch.models import regroup_blocks

    return {k: v[0] for k, v in regroup_blocks(
        blocks, S, 1, cfg.virtual_pipe, 1).items()}


def phase_pipeline(torch, np, root, smi):
    """17. The pipe axis's schedules on one card (pipe=1), at the
    flagship's full width on one batch of 8 x 2048 tokens (bf16, full
    remat, ``adamw(3e-4)``): GPipe, 1F1B and interleaved (two virtual
    stages), each over 8 micro-batches of one row, through
    ``make_value_and_grad_fn`` and ``make_train_step``.  Each
    schedule's loss and gradients against the plain step's
    (``PP_LOSS_REL``, ``PP_GRAD_REL``); its flash launches over one step
    (counts set to 0 just before, read just after) against
    :func:`pp_predicted_launches` (``2·L·M`` forward, ``L·M`` dq and
    dk/dv); ms a step (the median of 3 after a warm-up) and peak
    GiB.  Returns the launch counts and the printed metrics."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_train_step,
        make_value_and_grad_fn, params_from_jax)
    from chainermn_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    base = TransformerConfig(**dict(FLAGSHIP, remat=True))
    rng = np.random.RandomState(SEED)
    toks = rng.randint(0, base.vocab_size, (8, base.max_seq + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    want_loss, want = make_value_and_grad_fn(base, device=dev)(
        params_from_jax(init_numpy_params(base, SEED), base, dev), x, y)
    metrics = dict(card=smi, B=8, T=base.max_seq, schedules={})
    counts = {}
    for name, extra in PP_ONE:
        cfg = dataclasses.replace(base, **extra)
        params = params_from_jax(init_numpy_params(cfg, SEED), cfg, dev)
        loss, grads = make_value_and_grad_fn(cfg, device=dev)(params, x, y)
        # the interleaved stack's (V, L/V) chunks in layer order
        grads["blocks"] = {k: v.reshape(want["blocks"][k].shape)
                           for k, v in grads["blocks"].items()}
        lrel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
        grel = tree_rel_err(grads, want)
        del grads
        opt = training.adamw(3e-4)
        state = opt.init(params)
        step = make_train_step(cfg, opt, device=dev)
        torch.cuda.synchronize()
        fa.launches = fa.dq_launches = fa.dkv_launches = 0  # path starts
        step(params, state, x, y)
        torch.cuda.synchronize()
        got = (fa.launches, fa.dq_launches, fa.dkv_launches)  # path ended
        counts[f"pp_{name}"] = got
        predicted = pp_predicted_launches(cfg, 1, 0, 1)
        times, peak, resident, losses = time_steps(torch, step, params,
                                                    state, x, y, n=3)
        ms = statistics.median(times)
        metrics["schedules"][name] = dict(
            M=cfg.num_microbatches, V=cfg.virtual_pipe, loss=loss.item(),
            plain_loss=want_loss.item(), loss_rel=lrel, grads_rel_l2=grel,
            launches=got, predicted=predicted, times_ms=times, ms=ms,
            tokens_per_s=8 * cfg.max_seq / ms * 1e3, peak_gib=peak,
            resident_gib=resident, losses=losses)
        print(f"pipeline (one card) {name}: M={cfg.num_microbatches} "
              f"V={cfg.virtual_pipe} at pipe=1: loss {loss.item():.6f} vs "
              f"the plain step's {want_loss.item():.6f} (rel {lrel:.3e}, bar "
              f"{PP_LOSS_REL}), gradients rel L2 {grel:.3e} (bar "
              f"{PP_GRAD_REL}); launches a step {got} (predicted "
              f"{predicted}); {ms:.2f} ms a step ({times}), peak "
              f"{peak:.2f} GiB")
        require(lrel < PP_LOSS_REL and grel < PP_GRAD_REL,
                f"{name}: loss rel {lrel}, gradients rel L2 {grel}")
        require(got == predicted,
                f"{name}: launches {got}, predicted {predicted}")
        require(all(np.isfinite(losses)), f"{name}: losses {losses}")
        del params, state, step
    metrics["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"pipeline_one_card": metrics}))
    print(f"pipeline (one card): phase {metrics['seconds']:.1f} s ({smi})")
    return counts, metrics


# phase 18 and --four-cards ep: the flagship with a Switch mixture of 8
# experts in every block (capacity factor 1.25), full remat, bf16
MOE = dict(FLAGSHIP, moe=True, n_experts=8, capacity_factor=1.25,
           remat=True)
# phase 18 (a): the MoE layer alone at the flagship's tokens a card
MOE_LAYER = dict(N=8 * 2048, D=1024, F=4096, E=8)
# the index path against the one-hot einsums: the same slots (bitwise)
# and the same expert products, so the outputs differ at most by the
# order of a top-2 token's two fp32 terms before its bf16 rounding
MOE_OUT_REL = 1e-2
# (b): the step's first loss against the plain-attention loss (bf16,
# local attention) on the same weights: attention's other roundings may
# flip a near-tie's expert, and a flipped token moves the mean by ~1e-5
MOE_LOSS_REL = 1e-2
# (c) and --four-cards ep: a grouping's losses against the one-card
# simulation of the same per-rank routing (first step, then later ones,
# as SEQ_LOSS_REL), and its per-layer drop totals: the first layer's
# equal, and each later one within 0.1 % of its assignments where the
# mesh does one card's arithmetic (products over other row counts may
# round otherwise and flip a near-tie).  Under a model axis the members'
# partial sums round otherwise at every layer, and at initialisation
# ~1 % of a layer's tokens sit within that rounding of a tie (up to 215
# of 16384 at expert=2,model=2 on H100s): only its first layer is held,
# within the same 0.1 %
EP_LOSS_REL = (1e-3, 5e-3, 5e-3)
EP_DROP_FRAC = 1e-3
# --four-cards ep's decoding at expert=4 (fp32, ample capacity): the
# logits against one card's
EP_LOGITS_REL = 1e-4


def moe_params(torch, cfg, dev, seed=SEED):
    """Seeded weights of ``cfg`` drawn on the card by torch's CUDA
    generator (the same numbers on every H100 for a seed), the whole
    tree in the port's layout at ``init_transformer``'s scales: drawing
    1.7 B numbers on the host would take longer than the steps."""
    from chainermn_tpu_torch.models.convert import _block_shapes, _top_shapes

    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=dev) * std

    L = cfg.n_layers
    blocks = {name: torch.ones((L, *shape), device=dev) if fan is None
              else normal((L, *shape), fan ** -0.5)
              for name, (shape, fan) in _block_shapes(cfg).items()}
    if cfg.virtual_pipe > 1:
        blocks = {k: v.reshape(cfg.virtual_pipe, -1, *v.shape[1:])
                  for k, v in blocks.items()}
    params = {"embed": normal(_top_shapes(cfg)["embed"], 0.02),
              "ln_f": torch.ones((cfg.d_model,), device=dev)}
    if cfg.pos_embedding == "learned":
        params["pos"] = normal((cfg.max_seq, cfg.d_model), 0.02)
    params["blocks"] = blocks
    return params


def moe_expert_fn(p, tokens):
    """The MoE layer's experts on their queues at once."""
    import torch

    return torch.relu(tokens @ p["w1"]) @ p["w2"]


def moe_layer_inputs(torch, dev, seed=SEED):
    """Phase 18 (a)'s seeded bf16 layer: tokens ``(N, D)`` with a
    component they share (so the experts' loads are uneven and some
    tokens are dropped, as in a model's hidden states), router ``(D,
    E)`` and experts ``w1 (E, D, F)``, ``w2 (E, F, D)``."""
    N, D, F, E = (MOE_LAYER[k] for k in "NDFE")
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=dev) * std

    x = (normal((N, D), 1.0) + normal((1, D), 0.5)).to(torch.bfloat16)
    return (x, normal((D, E), D ** -0.5).to(torch.bfloat16),
            {"w1": normal((E, D, F), D ** -0.5).to(torch.bfloat16),
             "w2": normal((E, F, D), F ** -0.5).to(torch.bfloat16)})


def moe_drops_by_layer(log, n_layers, group=1, first=0):
    """Dropped assignments a layer (``{layer: count}``) from a routing
    log whose calls ran layer after layer, ``n_layers`` of them from
    layer ``first`` on, once a micro-batch; a simulated grouping logs
    ``group`` routings a call."""
    out = {}
    for i, r in enumerate(log):
        layer = first + (i // group) % n_layers
        out[layer] = out.get(layer, 0) + int(r.dropped)
    return out


def phase_moe(torch, np, root, smi):
    """18. MoE at the flagship's full width on one card (bf16): (a) the
    layer alone (``MOE_LAYER``, 16384 tokens, 8 experts), top-1 and
    top-2 at capacity factor 1.25: the index dispatch's slots bitwise
    the one-hot einsum's (``_moe_dense_reference``), the outputs within
    ``MOE_OUT_REL``, the drop counts equal, both timed; (b) the
    flagship with ``moe=True`` (1.71 B parameters) trained through
    ``make_train_step`` (``adamw(3e-4)``, full remat) on 8 x 2048 tokens
    at top-1 and top-2: the first loss against the plain-attention
    loss, the flash launches of a step (counts set to 0 just before,
    read just after) against the dense step's (48, 24, 24), the drops a
    layer of a forward, ms a step, tokens/s and peak GiB; (c) expert=4
    simulated on this card (``SimulatedExpertAxis``): at ample capacity
    (``cf = E/k``) against the unsharded layer.  Returns the launch
    counts and the printed metrics."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, make_forward_fn, make_train_step)
    from chainermn_tpu_torch.models.transformer import lm_loss
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel import expert as ep

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()    # the step's peak is 51 GiB of the 80
    dev = torch.device("cuda")
    metrics = dict(card=smi, layer={}, step={}, simulated={})
    counts = {}
    x, rw, w = moe_layer_inputs(torch, dev)
    N, E = MOE_LAYER["N"], MOE_LAYER["E"]
    for k in (1, 2):
        ep.expert_parallel_moe.routings = log = []
        out, aux = ep.expert_parallel_moe(x, rw, w, moe_expert_fn,
                                          capacity_factor=1.25, top_k=k)
        ep.expert_parallel_moe.routings = None
        r = log[0]
        d_out, d_aux, d_slots = ep._moe_dense_reference(
            x, rw, w, moe_expert_fn, capacity_factor=1.25, top_k=k)
        slots_bitwise = bool(torch.equal(ep.dispatch(x, r), d_slots))
        # a kept slot holds a token's row, never all zero (normal rows)
        dense_dropped = N * k - int((d_slots.float().abs().sum(-1) > 0)
                                    .sum())
        del d_slots
        row = dict(C=r.capacity, dropped=int(r.dropped),
                   dense_dropped=dense_dropped, slots_bitwise=slots_bitwise,
                   out_rel_l2=rel_err(out, d_out),
                   out_bitwise=bool(torch.equal(out, d_out)),
                   aux=aux.item(), aux_abs_diff=abs(aux.item()
                                                    - d_aux.item()),
                   ms=cuda_ms(lambda: ep.expert_parallel_moe(
                       x, rw, w, moe_expert_fn, capacity_factor=1.25,
                       top_k=k), reps=5, runs=3),
                   dense_ms=cuda_ms(lambda: ep._moe_dense_reference(
                       x, rw, w, moe_expert_fn, capacity_factor=1.25,
                       top_k=k), reps=2, runs=3))
        del d_out
        metrics["layer"][f"top{k}"] = row
        print(f"moe (a) top-{k}: {N} tokens, {E} experts of {r.capacity} "
              f"slots: slots bitwise the one-hot einsum's "
              f"{slots_bitwise}, output rel L2 {row['out_rel_l2']:.3e} "
              f"(bar {MOE_OUT_REL}; bitwise {row['out_bitwise']}), drops "
              f"{row['dropped']} vs {dense_dropped}, aux {row['aux']:.6f}; "
              f"index path {row['ms']:.3f} ms, one-hot einsums "
              f"{row['dense_ms']:.3f} ms")
        require(slots_bitwise, f"(a) top-{k}: slots differ")
        require(row["out_rel_l2"] < MOE_OUT_REL,
                f"(a) top-{k}: output rel L2 {row['out_rel_l2']}")
        require(row["dropped"] == dense_dropped,
                f"(a) top-{k}: drops {row['dropped']} vs {dense_dropped}")
        # (c) four virtual ranks at ample capacity: the unsharded layer's
        cf = E / k
        whole, whole_aux = ep.expert_parallel_moe(
            x, rw, w, moe_expert_fn, capacity_factor=cf, top_k=k)
        sim, sim_aux = ep.simulate_expert_parallel(
            x, rw, w, moe_expert_fn, axis=ep.SimulatedExpertAxis(4),
            capacity_factor=cf, top_k=k)
        srow = dict(cf=cf, out_rel_l2=rel_err(sim, whole),
                    out_bitwise=bool(torch.equal(sim, whole)),
                    aux=sim_aux.item(), whole_aux=whole_aux.item())
        metrics["simulated"][f"top{k}"] = srow
        print(f"moe (c) top-{k}: expert=4 simulated at cf {cf:g} against "
              f"the unsharded layer: rel L2 {srow['out_rel_l2']:.3e} "
              f"(bitwise {srow['out_bitwise']}), aux {srow['aux']:.6f} vs "
              f"{srow['whole_aux']:.6f}")
        require(srow["out_rel_l2"] < MOE_OUT_REL,
                f"(c) top-{k}: simulated off the unsharded layer")
        del whole, sim, out
    del x, rw, w

    base = TransformerConfig(**MOE)
    toks = np.random.RandomState(SEED).randint(
        0, base.vocab_size, (8, base.max_seq + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    xt, yt = (torch.as_tensor(a, device=dev) for a in (x, y))
    for k in (1, 2):
        cfg = dataclasses.replace(base, router_top_k=k)
        # the same weights for each k: the seeded draw again
        params = moe_params(torch, cfg, dev)
        n_params = sum(p.numel() for p in params.values()
                       if torch.is_tensor(p))
        n_params += sum(p.numel() for p in params["blocks"].values())
        metrics["params_m"] = n_params / 1e6
        ep.expert_parallel_moe.routings = log = []
        make_forward_fn(cfg)(params, x)
        ep.expert_parallel_moe.routings = None
        drops = [int(r.dropped) for r in log]
        with torch.no_grad():
            ref = lm_loss(dataclasses.replace(cfg, attention="local",
                                              remat=False),
                          params, xt, yt).item()
        opt = training.adamw(3e-4)
        state = opt.init(params)
        step = make_train_step(cfg, opt)
        torch.cuda.synchronize()
        fa.launches = fa.dq_launches = fa.dkv_launches = 0  # path starts
        _, _, loss = step(params, state, x, y)
        torch.cuda.synchronize()
        got = (fa.launches, fa.dq_launches, fa.dkv_launches)  # path ended
        counts[f"moe_top{k}"] = got
        want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
        times, peak, resident, losses = time_steps(torch, step, params,
                                                    state, x, y, n=3)
        ms = statistics.median(times)
        lrel = abs(loss.item() - ref) / abs(ref)
        metrics["step"][f"top{k}"] = dict(
            loss=loss.item(), plain_attention_loss=ref, loss_rel=lrel,
            launches=got, dense_launches=want, drops_by_layer=drops,
            assignments_a_layer=8 * cfg.max_seq * k, times_ms=times, ms=ms,
            tokens_per_s=8 * cfg.max_seq / ms * 1e3, peak_gib=peak,
            resident_gib=resident, losses=losses)
        print(f"moe (b) top-{k}: {n_params / 1e6:.1f} M parameters, loss "
              f"{loss.item():.6f} vs plain attention's {ref:.6f} (rel "
              f"{lrel:.3e}, bar {MOE_LOSS_REL}); launches a step {got} "
              f"(the dense step's {want}); dropped a layer {drops} of "
              f"{8 * cfg.max_seq * k}; {ms:.2f} ms a step ({times}), "
              f"{8 * cfg.max_seq / ms * 1e3:.0f} tokens/s, peak "
              f"{peak:.2f} GiB, resident {resident:.2f} GiB")
        require(got == want, f"(b) top-{k}: launches {got}, want {want}")
        require(lrel < MOE_LOSS_REL, f"(b) top-{k}: loss rel {lrel}")
        require(all(np.isfinite(losses)), f"(b) top-{k}: {losses}")
        require(len(drops) == cfg.n_layers, f"(b): {len(drops)} routings")
        del params, state, step
        gc.collect()
        torch.cuda.empty_cache()
    metrics["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"moe_one_card": metrics}))
    print(f"moe (one card): phase {metrics['seconds']:.1f} s ({smi})")
    return counts, metrics


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

    smi = card_name()
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
    dp = phase_dp_resnet(torch, np, root, smi)
    phase_mnist(torch, np, root)

    # 9. checkpoint and resume, and a SIGKILL drill ---------------------
    phase_checkpoint(torch, np, root, smi)

    # 10. the host feed and 11. model parallelism, one NCCL rank --------
    _, images = phase_host_feed(torch, np, root, smi, dp)
    phase_model_parallel(torch, np, root, smi)

    # 12. the large-batch recipe, one NCCL rank --------------------------
    phase_large_batch(torch, np, root, smi, images)
    del images

    # 13. the flagship data-parallel through train_lm_torch.py ----------
    lm_counts, _ = phase_lm_data_parallel(torch, np, root, smi)

    # 15. the mesh's sequence axis on one card --------------------------
    seq_counts, _ = phase_seq_parallel(torch, np, root, smi)

    # 16. the mesh's model axis on one card -----------------------------
    tp_counts, _ = phase_tensor_parallel(torch, np, root, smi)

    # 19. ZeRO-1/2 and FSDP on one card, in the same NCCL world ---------
    from chainermn_tpu_torch.communicators import create_communicator

    zero_counts, _ = phase_zero(torch, np, root, smi, create_communicator())

    # 21. seq2seq, the convnets and the seq2seq example; 22. shard-only
    # sets, in the same NCCL world
    models_counts, _ = phase_models(torch, np, root, smi,
                                    create_communicator())
    phase_shard_only(torch, np, root, smi, create_communicator())

    # 23. the sinks and the live resize on one card, in the same world --
    phase_sinks_and_live(torch, np, root, smi, create_communicator())
    torch.distributed.destroy_process_group()

    # 17. the pipe axis's schedules on one card -------------------------
    pp_counts, _ = phase_pipeline(torch, np, root, smi)

    # 18. MoE at full width on one card ---------------------------------
    moe_counts, _ = phase_moe(torch, np, root, smi)

    # 20. the flagship's decode options on one card ---------------------
    decode_counts, _ = phase_decode_options(torch, np, smi)

    # 14. Queue C: the large-batch example on one card against the CPU --
    phase_drift(np, root, smi)

    src = "chainermn_tpu_torch/csrc/"
    tpu = "chainermn_tpu/ops/pallas_attention.py:"
    kernels = [
        dict(name="flash_fwd", route="cuda", source=src + "flash_fwd.cu",
             replaces=tpu + "65", launches=counts["flash_fwd"],
             launches_by_path=dict(scoring=launches,
                                   training=counts["flash_fwd"],
                                   lm_data_parallel=lm_counts["flash_fwd"],
                                   **{f"seq_{p}": c[0] for p, c in
                                      seq_counts.items()},
                                   **{p: c[0] for p, c in
                                      tp_counts.items()},
                                   **{p: c[0] for p, c in
                                      pp_counts.items()},
                                   **{p: c[0] for p, c in
                                      moe_counts.items()},
                                   **{p: c[0] for p, c in
                                      zero_counts.items()},
                                   decode_options=decode_counts[0],
                                   models=models_counts[0]),
             matched=True, **row),
        dict(name="flash_bwd_dq", route="cuda", source=src + "flash_bwd.cu",
             replaces=tpu + "151", launches=counts["flash_bwd_dq"],
             launches_by_path=dict(
                 training=counts["flash_bwd_dq"],
                 lm_data_parallel=lm_counts["flash_bwd_dq"],
                 **{f"seq_{p}": c[1] for p, c in seq_counts.items()},
                 **{p: c[1] for p, c in tp_counts.items()},
                 **{p: c[1] for p, c in pp_counts.items()},
                 **{p: c[1] for p, c in moe_counts.items()},
                 **{p: c[1] for p, c in zero_counts.items()},
                 decode_options=decode_counts[1],
                 models=models_counts[1]),
             matched=True, **bwd_rows["dq"]),
        dict(name="flash_bwd_dkv", route="cuda",
             source=src + "flash_bwd.cu", replaces=tpu + "195",
             launches=counts["flash_bwd_dkv"],
             launches_by_path=dict(
                 training=counts["flash_bwd_dkv"],
                 lm_data_parallel=lm_counts["flash_bwd_dkv"],
                 **{f"seq_{p}": c[2] for p, c in seq_counts.items()},
                 **{p: c[2] for p, c in tp_counts.items()},
                 **{p: c[2] for p, c in pp_counts.items()},
                 **{p: c[2] for p, c in moe_counts.items()},
                 **{p: c[2] for p, c in zero_counts.items()},
                 decode_options=decode_counts[2],
                 models=models_counts[2]),
             matched=True, **bwd_rows["dkv"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def two_stage_rank():
    """One rank of ``--four-cards``' cross-rank checks (under torchrun):
    the world split 2 x 2 (a node's communicator and the nodes'), every
    bucket form against the flat all-reduce on multiples of 1/8, whose
    sums are exact in any order; then a captured window across the four
    ranks.  Rank 0 prints the verdicts."""
    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.ops import fused

    comm = cmn.create_communicator()
    r = comm.rank
    require(comm.size == 4, f"--two-stage-rank wants 4 ranks, {comm.size}")
    intra, inter = comm.split(r // 2, r % 2), comm.split(r % 2, r // 2)
    rng = np.random.RandomState(r)
    tree = {k: torch.tensor(rng.randint(-64, 65, s) / 8, dtype=torch.float32,
                            device=comm.device)
            for k, s in (("a", (301, 7)), ("b", (4097,)), ("c", (3,)))}
    bf16 = torch.bfloat16
    flat = comm.multi_node_mean_grad(pytree.tree_map(torch.clone, tree),
                                     bf16)
    sched = fused.build_overlap_schedule(tree, 4096, bf16)
    forms = dict(
        two_stage=fused.fused_allreduce(pytree.tree_map(torch.clone, tree),
                                        intra, wire_dtype=bf16,
                                        inter_comm=inter),
        overlap_rs=fused.overlap_exchange(tree, comm, schedule=sched,
                                          wire_dtype=bf16),
        overlap_two_stage=fused.overlap_exchange(
            tree, intra, schedule=sched, wire_dtype=bf16, inter_comm=inter))
    verdicts = {k: all(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(v), pytree.tree_leaves(flat)))
        for k, v in forms.items()}
    verdicts = comm.allgather_obj(verdicts)
    if r == 0:
        print(json.dumps({"two_stage_2x2": verdicts}))
    require(all(all(v.values()) for v in verdicts), f"forms {verdicts}")

    # a captured window across the ranks: an MLP on each rank's own rows,
    # momentum SGD, a bf16 wire, double buffering, two updates of two
    # microbatches a window, three windows (warm-up, capture and replay,
    # replay) against twelve eager microbatches.  Bitwise the eager run
    # on every rank, and the ranks' parameters equal (the captured
    # exchange crossed the ranks; each rank's data differs)
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import (
        init_mlp_numpy, mlp_apply, mlp_params_from_jax,
        softmax_cross_entropy)

    rng = np.random.RandomState(10 + r)
    xs = rng.randn(64, 16).astype(np.float32)
    ys = rng.randint(0, 4, 64).astype(np.int32)

    def job(spe):
        opt = cmn.create_multi_node_optimizer(
            training.sgd(0.1, momentum=0.9), comm, double_buffering=True,
            allreduce_grad_dtype=bf16)
        return training.StandardUpdater(
            SerialIterator((xs, ys), 8, shuffle=True, seed=1), opt,
            lambda p, x, y: softmax_cross_entropy(mlp_apply(p, x), y),
            mlp_params_from_jax(init_mlp_numpy([16, 32, 4], 0),
                                comm.device),
            comm, steps_per_execution=spe, accum_steps=2)

    graph, eager = job(2), job(1)
    start = [t.detach().clone() for t in pytree.tree_leaves(graph.params)]
    for _ in range(3):
        graph.update()
    for _ in range(6):
        eager.update()
    window = next(iter(graph._windows.values()))
    mine = [t.detach().cpu().numpy()
            for t in pytree.tree_leaves(graph.params)]
    ranks = comm.allgather_obj(mine)
    window_checks = dict(
        graph=graph.graphs and window.graph is not None
        and window.replays == 2,
        bitwise_eager=all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(graph.params),
            pytree.tree_leaves(eager.params))),
        ranks_agree=all(np.array_equal(a, b) for other in ranks
                        for a, b in zip(mine, other)),
        moved=not all(torch.equal(a, b) for a, b in zip(
            start, pytree.tree_leaves(graph.params))))
    window_checks = comm.allgather_obj(window_checks)
    if r == 0:
        print(json.dumps({"window_graph_4_ranks": window_checks}))
    require(all(all(v.values()) for v in window_checks),
            f"captured window across ranks: {window_checks}")
    # no reference to a captured window may outlive finalize(): NCCL
    # does not destroy a communicator while a graph holds its
    # collectives
    del window
    graph.finalize()
    eager.finalize()
    torch.distributed.destroy_process_group()
    return 0


def lm_rank(out):
    """One rank (under torchrun) of the flagship through
    ``train_lm_torch.py`` at 8 x 2048 tokens a rank for 5 steps: each
    step timed (host clock around a synchronised step, the exchange
    included, as phase 6), the
    ranks' parameters compared bitwise after every step (all-reduced
    max and min of their int32 views), and, on several ranks, the first
    loss against rank 0's loss of the whole global batch on one card.
    Rank 0 writes ``out/lm.json``."""
    import os

    import torch
    import torch.utils._pytree as pytree

    from chainermn_tpu_torch.models import lm_loss

    root = Path(__file__).resolve().parent
    ex = load_example(root, "examples/transformer/train_lm_torch.py",
                      "train_lm_torch")
    n = int(os.environ["WORLD_SIZE"])
    steps = 5
    run = ex.build(ex.parse_args(FLAGSHIP_ARGV + [
        "--batchsize", str(8 * n), "--steps", str(steps)]), quiet=True)
    comm, cfg, dev = run.comm, run.cfg, run.comm.device
    batches = [(torch.as_tensor(x), torch.as_tensor(y))
               for x, y in run.batches]
    ref = None
    if n > 1 and comm.rank == 0:
        # the same rows through one card, before any update
        with torch.no_grad():
            ref = lm_loss(cfg, run.params, batches[0][0].to(dev),
                          batches[0][1].to(dev)).item()
    comm.barrier()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    times, losses, equal = [], [], []
    for x, y in batches:
        comm.barrier()
        t0 = time.perf_counter()
        run.params, run.opt_state, loss = run.step(run.params,
                                                   run.opt_state, x, y)
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        same = True
        for t in pytree.tree_leaves(run.params):
            bits = t.detach().view(torch.int32)
            same &= bool(torch.equal(comm.allreduce(bits, "max"),
                                     comm.allreduce(bits, "min")))
        equal.append(same)
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    if comm.rank == 0:
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "lm.json").write_text(json.dumps(dict(
            world=n, rows_per_rank=8, tokens_per_rank=8 * cfg.max_seq,
            times_ms=times, losses=losses, one_card_first_loss=ref,
            ranks_equal=equal, peak_gib=peak,
            steady_ms=statistics.median(times[1:]))))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def four_cards(root, smi):
    """``--four-cards``.  First the exchange's witness: seeded shares of
    the large-batch example's gradient tree meaned over a bf16 and an
    fp32 wire on 4 NCCL ranks and on 4 gloo ranks, every element within
    the rounding bound of the exact mean (:func:`wire_witness_compare`)
    and the ranks' means bitwise equal.  Then Queue C's check of the
    large-batch example
    (``--tiny``, 3 epochs, TF32 off) on 4 NCCL ranks, its window
    captured (``--steps-per-execution 2``) and eager, and on 4 gloo ranks
    on this machine's CPU, with the example's bf16 gradient wire and
    with an fp32 one: the parameters after the first window within 1e-5
    relative L2 of gloo's, and the 4 ranks' parameters bitwise equal
    after every epoch.  With the bf16 wire each epoch's loss differences
    are reported, not held: a bf16 sum of four shares rounds differently
    in NCCL's order and in gloo's, and over the LARS updates of a BN
    network that grows to 1e-4-scale; with the fp32 wire the losses are
    held to 1e-4 relative at every epoch.  Then the two-stage exchange
    as 2 x 2 over ``split`` and a captured window across the 4 ranks
    (:func:`two_stage_rank`), and the flagship through
    ``train_lm_torch.py`` on 4 ranks and on 1 (8 x 2048 tokens a rank, 5
    steps, :func:`lm_rank`): ranks bitwise after every step, the first
    loss against one card's, and the weak-scaling efficiency.  Needs four
    cards; prints JSON lines."""
    import os

    import numpy as np

    out = root / "build" / "four_cards"
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    me = str(Path(__file__).resolve())
    run4 = ["torchrun", "--standalone", "--nproc_per_node", "4", me]
    # each run ends with destroy_process_group: a captured window left
    # alive there would keep NCCL waiting, so a hang fails at its limit
    seconds = {}
    # first the exchange alone: the same seeded shares meaned over a
    # bf16 and an fp32 wire on 4 NCCL and on 4 gloo ranks, each element
    # held to the rounding bound of a four-share mean (wire_witness_compare)
    for name, device in (("nccl", "cuda"), ("gloo", "cpu")):
        t0 = time.perf_counter()
        subprocess.run(run4 + ["--wire-witness", device,
                               str(out / "witness" / name)],
                       check=True, timeout=180, env=env)
        seconds[f"witness_{name}"] = time.perf_counter() - t0
    witness = wire_witness_compare(np, out / "witness")
    print(json.dumps({"wire_witness_4_ranks": dict(witness, card=smi)}))
    require(all(all(v) for v in witness["ranks_equal"].values()),
            f"witness: the ranks' means differ: {witness['ranks_equal']}")
    for wire, bound in WITNESS_BOUND.items():
        require(all(e <= bound for e in
                    witness[wire]["max_err_ulps"].values()),
                f"witness, {wire} wire: a mean is off the exact one by "
                f"more than rounding: {witness[wire]}")
    for name, device, spe, wire in (
            ("nccl", "cuda", "2", "bfloat16"),
            ("nccl_eager", "cuda", "1", "bfloat16"),
            ("gloo", "cpu", "2", "bfloat16"),
            ("nccl_fp32_wire", "cuda", "2", "float32"),
            ("gloo_fp32_wire", "cpu", "2", "float32")):
        t0 = time.perf_counter()
        subprocess.run(run4 + ["--drift-child", device, str(out / name), spe,
                               wire], check=True, timeout=180, env=env)
        seconds[name] = time.perf_counter() - t0
    got = {name: drift_compare(np, out, name, "gloo")
           for name in ("nccl", "nccl_eager")}
    got["graph_vs_eager"] = drift_compare(np, out, "nccl", "nccl_eager")
    got["fp32_wire"] = drift_compare(np, out, "nccl_fp32_wire",
                                     "gloo_fp32_wire")
    print(json.dumps({"four_cards": dict(got, seconds=seconds, card=smi)}))
    for name in ("nccl", "nccl_eager", "fp32_wire"):
        g = got[name]
        require(g["epochs"] == (3, 3), f"{name}: epochs {g['epochs']}")
        require(g["first_window_rel_l2"] < 1e-5,
                f"{name}: first window off gloo's by "
                f"{g['first_window_rel_l2']}")
        require(all(g["ranks_equal"][0]) and len(g["ranks_equal"][0]) == 3,
                f"{name}: ranks' parameters differ: {g['ranks_equal']}")
    # without the bf16 wire's sum order the card and the CPU agree over
    # the 3 epochs (within 1.0e-6 measured on four H100s)
    wire32 = [d for e in got["fp32_wire"]["epoch_rel_diffs"]
              for d in e.values()]
    require(max(wire32) < 1e-4, f"fp32 wire: losses differ: {wire32}")
    subprocess.run(run4 + ["--two-stage-rank"], check=True, timeout=120)

    lm = {}
    for n in (4, 1):
        subprocess.run(["torchrun", "--standalone", "--nproc_per_node",
                        str(n), me, "--lm-rank", str(out / f"lm{n}")],
                       check=True, timeout=300)
        lm[n] = json.loads((out / f"lm{n}" / "lm.json").read_text())
    four, one = lm[4], lm[1]
    first_rel = abs(four["losses"][0] - four["one_card_first_loss"]) \
        / abs(four["one_card_first_loss"])
    eff = one["steady_ms"] / four["steady_ms"]
    per_card = four["tokens_per_rank"] / four["steady_ms"] * 1e3
    print(json.dumps({"lm_four_cards": dict(
        four_ranks=four, one_rank=one, first_loss_rel_diff=first_rel,
        tokens_per_s_per_card=dict(
            four=per_card,
            one=one["tokens_per_rank"] / one["steady_ms"] * 1e3),
        weak_scaling_efficiency=eff, card=smi)}))
    require(all(four["ranks_equal"]) and len(four["ranks_equal"]) == 5,
            f"ranks' parameters differ: {four['ranks_equal']}")
    require(first_rel < 1e-3, f"first loss {four['losses'][0]} against one "
            f"card's {four['one_card_first_loss']}: {first_rel}")
    require(all(np.isfinite(four["losses"])), f"losses {four['losses']}")
    return 0


# --four-cards' sequence axis: the flagship's step on 4 ranks under each
# mesh and attention, against one card's flash step on the same global
# batch (name, mesh, attention, layout)
SEQ_FOUR = (("ring_contiguous", "seq=4", "ring", "contiguous"),
            ("ring_zigzag", "seq=4", "ring", "zigzag"),
            ("ulysses", "seq=4", "ulysses", "contiguous"),
            ("data2_seq2_ring", "data=2,seq=2", "ring", "contiguous"))
SEQ_STEPS = 3
# bf16 steps of one model on one batch, the attention split otherwise:
# the first loss differs by the forward's roundings (the pairs' bf16
# outputs merged, against one call), the later ones also by the
# updates' (AdamW's first steps move each weight by about lr, whatever
# its gradient's last bits)
SEQ_LOSS_REL = (1e-3, 5e-3, 5e-3)


def _mesh_axes(spec):
    return {k: int(v) for k, v in (p.split("=") for p in spec.split(","))}


def seq_predicted_launches(cfg, mesh, steps):
    """The flash kernels' launches ``(forward, dq, dk/dv)`` that
    ``steps`` training steps of ``cfg`` make on this rank of ``mesh``:
    each layer runs its attention core once forward, again in the remat
    recompute (the checkpoint reruns the whole block), and once
    backward; the core launches this rank's share of the ring's live
    pairs (``ring_launches(rank=)``), or one call (flash, Ulysses)."""
    from chainermn_tpu_torch.parallel.ring_attention import ring_launches

    S = mesh.axis_size("seq")
    n = 1
    if cfg.attention == "ring":
        n = ring_launches(S, cfg.max_seq // S, causal=True,
                          window=cfg.attention_window or None,
                          layout=cfg.seq_layout,
                          rank=mesh.axis_index("seq"))
    n *= steps * cfg.n_layers
    return ((2 if cfg.remat else 1) * n, n, n)


def seq_rank(out, name, mesh_spec, attention, layout, vocab_parallel="0",
             loss_chunk="0"):
    """One rank (under torchrun) of the flagship's step over a mesh with
    a seq or a model axis: 8 x 2048 tokens globally (the same batch on
    every mesh), ``SEQ_STEPS`` steps, each timed (host clock around a
    synchronised step) and the ranks' parameters compared bitwise after
    it (the all-reduced max and min of their int32 views): every leaf
    across the batch-like group, and the leaves replicated over the
    model axis (the norm scales, ``pos``, ``embed`` without
    ``vocab_parallel``) across the model group too.  The flash kernels'
    launch counts are set to 0 just before the steps and read just
    after, on every rank, beside what :func:`seq_predicted_launches`
    predicts.  Then one more step is traced on every rank
    (``profile_port.trace``: wall, device busy time, idle share, time by
    kind of kernel).  Rank 0 writes ``out/seq.json`` with every rank's
    counts and trace."""
    import numpy as np
    import torch

    import chainermn_tpu_torch as cmn
    import profile_port
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_train_step,
        params_from_jax)
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel import MeshConfig, zigzag_indices
    from chainermn_tpu_torch.parallel.mesh import BATCH_AXES
    from chainermn_tpu_torch.testing import replicas_bitwise

    comm = cmn.create_communicator()
    mesh = MeshConfig(comm, **_mesh_axes(mesh_spec))
    cfg = TransformerConfig(**dict(
        FLAGSHIP, attention=attention, seq_layout=layout, remat=True,
        vocab_parallel=vocab_parallel == "1", loss_chunk=int(loss_chunk)))
    params = params_from_jax(init_numpy_params(cfg, SEED), cfg,
                             comm.device, mesh=mesh)
    model, batch = mesh.comm("model"), mesh.comm(*BATCH_AXES)
    replicated = [params[k] for k in params if k != "blocks" and not (
        k == "embed" and cfg.vocab_parallel)] + [
        params["blocks"]["ln1"], params["blocks"]["ln2"]]
    opt = training.adamw(3e-4)
    state = opt.init(params)
    toks = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (8, cfg.max_seq + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    if layout == "zigzag":
        perm = zigzag_indices(mesh.axis_size("seq"), cfg.max_seq).reshape(-1)
        x, y = x[:, perm], y[:, perm]
    step = make_train_step(cfg, opt, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    times, losses, equal = [], [], []
    torch.cuda.synchronize()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0      # path starts
    for _ in range(SEQ_STEPS):
        comm.barrier()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        equal.append(
            replicas_bitwise(batch, params)
            and replicas_bitwise(model, replicated))
    torch.cuda.synchronize()
    mine = dict(rank=comm.rank, coords=mesh.coords,                # ended
                launches=(fa.launches, fa.dq_launches, fa.dkv_launches),
                predicted=seq_predicted_launches(cfg, mesh, SEQ_STEPS))
    peak = torch.cuda.max_memory_allocated() / 2**30
    comm.barrier()
    mine["trace"] = profile_port.trace(
        torch, lambda: step(params, state, x, y), name, warm=False,
        show=False)
    ranks = comm.allgather_obj(mine)
    if comm.rank == 0:
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "seq.json").write_text(json.dumps(dict(
            name=name, mesh=mesh.shape, attention=attention, layout=layout,
            vocab_parallel=cfg.vocab_parallel, loss_chunk=cfg.loss_chunk,
            world=comm.size, tokens=8 * cfg.max_seq, times_ms=times,
            losses=losses, ranks_equal=equal, peak_gib=peak, ranks=ranks)))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def seq_decode_rank(out):
    """One rank (under torchrun, 4 ranks) of decoding over mesh data=2,
    seq=2 with the seq-KV cache: the flagship in fp32 (8 prompts of 128
    tokens, 64 new), each data member its 4 rows, each seq member half
    of the cache; rank 0 also decodes the whole batch alone on its card,
    and writes ``out/decode.json``: the tokens of both and the one
    card's top-2 logit gap at each step."""
    import numpy as np
    import torch

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_generate_fn,
        params_from_jax)
    from chainermn_tpu_torch.parallel import MeshConfig

    comm = cmn.create_communicator()
    mesh = MeshConfig(comm, data=2, seq=2)
    cfg = TransformerConfig(**dict(FLAGSHIP, dtype="float32"))
    params = params_from_jax(init_numpy_params(cfg, SEED), cfg,
                             comm.device)
    P, NEW = 128, 64
    prompts = np.random.RandomState(SEED + 1).randint(
        0, cfg.vocab_size, (8, P))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = make_generate_fn(cfg, max_len=P + NEW, mesh=mesh)(params,
                                                             prompts)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rows = np.concatenate(mesh.comm("data").allgather_obj(
        toks.cpu().numpy()))
    if comm.rank == 0:
        one, logits = make_generate_fn(cfg, max_len=P + NEW,
                                       with_logits=True,
                                       device=comm.device)(params, prompts)
        top2 = logits.topk(2, dim=-1).values
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "decode.json").write_text(json.dumps(dict(
            mesh=mesh.shape, seq_kv=rows.tolist(),
            one_card=one.cpu().numpy().tolist(),
            gap=(top2[..., 0] - top2[..., 1]).cpu().numpy().tolist(),
            prompt=P, ms=ms)))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _four_card_steps(out, runs):
    """Each of ``runs`` (name, mesh, attention, layout, and for
    :func:`seq_rank` the vocab_parallel and loss_chunk flags) under
    torchrun on 4 ranks, after one card's flash step
    (``one_card_flash``): every rank's flash launches held to what
    :func:`seq_predicted_launches` predicts, each mesh's ranks bitwise
    after every step, its losses finite and within ``SEQ_LOSS_REL`` of
    one card's.  Returns the runs' results, the report of each mesh (ms
    a step, the median of steps 2-3; tokens/s a card) and the launches
    by path."""
    import numpy as np

    me = str(Path(__file__).resolve())
    res = {}
    for name, mesh, attention, layout, *extra in (
            ("one_card_flash", "data=1", "flash", "contiguous"),) + runs:
        n = 1 if name == "one_card_flash" else 4
        subprocess.run(["torchrun", "--standalone", "--nproc_per_node",
                        str(n), me, "--seq-rank", str(out / name), name,
                        mesh, attention, layout, *extra], check=True,
                       timeout=300)
        res[name] = json.loads((out / name / "seq.json").read_text())
    one = res["one_card_flash"]
    report = {}
    for name, r in res.items():
        # every rank's launches on the path: what its schedule predicts
        got = {q["rank"]: q["launches"] for q in r["ranks"]}
        want = {q["rank"]: q["predicted"] for q in r["ranks"]}
        require(got == want, f"{name}: flash launches (forward, dq, "
                f"dk/dv) by rank {got}, the schedule predicts {want}")
    launches_by_path = {name: {q["rank"]: q["launches"] for q in
                               r["ranks"]} for name, r in res.items()}
    for name, *_ in runs:
        r = res[name]
        rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                   one["losses"])]
        ms = statistics.median(r["times_ms"][1:])
        report[name] = dict(
            r, loss_rel_diff=rel, steady_ms=ms,
            tokens_per_s_per_card=r["tokens"] / ms * 1e3 / r["world"],
            one_card_steady_ms=statistics.median(one["times_ms"][1:]))
        require(all(r["ranks_equal"]) and len(r["ranks_equal"])
                == SEQ_STEPS, f"{name}: ranks differ: {r['ranks_equal']}")
        require(all(np.isfinite(r["losses"])), f"{name}: {r['losses']}")
        require(all(e < bar for e, bar in zip(rel, SEQ_LOSS_REL)),
                f"{name}: losses {r['losses']} against one card's "
                f"{one['losses']}: relative {rel}, bars {SEQ_LOSS_REL}")
    return res, report, launches_by_path


def four_cards_seq(root, smi):
    """``--four-cards``' sequence axis: the flagship's step at full width
    on the same global batch (8 x 2048 tokens) under each of
    ``SEQ_FOUR`` on 4 ranks, and one card's flash step; each mesh's
    losses within ``SEQ_LOSS_REL`` of one card's, its ranks' parameters
    bitwise equal after every step, and every rank's flash launches
    those the schedule predicts; ms a step and tokens/s a card, and
    each rank's traced step.
    Then decoding at data=2, seq=2 with the seq-KV cache (fp32) against
    one card's ``generate``: every row's tokens equal up to the first
    step whose one-card top-2 logit gap is a near-tie (below 1e-3)."""
    import numpy as np

    from chainermn_tpu_torch import _build

    out = root / "build" / "four_cards" / "seq"
    me = str(Path(__file__).resolve())
    _build.build_all()          # once, before the children load them
    res, report, launches_by_path = _four_card_steps(out, SEQ_FOUR)
    one = res["one_card_flash"]
    subprocess.run(["torchrun", "--standalone", "--nproc_per_node", "4",
                    me, "--seq-decode", str(out / "decode")], check=True,
                   timeout=300)
    dec = json.loads((out / "decode" / "decode.json").read_text())
    P = dec["prompt"]
    seq_kv, one_card = np.asarray(dec["seq_kv"]), np.asarray(dec["one_card"])
    gap = np.asarray(dec["gap"])
    rows_equal = (seq_kv == one_card).all(axis=1)
    held = True
    for b in np.flatnonzero(~rows_equal):
        first = int(np.flatnonzero(seq_kv[b] != one_card[b])[0])
        # step first - P predicted position first; a near-tie before it
        # (or at it) may round either way in fp32
        held &= bool((gap[b, :first - P + 1] < 1e-3).any())
    report["decode_data2_seq2"] = dict(
        rows_bitwise=int(rows_equal.sum()), rows=len(rows_equal),
        ms=dec["ms"], min_gap=float(gap.min()))
    print(json.dumps({"seq_four_cards": dict(
        report, launches_by_path=launches_by_path,
        one_card_flash_trace=one["ranks"][0]["trace"], card=smi)}))
    require(held, f"seq-KV decoding differs from one card's before any "
            f"near-tie: rows bitwise {rows_equal.tolist()}")
    return 0


# --four-cards' model axis: the flagship's step on 4 ranks under each
# mesh, against one card's flash step on the same global batch (name,
# mesh, attention, layout, vocab_parallel, loss_chunk)
TP_FOUR = (("model4", "model=4", "flash", "contiguous", "0", "0"),
           ("data2_model2_vp_chunk512", "data=2,model=2", "flash",
            "contiguous", "1", "512"),
           ("model2_seq2_ring", "model=2,seq=2", "ring", "contiguous", "0",
            "0"))
# decoding over the model axis (name, mesh, vocab_parallel), fp32
TP_DECODE = (("model4", "model=4", "0"),
             ("data2_model2_vp", "data=2,model=2", "1"))
# fp32 decode logits against one card's: the row products' partial sums
# added in another order (~1e-6 relative through 24 layers)
TP_LOGITS_REL = 1e-4


def tp_decode_rank(out, mesh_spec, vocab_parallel):
    """One rank (under torchrun, 4 ranks) of greedy decoding over a mesh
    with a model axis: the flagship in fp32 (8 prompts of 128 tokens, 64
    new), each data member its rows, each model member its shard of the
    heads (and under ``vocab_parallel`` of the vocabulary), its logits of
    every step kept; the members of a model group hold the same tokens
    and logits, bit for bit (checked).  Rank 0 also decodes the whole
    batch alone on its card and writes ``out/decode.json``: both runs'
    tokens, the logits' relative L2 error and the ms of the mesh's
    run; then the same for int8 weights and 4-beam search (the beams'
    tokens and scores)."""
    import numpy as np
    import torch

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_beam_search_fn,
        make_generate_fn, params_from_jax, quantize_params_int8)
    from chainermn_tpu_torch.parallel import MeshConfig
    from chainermn_tpu_torch.testing import replicas_bitwise

    comm = cmn.create_communicator()
    mesh = MeshConfig(comm, **_mesh_axes(mesh_spec))
    cfg = TransformerConfig(**dict(FLAGSHIP, dtype="float32",
                                   vocab_parallel=vocab_parallel == "1"))
    tree = init_numpy_params(cfg, SEED)
    params = params_from_jax(tree, cfg, comm.device, mesh=mesh)
    P, NEW = 128, 64
    prompts = np.random.RandomState(SEED + 1).randint(
        0, cfg.vocab_size, (8, P))
    gen = make_generate_fn(cfg, max_len=P + NEW, with_logits=True,
                           mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, logits = gen(params, prompts)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    members_bitwise = replicas_bitwise(mesh.comm("model"), [toks, logits])
    data = mesh.comm("data")
    rows = np.concatenate(data.allgather_obj(toks.cpu().numpy()))
    steps = np.concatenate(data.allgather_obj(logits.cpu().numpy()))
    del params, logits
    q8 = quantize_params_int8(cfg, tree)
    beam = make_beam_search_fn(cfg, beam_size=4, max_len=P + NEW,
                               quantized=True, mesh=mesh)
    btoks, bscores = beam(params_from_jax(q8, cfg, comm.device, mesh=mesh),
                          prompts)
    brows = np.concatenate(data.allgather_obj(btoks.cpu().numpy()))
    bsc = np.concatenate(data.allgather_obj(bscores.cpu().numpy()))
    if comm.rank == 0:
        one, one_logits = make_generate_fn(
            cfg, max_len=P + NEW, with_logits=True, device=comm.device)(
            params_from_jax(tree, cfg, comm.device), prompts)
        one_logits = one_logits.cpu().numpy()
        ob, osc = make_beam_search_fn(
            cfg, beam_size=4, max_len=P + NEW, quantized=True,
            device=comm.device)(params_from_jax(q8, cfg, comm.device),
                                prompts)
        osc = osc.cpu().numpy()
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "decode.json").write_text(json.dumps(dict(
            mesh=mesh.shape, vocab_parallel=cfg.vocab_parallel,
            tokens=rows.tolist(), one_card=one.cpu().numpy().tolist(),
            logits_rel_l2=float(np.linalg.norm(steps - one_logits)
                                / np.linalg.norm(one_logits)),
            beam_int8=brows.tolist(), beam_int8_one_card=ob.cpu().numpy()
            .tolist(), beam_int8_scores_rel=float(
                np.abs(bsc - osc).max() / np.abs(osc).max()),
            members_bitwise=members_bitwise, prompt=P, ms=ms)))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def four_cards_tp(root, smi):
    """``--four-cards``' model axis: the flagship's step at full width
    on the same global batch (8 x 2048 tokens) under each of
    ``TP_FOUR`` on 4 ranks, and one card's flash step; each mesh's
    losses within ``SEQ_LOSS_REL`` of one card's, its leaves bitwise
    across their groups after every step (:func:`seq_rank`), and every
    rank's flash launches those :func:`seq_predicted_launches` predicts
    (the model axis adds none); ms a step and tokens/s a card, and each
    rank's traced step.  Then greedy decoding (fp32) under each of
    ``TP_DECODE`` against one card's: every row's tokens equal, the
    logits within ``TP_LOGITS_REL``, the model members' tokens and
    logits bitwise.  Prints ``{"tensor_parallel": {...}}``."""
    import numpy as np

    from chainermn_tpu_torch import _build

    out = root / "build" / "four_cards" / "tp"
    me = str(Path(__file__).resolve())
    _build.build_all()          # once, before the children load them
    res, report, launches_by_path = _four_card_steps(out, TP_FOUR)
    one = res["one_card_flash"]
    decode = {}
    for name, mesh, vp in TP_DECODE:
        subprocess.run(["torchrun", "--standalone", "--nproc_per_node", "4",
                        me, "--tp-decode", str(out / f"decode_{name}"),
                        mesh, vp], check=True, timeout=300)
        dec = json.loads((out / f"decode_{name}" / "decode.json")
                         .read_text())
        got, want = np.asarray(dec["tokens"]), np.asarray(dec["one_card"])
        bgot, bwant = (np.asarray(dec[k]) for k in ("beam_int8",
                                                    "beam_int8_one_card"))
        decode[name] = dict(
            rows_equal=int((got == want).all(axis=1).sum()),
            rows=len(got), logits_rel_l2=dec["logits_rel_l2"],
            beam_int8_rows_equal=int((bgot == bwant).all(axis=(1, 2))
                                     .sum()),
            beam_int8_scores_rel=dec["beam_int8_scores_rel"],
            members_bitwise=dec["members_bitwise"], ms=dec["ms"])
    print(json.dumps({"tensor_parallel": dict(
        report, decode=decode, launches_by_path=launches_by_path,
        one_card_flash_trace=one["ranks"][0]["trace"], card=smi)}))
    for name, d in decode.items():
        require(d["rows_equal"] == d["rows"],
                f"decode {name}: {d['rows_equal']} of {d['rows']} rows "
                "equal one card's")
        require(d["logits_rel_l2"] < TP_LOGITS_REL,
                f"decode {name}: logits rel L2 {d['logits_rel_l2']}")
        require(d["beam_int8_rows_equal"] == d["rows"],
                f"decode {name}: int8 beams of {d['beam_int8_rows_equal']}"
                f" of {d['rows']} rows equal one card's")
        require(d["members_bitwise"],
                f"decode {name}: model members' tokens or logits differ")
    return 0


# --four-cards' pipe axis: the flagship's step on 4 ranks under each mesh
# and schedule, against one card's flash step (M=1) on the same global
# batch (name, mesh, schedule, micro-batches, virtual stages)
PP_FOUR = (("pipe4_gpipe", "pipe=4", "gpipe", "8", "1"),
           ("pipe4_1f1b", "pipe=4", "1f1b", "8", "1"),
           ("pipe4_interleaved", "pipe=4", "interleaved", "8", "2"),
           ("pipe2_data2_1f1b", "pipe=2,data=2", "1f1b", "4", "1"))
# the gathered gradients of the first step against one card's: bf16 and
# micro-batches of one row, as phase 17's PP_GRAD_REL.  The parameters
# after 3 AdamW steps: an update is about lr·sign(g) at first, so an
# element whose gradient is within its rounding of zero may move by
# 2·lr the other way; a few such elements in a thousand, over updates
# of ~1e-3 of the weights, stay far below 1e-2
PP_PARAMS_REL = 1e-2


def _save_tree(path, tree):
    import numpy as np
    import torch.utils._pytree as pytree

    leaves = pytree.tree_leaves(tree)
    np.savez(path, *leaves)


def _tree_rel_to_saved(np, path, tree):
    """Relative L2 over the leaves of ``tree`` (numpy) against the tree
    saved at ``path`` in the same leaf order."""
    import torch.utils._pytree as pytree

    saved = np.load(path)
    num = den = 0.0
    for i, a in enumerate(pytree.tree_leaves(tree)):
        b = saved[f"arr_{i}"]
        num += float(np.sum((a.astype(np.float64) - b) ** 2))
        den += float(np.sum(b.astype(np.float64) ** 2))
    return (num / den) ** 0.5


def pp_rank(out, name, mesh_spec, schedule, M, V):
    """One rank (under torchrun) of the flagship's step over a mesh with
    a pipe axis, or on one card (``name == "one_card"``: mesh data=1,
    M=1, the flash step the others are held to): 8 x 2048 tokens
    globally, bf16, full remat, ``adamw(3e-4)``.  First the gradients of
    the initial parameters (``make_value_and_grad_fn``), gathered; then
    ``SEQ_STEPS`` steps, each timed (host clock around a synchronised
    step), with after each the leaves of every rank compared bitwise
    across the batch-like group and the pipe-replicated ones (``embed``,
    ``pos``, ``ln_f``) across the pipe group; the flash launches counted
    from 0 just before the steps to just after, beside
    :func:`pp_predicted_launches`; the peak memory; the gathered
    parameters after the steps; one more step traced on every rank
    (``profile_port.trace``).  One card saves its gradients and
    parameters (``out/../one_card/*.npz``); a mesh's rank 0 holds its
    own against them.  Rank 0 writes ``out/pp.json``."""
    import numpy as np
    import torch

    import chainermn_tpu_torch as cmn
    import profile_port
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_train_step,
        make_value_and_grad_fn, params_from_jax, params_to_numpy)
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel import MeshConfig
    from chainermn_tpu_torch.parallel.mesh import BATCH_AXES
    from chainermn_tpu_torch.testing import replicas_bitwise

    comm = cmn.create_communicator()
    mesh = MeshConfig(comm, **_mesh_axes(mesh_spec))
    S = mesh.axis_size("pipe")
    cfg = TransformerConfig(**dict(
        FLAGSHIP, remat=True, pipeline_schedule=schedule,
        num_microbatches=int(M), virtual_pipe=int(V)))
    params = params_from_jax(init_numpy_params(cfg, SEED, pipe_size=S), cfg,
                             comm.device, mesh=mesh)
    pipe, batch = mesh.comm("pipe"), mesh.comm(*BATCH_AXES)
    replicated = [params[k] for k in ("embed", "pos", "ln_f")]
    toks = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (8, cfg.max_seq + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    one = Path(out).parent / "one_card"
    loss0, grads = make_value_and_grad_fn(cfg, mesh=mesh)(params, x, y)
    grads = params_to_numpy(grads, cfg, mesh=mesh)
    grads["blocks"] = blocks_in_layer_order(cfg, grads["blocks"], S)
    mine = dict(rank=comm.rank, coords=mesh.coords)
    if comm.rank == 0:
        if name == "one_card":
            one.mkdir(parents=True, exist_ok=True)
            _save_tree(one / "grads.npz", grads)
        else:
            mine["grads_rel_l2"] = _tree_rel_to_saved(
                np, one / "grads.npz", grads)
    del grads
    opt = training.adamw(3e-4)
    state = opt.init(params)
    step = make_train_step(cfg, opt, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    times, losses, equal = [], [], []
    torch.cuda.synchronize()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0      # path starts
    for _ in range(SEQ_STEPS):
        comm.barrier()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        equal.append(replicas_bitwise(batch, params)
                     and replicas_bitwise(pipe, replicated))
    torch.cuda.synchronize()
    mine.update(                                                # ended
        launches=(fa.launches, fa.dq_launches, fa.dkv_launches),
        predicted=pp_predicted_launches(cfg, S, mesh.axis_index("pipe"),
                                        SEQ_STEPS),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    gathered = params_to_numpy(params, cfg, mesh=mesh)
    gathered["blocks"] = blocks_in_layer_order(cfg, gathered["blocks"], S)
    if comm.rank == 0:
        if name == "one_card":
            _save_tree(one / "params.npz", gathered)
        else:
            mine["params_rel_l2"] = _tree_rel_to_saved(
                np, one / "params.npz", gathered)
    del gathered
    comm.barrier()
    mine["trace"] = profile_port.trace(
        torch, lambda: step(params, state, x, y), name, warm=False,
        show=False)
    ranks = comm.allgather_obj(mine)
    if comm.rank == 0:
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "pp.json").write_text(json.dumps(dict(
            name=name, mesh=mesh.shape, schedule=schedule, M=int(M),
            V=int(V), world=comm.size, tokens=8 * cfg.max_seq,
            bubble_predicted=pp_bubble(cfg, S), first_loss=loss0.item(),
            times_ms=times, losses=losses, ranks_equal=equal, ranks=ranks)))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def pp_decode_rank(out):
    """One rank (under torchrun, 4 ranks) of greedy decoding over mesh
    pipe=4: the flagship in fp32 (8 prompts of 128 tokens, 64 new), each
    stage its 6 layers and their cache, the logits of every step kept;
    the stages hold the same tokens and logits, bit for bit (checked).
    Rank 0 also decodes the whole batch alone on its card and writes
    ``out/decode.json``: both runs' tokens, whether the logits are the
    one card's bits, their relative L2 error and the ms of the mesh's
    run."""
    import numpy as np
    import torch

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_generate_fn,
        params_from_jax)
    from chainermn_tpu_torch.parallel import MeshConfig
    from chainermn_tpu_torch.testing import replicas_bitwise

    comm = cmn.create_communicator()
    mesh = MeshConfig(comm, pipe=4)
    cfg = TransformerConfig(**dict(FLAGSHIP, dtype="float32"))
    params = params_from_jax(init_numpy_params(cfg, SEED, pipe_size=4), cfg,
                             comm.device, mesh=mesh)
    P, NEW = 128, 64
    prompts = np.random.RandomState(SEED + 1).randint(
        0, cfg.vocab_size, (8, P))
    gen = make_generate_fn(cfg, max_len=P + NEW, with_logits=True,
                           mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, logits = gen(params, prompts)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    stages_bitwise = replicas_bitwise(mesh.comm("pipe"), [toks, logits])
    del params
    if comm.rank == 0:
        one, one_logits = make_generate_fn(
            cfg, max_len=P + NEW, with_logits=True, device=comm.device)(
            params_from_jax(init_numpy_params(cfg, SEED), cfg, comm.device),
            prompts)
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "decode.json").write_text(json.dumps(dict(
            mesh=mesh.shape, tokens=toks.cpu().numpy().tolist(),
            one_card=one.cpu().numpy().tolist(),
            logits_bitwise=bool(torch.equal(logits, one_logits)),
            logits_rel_l2=rel_err(logits, one_logits),
            stages_bitwise=stages_bitwise, prompt=P, ms=ms)))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def four_cards_pp(root, smi):
    """``--four-cards``' pipe axis: the flagship's step at full width on
    the same global batch (8 x 2048 tokens) under each of ``PP_FOUR`` on
    4 ranks (:func:`pp_rank`), and one card's flash step; for each mesh
    the first step's gradients and the parameters after 3 steps against
    one card's (``PP_GRAD_REL``, ``PP_PARAMS_REL``), its losses within
    ``SEQ_LOSS_REL`` of one card's, every data- and pipe-replicated leaf
    bitwise across its ranks after every step, every rank's flash
    launches those :func:`pp_predicted_launches` counts from the
    schedule's tables; ms a step (the median of steps 2-3), tokens/s a
    card, peak GiB a rank and a traced step a rank (busy and idle share
    beside the schedule's bubble).  Then greedy decoding at pipe=4
    (fp32, :func:`pp_decode_rank`) against one card's: every row's
    tokens equal, the stages' tokens and logits bitwise.  Prints
    ``{"pipeline": {...}}``."""
    import numpy as np

    from chainermn_tpu_torch import _build

    out = root / "build" / "four_cards" / "pp"
    me = str(Path(__file__).resolve())
    _build.build_all()          # once, before the children load them
    res = {}
    for name, mesh, schedule, M, V in (
            ("one_card", "data=1", "gpipe", "1", "1"),) + PP_FOUR:
        n = 1 if name == "one_card" else 4
        subprocess.run(["torchrun", "--standalone", "--nproc_per_node",
                        str(n), me, "--pp-rank", str(out / name), name,
                        mesh, schedule, M, V], check=True, timeout=420)
        res[name] = json.loads((out / name / "pp.json").read_text())
    one = res["one_card"]
    report = {}
    for name, r in res.items():
        got = {q["rank"]: q["launches"] for q in r["ranks"]}
        want = {q["rank"]: q["predicted"] for q in r["ranks"]}
        require(got == want, f"{name}: flash launches (forward, dq, "
                f"dk/dv) by rank {got}, the tables predict {want}")
    for name, *_ in PP_FOUR:
        r = res[name]
        lead = r["ranks"][0]
        rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                   one["losses"])]
        ms = statistics.median(r["times_ms"][1:])
        report[name] = dict(
            {k: v for k, v in r.items() if k != "ranks"},
            loss_rel_diff=rel, steady_ms=ms,
            tokens_per_s_per_card=r["tokens"] / ms * 1e3 / r["world"],
            one_card_steady_ms=statistics.median(one["times_ms"][1:]),
            grads_rel_l2=lead["grads_rel_l2"],
            params_rel_l2=lead["params_rel_l2"],
            peak_gib=[q["peak_gib"] for q in r["ranks"]],
            launches={q["rank"]: q["launches"] for q in r["ranks"]},
            trace={q["rank"]: q["trace"] for q in r["ranks"]})
        require(all(r["ranks_equal"]) and len(r["ranks_equal"])
                == SEQ_STEPS, f"{name}: replicas differ: {r['ranks_equal']}")
        require(all(np.isfinite(r["losses"])), f"{name}: {r['losses']}")
        require(all(e < bar for e, bar in zip(rel, SEQ_LOSS_REL)),
                f"{name}: losses {r['losses']} against one card's "
                f"{one['losses']}: relative {rel}, bars {SEQ_LOSS_REL}")
        require(lead["grads_rel_l2"] < PP_GRAD_REL,
                f"{name}: gradients rel L2 {lead['grads_rel_l2']}")
        require(lead["params_rel_l2"] < PP_PARAMS_REL,
                f"{name}: parameters rel L2 {lead['params_rel_l2']}")
    subprocess.run(["torchrun", "--standalone", "--nproc_per_node", "4",
                    me, "--pp-decode", str(out / "decode")], check=True,
                   timeout=420)
    dec = json.loads((out / "decode" / "decode.json").read_text())
    got, want = np.asarray(dec["tokens"]), np.asarray(dec["one_card"])
    report["decode_pipe4"] = dict(
        rows_equal=int((got == want).all(axis=1).sum()), rows=len(got),
        logits_bitwise=dec["logits_bitwise"],
        logits_rel_l2=dec["logits_rel_l2"],
        stages_bitwise=dec["stages_bitwise"], ms=dec["ms"])
    print(json.dumps({"pipeline": dict(
        report, one_card=dict(times_ms=one["times_ms"],
                              losses=one["losses"],
                              peak_gib=one["ranks"][0]["peak_gib"],
                              trace=one["ranks"][0]["trace"]), card=smi)}))
    d = report["decode_pipe4"]
    require(d["rows_equal"] == d["rows"],
            f"decode pipe=4: {d['rows_equal']} of {d['rows']} rows equal "
            "one card's")
    require(d["stages_bitwise"], "decode pipe=4: the stages' tokens or "
            "logits differ")
    return 0


# --four-cards ep: the MoE flagship's step on 4 ranks under each mesh
# against the one-card simulation of the same per-rank routing (name,
# mesh, schedule, micro-batches, top-k)
EP_FOUR = (("expert4_top1", "expert=4", "gpipe", "1", "1"),
           ("data2_expert2_top2", "data=2,expert=2", "gpipe", "1", "2"),
           ("expert2_model2_top1", "expert=2,model=2", "gpipe", "1", "1"),
           ("pipe2_expert2_1f1b", "pipe=2,expert=2", "1f1b", "2", "1"))


def ep_config(schedule, M, k, **kw):
    from chainermn_tpu_torch.models import TransformerConfig

    return TransformerConfig(**dict(
        MOE, pipeline_schedule=schedule, num_microbatches=int(M),
        router_top_k=int(k), **kw))


def ep_sim_order(B, D, X, M):
    """The one card's row order under which the simulation routes as
    the mesh's ranks do: the one card's micro-batch ``m`` is every rank's
    micro-batch ``m`` in rank order (``d·X + e``)."""
    G = D * X
    R = B // G
    r = R // M
    return [g * R + m * r + j for m in range(M) for g in range(G)
            for j in range(r)]


def ep_batch(np, cfg):
    toks = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (8, cfg.max_seq + 1))
    return toks[:, :-1], toks[:, 1:]


def ep_sim_child(out):
    """One card (one rank under torchrun): for each of ``EP_FOUR`` the
    MoE flagship's ``SEQ_STEPS`` AdamW steps with every rank of the
    mesh's grouping simulated (``SimulatedExpertAxis`` over data x
    expert, the batch in :func:`ep_sim_order`, the mesh's micro-batches
    at pipe=1: the 1F1B schedule's loss is the same function), the
    drops a layer of a first forward, ms a step and peak GiB.  Writes
    ``out/sim.json``."""
    import numpy as np
    import torch

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models.transformer import (
        lm_loss, transformer_forward)
    from chainermn_tpu_torch.parallel import expert as ep

    dev = torch.device("cuda")
    res = {}
    for name, mesh_spec, _, M, k in EP_FOUR:
        axes = _mesh_axes(mesh_spec)
        D, X = axes.get("data", 1), axes.get("expert", 1)
        cfg = ep_config("gpipe", M, k)
        axis = ep.SimulatedExpertAxis(X, data=D)
        x, y = ep_batch(np, cfg)
        order = ep_sim_order(8, D, X, int(M))
        xt, yt = (torch.as_tensor(a[order], device=dev) for a in (x, y))
        params = moe_params(torch, cfg, dev)
        ep.expert_parallel_moe.routings = log = []
        with torch.inference_mode():
            transformer_forward(cfg, params, xt, expert=axis)
        ep.expert_parallel_moe.routings = None
        drops = moe_drops_by_layer(log, cfg.n_layers, group=D * X)
        del log
        opt = training.adamw(3e-4)
        state = opt.init(params)

        def step():
            live = {kk: v.detach().requires_grad_() for kk, v in
                    params.items() if kk != "blocks"}
            live["blocks"] = {kk: v.detach().requires_grad_()
                              for kk, v in params["blocks"].items()}
            with torch.enable_grad():
                loss = lm_loss(cfg, live, xt, yt, expert=axis)
                grads = torch.autograd.grad(
                    loss, [live[kk] for kk in params if kk != "blocks"]
                    + list(live["blocks"].values()))
            top = [kk for kk in params if kk != "blocks"]
            g = dict(zip(top, grads))
            g["blocks"] = dict(zip(params["blocks"], grads[len(top):]))
            opt.update({kk: g[kk] for kk in params}, state, params)
            return loss.detach()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(SEQ_STEPS):
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        res[name] = dict(losses=losses, times_ms=times,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         drops_by_layer=drops,
                         assignments_a_layer=8 * cfg.max_seq * int(k))
        del params, state, opt
        gc.collect()
        torch.cuda.empty_cache()
    Path(out).mkdir(parents=True, exist_ok=True)
    (Path(out) / "sim.json").write_text(json.dumps(res))
    return 0


def ep_rank(out, name, mesh_spec, schedule, M, k):
    """One rank (under torchrun, 4 ranks) of the MoE flagship's step over
    a mesh with an expert axis: 8 x 2048 tokens globally, bf16, full
    remat, ``adamw(3e-4)``; the whole tree drawn on the card
    (:func:`moe_params`), rank 0's broadcast, each rank keeping its
    shard.  The drops a layer of a first forward (``make_forward_fn``;
    the model axis's members route the same tokens, so member 0's
    count); then ``SEQ_STEPS`` steps, each timed, after each the
    leaves replicated over the batch-like group (all but the experts)
    and the experts over ``(data, seq)`` compared bitwise; the flash
    launches counted from 0 just before the steps to just after, beside
    :func:`pp_predicted_launches`; the peak memory.  At ``expert=4``
    also phase 18 (a)'s layer across the four ranks (each its quarter
    of the tokens, its two experts, the all-to-all over the expert
    communicator), gathered on rank 0 against the simulation of the
    same grouping.  Rank 0 writes ``out/ep.json``."""
    import numpy as np
    import torch

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        make_forward_fn, make_train_step, shard_params)
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel import MeshConfig
    from chainermn_tpu_torch.parallel import expert as ep
    from chainermn_tpu_torch.parallel.mesh import BATCH_AXES
    from chainermn_tpu_torch.testing import replicas_bitwise

    comm = cmn.create_communicator()
    dev = comm.device
    mesh = MeshConfig(comm, **_mesh_axes(mesh_spec))
    S, s = mesh.axis_size("pipe"), mesh.axis_index("pipe")
    cfg = ep_config(schedule, M, k)
    whole = moe_params(torch, cfg, dev)
    comm.bcast_data(whole)
    params = shard_params(mesh, cfg, whole)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    x, y = ep_batch(np, cfg)
    mine = dict(rank=comm.rank, coords=mesh.coords)
    ep.expert_parallel_moe.routings = log = []
    make_forward_fn(cfg, mesh=mesh)(params, x)
    ep.expert_parallel_moe.routings = None
    n_local = cfg.n_layers // S
    mine["drops_by_layer"] = moe_drops_by_layer(
        log, n_local, first=s * n_local) \
        if mesh.axis_index("model") == 0 else {}
    del log
    if name == "expert4_top1":
        xl, rw, w = moe_layer_inputs(torch, dev)
        e, X = mesh.axis_index("expert"), mesh.axis_size("expert")
        got, aux = ep.expert_parallel_moe(
            xl.chunk(X)[e], rw, {kk: v.chunk(X)[e] for kk, v in w.items()},
            moe_expert_fn, comm=mesh.comm("expert"), capacity_factor=1.25,
            top_k=1)
        got = mesh.comm("expert").allgather(got.contiguous())
        if comm.rank == 0:
            sim, sim_aux = ep.simulate_expert_parallel(
                xl, rw, w, moe_expert_fn, axis=ep.SimulatedExpertAxis(X),
                capacity_factor=1.25, top_k=1)
            got = got.reshape(sim.shape)
            mine["layer"] = dict(rel_l2=rel_err(got, sim),
                                 bitwise=bool(torch.equal(got, sim)),
                                 aux=aux.item(), sim_aux=sim_aux.item())
        del xl, rw, w, got
    opt = training.adamw(3e-4)
    state = opt.init(params)
    step = make_train_step(cfg, opt, mesh=mesh)
    batch, data_seq = mesh.comm(*BATCH_AXES), mesh.comm("data", "seq")
    repl = [v for kk, v in params.items() if kk != "blocks"] + [
        v for kk, v in params["blocks"].items() if kk not in ("w1", "w2")]
    experts = [params["blocks"]["w1"], params["blocks"]["w2"]]
    torch.cuda.reset_peak_memory_stats()
    times, losses, equal = [], [], []
    torch.cuda.synchronize()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0      # path starts
    for _ in range(SEQ_STEPS):
        comm.barrier()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        equal.append(replicas_bitwise(batch, repl)
                     and replicas_bitwise(data_seq, experts))
    torch.cuda.synchronize()
    mine.update(                                                # ended
        launches=(fa.launches, fa.dq_launches, fa.dkv_launches),
        predicted=pp_predicted_launches(cfg, S, s, SEQ_STEPS),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    ranks = comm.allgather_obj(mine)
    if comm.rank == 0:
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "ep.json").write_text(json.dumps(dict(
            name=name, mesh=mesh.shape, schedule=schedule, M=int(M),
            top_k=int(k), world=comm.size, tokens=8 * cfg.max_seq,
            times_ms=times, losses=losses, ranks_equal=equal,
            ranks=ranks)))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def ep_decode_rank(out):
    """One rank (under torchrun, 4 ranks) of greedy decoding over mesh
    expert=4: the MoE flagship in fp32 at ample capacity (``cf = E``:
    nothing dropped, so a token's experts do not depend on the rows
    routed beside it), 8 prompts of 128 tokens, 64 new, each rank 2 rows
    and 2 experts.  Rank 0 also decodes the whole batch alone on its
    card and writes ``out/decode.json``: both runs' tokens, the logits'
    relative L2 error and the ms of the mesh's run."""
    import numpy as np
    import torch

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import make_generate_fn, shard_params
    from chainermn_tpu_torch.parallel import MeshConfig

    comm = cmn.create_communicator()
    mesh = MeshConfig(comm, expert=4)
    cfg = ep_config("gpipe", 1, 1, dtype="float32", remat=False,
                    capacity_factor=float(MOE["n_experts"]))
    whole = moe_params(torch, cfg, comm.device)
    comm.bcast_data(whole)
    params = shard_params(mesh, cfg, whole)
    P, NEW = 128, 64
    prompts = np.random.RandomState(SEED + 1).randint(
        0, cfg.vocab_size, (8, P))
    gen = make_generate_fn(cfg, max_len=P + NEW, with_logits=True,
                           mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, logits = gen(params, prompts)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    toks = torch.cat(list(comm.allgather(toks.contiguous()).unbind(0)))
    logits = torch.cat(list(comm.allgather(logits.contiguous()).unbind(0)))
    del params
    if comm.rank == 0:
        one, one_logits = make_generate_fn(
            cfg, max_len=P + NEW, with_logits=True, device=comm.device)(
            whole, prompts)
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "decode.json").write_text(json.dumps(dict(
            mesh=mesh.shape, tokens=toks.cpu().numpy().tolist(),
            one_card=one.cpu().numpy().tolist(),
            logits_bitwise=bool(torch.equal(logits, one_logits)),
            logits_rel_l2=rel_err(logits, one_logits), prompt=P, ms=ms)))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def four_cards_ep(root, smi):
    """``--four-cards``' expert axis: the MoE flagship's step at full
    width on the same global batch (8 x 2048 tokens) under each of
    ``EP_FOUR`` on 4 ranks (:func:`ep_rank`) against one card's
    simulation of the same per-rank routing (:func:`ep_sim_child`): the
    losses within ``EP_LOSS_REL``, the drops a layer (without a model
    axis the first layer's equal and the others within ``EP_DROP_FRAC``
    of the layer's assignments; with one the first layer's within it),
    the replicated leaves bitwise
    after every step, every
    rank's flash launches as the schedule counts; ms a step (the median
    of steps 2-3), tokens/s a card and peak GiB a rank against the
    simulation's; at expert=4 the layer alone across the ranks against
    its simulation (``MOE_OUT_REL``).  Then greedy decoding at expert=4
    (fp32, :func:`ep_decode_rank`) against one card's: every row's
    tokens equal, the logits within ``EP_LOGITS_REL``.  Prints each
    mesh's ``{"expert_parallel_<name>": {...}}`` before its checks, and
    ``{"expert_parallel": {...}}``."""
    import numpy as np

    from chainermn_tpu_torch import _build

    out = root / "build" / "four_cards" / "ep"
    me = str(Path(__file__).resolve())
    _build.build_all()          # once, before the children load them
    subprocess.run(["torchrun", "--standalone", "--nproc_per_node", "1",
                    me, "--ep-sim", str(out / "sim")], check=True,
                   timeout=600)
    sim = json.loads((out / "sim" / "sim.json").read_text())
    res, report = {}, {}
    for name, mesh, schedule, M, k in EP_FOUR:
        subprocess.run(["torchrun", "--standalone", "--nproc_per_node", "4",
                        me, "--ep-rank", str(out / name), name, mesh,
                        schedule, M, k], check=True, timeout=420)
        res[name] = r = json.loads((out / name / "ep.json").read_text())
        one = sim[name]
        got = {q["rank"]: q["launches"] for q in r["ranks"]}
        want = {q["rank"]: q["predicted"] for q in r["ranks"]}
        drops = {}
        for q in r["ranks"]:
            for layer, n in q["drops_by_layer"].items():
                drops[int(layer)] = drops.get(int(layer), 0) + n
        want_drops = {int(a): n for a, n in one["drops_by_layer"].items()}
        off = {a: drops.get(a, 0) - n for a, n in want_drops.items()}
        rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                   one["losses"])]
        ms = statistics.median(r["times_ms"][1:])
        one_ms = statistics.median(one["times_ms"][1:])
        report[name] = dict(
            {kk: v for kk, v in r.items() if kk != "ranks"},
            loss_rel_diff=rel, steady_ms=ms,
            tokens_per_s_per_card=r["tokens"] / ms * 1e3 / r["world"],
            one_card_simulated_ms=one_ms, one_card_losses=one["losses"],
            one_card_peak_gib=one["peak_gib"],
            peak_gib=[q["peak_gib"] for q in r["ranks"]],
            launches=got, drops_by_layer=[drops.get(a, 0) for a in
                                          range(len(want_drops))],
            drops_off_simulation=[off[a] for a in range(len(off))],
            layer=r["ranks"][0].get("layer"))
        print(json.dumps({f"expert_parallel_{name}": report[name]}))
        require(got == want, f"{name}: flash launches (forward, dq, "
                f"dk/dv) by rank {got}, the schedule predicts {want}")
        require(all(r["ranks_equal"]) and len(r["ranks_equal"])
                == SEQ_STEPS, f"{name}: replicas differ: {r['ranks_equal']}")
        require(all(np.isfinite(r["losses"])), f"{name}: {r['losses']}")
        require(all(e < bar for e, bar in zip(rel, EP_LOSS_REL)),
                f"{name}: losses {r['losses']} against the simulation's "
                f"{one['losses']}: relative {rel}, bars {EP_LOSS_REL}")
        tp = r["mesh"]["model"] > 1
        held = {0: off[0]} if tp else off
        require((off[0] == 0 or tp) and all(
            abs(d) <= EP_DROP_FRAC * one["assignments_a_layer"]
            for d in held.values()), f"{name}: drops a layer off the "
            f"simulation's by {off}")
        if name == "expert4_top1":
            lay = report[name]["layer"]
            require(lay["rel_l2"] < MOE_OUT_REL,
                    f"{name}: the layer across the ranks off its "
                    f"simulation: {lay}")
    subprocess.run(["torchrun", "--standalone", "--nproc_per_node", "4",
                    me, "--ep-decode", str(out / "decode")], check=True,
                   timeout=420)
    dec = json.loads((out / "decode" / "decode.json").read_text())
    got, want = np.asarray(dec["tokens"]), np.asarray(dec["one_card"])
    report["decode_expert4"] = d = dict(
        rows_equal=int((got == want).all(axis=1).sum()), rows=len(got),
        logits_bitwise=dec["logits_bitwise"],
        logits_rel_l2=dec["logits_rel_l2"], ms=dec["ms"])
    print(json.dumps({"expert_parallel": dict(report, card=smi)}))
    require(d["rows_equal"] == d["rows"],
            f"decode expert=4: {d['rows_equal']} of {d['rows']} rows equal "
            "one card's")
    require(d["logits_rel_l2"] < EP_LOGITS_REL,
            f"decode expert=4: logits rel L2 {d['logits_rel_l2']}")
    return 0


# --------------------------------------------------------------------- #
# 19 and --four-cards zero: ZeRO-1/2 and FSDP over the data axis
# --------------------------------------------------------------------- #

# --four-cards zero: (name, mesh, schedule, micro-batches, MoE, top-k);
# each mesh runs without FSDP, with it, and (data=4) with the bf16 wire
ZERO_FOUR = (("data4", "data=4", "gpipe", "1", "0", "1"),
             ("data2_expert2_moe_top2", "data=2,expert=2", "gpipe", "1",
              "1", "2"),
             ("pipe2_data2_1f1b", "pipe=2,data=2", "1f1b", "4", "0", "1"))
# FSDP's losses against the same mesh's without it: the first bitwise
# (the gathered weights are the whole fp32 ones, or their bf16 rounding,
# which the bf16 compute rounds to the same bits), the later ones within
# the sequence axis's bars (the gradients' sums run in other orders)
ZERO_LOSS_REL = (0.0, 1e-3, 5e-3)
ZERO_PARAMS_REL = 1e-2
# phase 19 (a): the steps of each run, the first a warm-up for the time
ZERO_ONE_CARD_STEPS = 4
# phase 19 (c) and --four-cards zero (e): ResNet-50, 32 images a rank,
# the first update a warm-up for the time (cuDNN's autotuning)
ZERO_RESNET_B = 32
ZERO_RESNET_UPDATES = 4


def tree_bytes(torch, tree):
    """Bytes of every tensor of ``tree``."""
    import torch.utils._pytree as pytree

    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if torch.is_tensor(t))


def resident_bytes(torch, params, opt_state):
    """Parameter and optimizer-state bytes a rank, counted from the
    tensors (a ZeRO state's scratch shards included)."""
    from chainermn_tpu_torch.training import optimizer_state_tree

    import torch.utils._pytree as pytree

    inner = getattr(opt_state, "inner", opt_state)
    mine = {id(t) for t in pytree.tree_leaves(params)}
    return tree_bytes(torch, params) + tree_bytes(
        torch, optimizer_state_tree(opt_state)) + sum(
        p.numel() * p.element_size() for g in inner.param_groups
        for p in g["params"] if id(p) not in mine)


def zero_resnet_runs(torch, np, comm, smi):
    """ResNet-50 (sync BN, 224 px, bf16 compute, ``sgd(0.1,
    momentum=0.9)``, fp32 wire) under ``StandardUpdater`` on
    ``ZERO_RESNET_B`` seeded images a rank, ``ZERO_RESNET_UPDATES``
    updates with the replicated exchange, ZeRO-1 and ZeRO-2 from the same
    weights: each mode's losses, ms an update, peak and resident bytes,
    its sharding as the updater reports it, whether the ranks' parameters
    are the same bits after every update, and rank 0's parameters."""
    import torch.utils._pytree as pytree

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import (
        ResNetConfig, init_resnet_numpy, resnet_apply,
        resnet_params_from_jax, softmax_cross_entropy)
    from chainermn_tpu_torch.testing import replicas_bitwise

    cfg = ResNetConfig()
    tree, st = init_resnet_numpy(cfg, SEED)
    rng = np.random.default_rng(SEED + 1 + comm.rank)
    data = [(rng.standard_normal((224, 224, 3), dtype=np.float32),
             np.int32(rng.integers(0, 1000)))
            for _ in range(ZERO_RESNET_B)]

    def loss_fn(prm, state, x, y):
        logits, new = resnet_apply(cfg, prm, state, x, train=True,
                                   comm=comm)
        return softmax_cross_entropy(logits, y), new

    runs = {}
    for mode, kw in (("replicated", {}), ("zero1", dict(zero1=True)),
                     ("zero2", dict(zero2=True))):
        params, state = resnet_params_from_jax(tree, st, cfg,
                                               device=comm.device)
        opt = training.create_multi_node_optimizer(
            training.sgd(0.1, momentum=0.9), comm, **kw)
        it = SerialIterator(data, ZERO_RESNET_B, shuffle=False)
        up = training.StandardUpdater(it, opt, loss_fn, params, comm,
                                      state=state)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, times, equal = [], [], []
        for _ in range(ZERO_RESNET_UPDATES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            up.update()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(up.observation["main/loss"]))
            equal.append(replicas_bitwise(comm, up.params))
        runs[mode] = dict(
            losses=losses, times_ms=times, equal=equal,
            sharding=up.status()["sharding"],
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            resident_mb=resident_bytes(torch, up.params, up.opt_state)
            / 1e6,
            params=[t.detach().float().cpu().numpy()
                    for t in pytree.tree_leaves(up.params)])
        del up, opt, params, state
    flat = {m: np.concatenate([a.ravel() for a in r.pop("params")])
            for m, r in runs.items()}
    ref = flat["replicated"]
    for m in ("zero1", "zero2"):
        runs[m]["params_bitwise_replicated"] = bool(
            np.array_equal(flat[m], ref))
        runs[m]["params_rel_l2_replicated"] = float(
            np.linalg.norm(flat[m] - ref) / np.linalg.norm(ref))
    runs["zero2"]["params_bitwise_zero1"] = bool(
        np.array_equal(flat["zero2"], flat["zero1"]))
    return dict(world=comm.size, images_per_rank=ZERO_RESNET_B,
                card=smi, runs=runs)


def phase_zero(torch, np, root, smi, comm):
    """19. ZeRO-1/2 and FSDP on one card, in the one-rank NCCL world
    (after phase 16): (a) the flagship at full width with ``fsdp=True``
    over the mesh's data group of one, ``ZERO_ONE_CARD_STEPS`` steps
    against the plain step (bitwise: each block's gather over one member
    is the weights themselves), its flash launches a step (48, 24, 24),
    ms a step (the median after the first); (b)
    ``fsdp_gather`` with the bf16 wire over that group on a block's
    ``w1``: the weights come back bf16-rounded and the gradient is
    bf16-rounded, element by element; (c) ResNet-50 under
    ``StandardUpdater`` with ZeRO-1 and ZeRO-2 (:func:`zero_resnet_runs`)
    against the replicated exchange, bitwise.  Returns the launch
    counts of (a) and the metrics."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_train_step,
        params_from_jax)
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel import MeshConfig, fsdp_gather

    t_phase = time.perf_counter()
    dev = comm.device
    mesh = MeshConfig(comm, data=1)
    cfg = TransformerConfig(**dict(FLAGSHIP, remat=True))
    fcfg = dataclasses.replace(cfg, fsdp=True)
    tree = init_numpy_params(cfg, SEED)
    toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size,
                                               (8, cfg.max_seq + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    counts, steps, metrics = {}, {}, {"card": smi}
    n = ZERO_ONE_CARD_STEPS
    for name, c, m in (("plain", cfg, None), ("fsdp", fcfg, mesh)):
        params = params_from_jax(tree, c, dev, mesh=m)
        opt = training.adamw(3e-4)
        state = opt.init(params)
        step = make_train_step(c, opt, device=dev, mesh=m)
        torch.cuda.synchronize()
        fa.launches = fa.dq_launches = fa.dkv_launches = 0  # path starts
        losses, times = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            losses.append(step(params, state, x, y)[2])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if name == "fsdp":                                # path ended
            counts["fsdp_one_card"] = (fa.launches, fa.dq_launches,
                                       fa.dkv_launches)
        # the first step warms up (cuBLAS, the allocator): steps 2-n
        metrics[f"{name}_ms_a_step"] = statistics.median(times[1:])
        metrics[f"{name}_times_ms"] = times
        steps[name] = (losses, params)
        del state
    L = cfg.n_layers
    require(counts["fsdp_one_card"] == (2 * L * n, L * n, L * n),
            f"19 (a) launches over {n} steps {counts['fsdp_one_card']}, "
            f"want {(2 * L, L, L)} a step")
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(
        steps["fsdp"][0], steps["plain"][0])) and trees_equal(
        torch, steps["fsdp"][1], steps["plain"][1])
    metrics.update(fsdp_step_bitwise=bitwise,
                   fsdp_losses=[v.item() for v in steps["fsdp"][0]],
                   launches=counts["fsdp_one_card"])
    print(f"zero (a): the flagship's step with fsdp over a data group of "
          f"one against the plain step, {n} steps: losses "
          f"{metrics['fsdp_losses']} vs "
          f"{[v.item() for v in steps['plain'][0]]}, bitwise {bitwise}; "
          f"launches {counts['fsdp_one_card']}; "
          f"{metrics['fsdp_ms_a_step']:.2f} ms a step (plain "
          f"{metrics['plain_ms_a_step']:.2f}; the median of steps 2-{n})")
    require(bitwise, "19 (a) the fsdp step is not the plain step")

    # (b) the bf16 wire over the group of one, on a block's w1
    w = steps["fsdp"][1]["blocks"]["w1"][0].detach().clone() \
        .requires_grad_()
    del steps
    got = fsdp_gather({"w1": w}, {"w1": 0}, mesh.comm("data"),
                      "bfloat16")["w1"]
    g = torch.randn(w.shape, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    (got * g).sum().backward()
    wb = bool(torch.equal(got, w.detach().to(torch.bfloat16).float()))
    gb = bool(torch.equal(w.grad, g.to(torch.bfloat16).float()))
    exact = int((got == w.detach()).sum())
    metrics.update(bf16_wire_weights=wb, bf16_wire_grad=gb)
    print(f"zero (b): fsdp_gather with the bf16 wire over one member, "
          f"w1 {tuple(w.shape)}: weights bf16-rounded element by element "
          f"{wb} ({exact} of {w.numel()} already bf16 values), gradient "
          f"bf16-rounded {gb}")
    require(wb and gb, "19 (b) the bf16 wire's rounding")
    del w, got, g

    # (c) ResNet-50 under StandardUpdater: ZeRO-1 and ZeRO-2 at world 1
    res = zero_resnet_runs(torch, np, comm, smi)
    metrics["resnet_world1"] = res
    for mode, r in res["runs"].items():
        print(f"zero (c): resnet50 {mode}: losses {r['losses']}, "
              f"{statistics.median(r['times_ms'][1:]):.2f} ms an update "
              f"({ZERO_RESNET_B} images), peak {r['peak_gib']:.2f} GiB, "
              f"resident {r['resident_mb']:.1f} MB, sharding "
              f"{r['sharding']}")
    z1, z2 = res["runs"]["zero1"], res["runs"]["zero2"]
    require(z1["sharding"] == "zero1" and z2["sharding"] == "zero2",
            "19 (c) the updater's sharding")
    require(z1["params_bitwise_replicated"]
            and z2["params_bitwise_replicated"]
            and z1["losses"] == res["runs"]["replicated"]["losses"],
            f"19 (c) ZeRO at world 1 is not the replicated exchange: rel "
            f"L2 {z1['params_rel_l2_replicated']}, "
            f"{z2['params_rel_l2_replicated']}")
    metrics["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"zero_one_card": metrics}))
    print(f"zero: phase {metrics['seconds']:.1f} s ({smi})")
    return counts, metrics


def zero_rank(out, name, mesh_spec, schedule, M, moe, k):
    """One rank (under torchrun, 4 ranks) of ``--four-cards zero``'s
    flagship over a mesh with a data axis: 8 x 2048 tokens globally,
    bf16, full remat, ``adamw(3e-4)``, the same weights (the dense
    flagship from numpy seed 0; the MoE one drawn on the card,
    :func:`moe_params`; drawn again for each run) without FSDP, with
    it, and at ``data=4`` with the bf16 wire.  For each: ``SEQ_STEPS``
    steps, each timed, after
    each the leaves replicated over the data group (and over the
    batch-like group) compared bitwise across its members; the flash
    launches counted from 0 just before the steps to just after beside
    :func:`pp_predicted_launches`; the gathers; the peak memory; the
    parameter and optimizer-state bytes a rank; the parameters after the
    steps, gathered, held by rank 0 against the run without FSDP.  Rank
    0 writes ``out/zero.json``."""
    import numpy as np
    import torch

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_train_step,
        params_from_jax, params_to_numpy, shard_params)
    from chainermn_tpu_torch.models.transformer import _fsdp_dims
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel import MeshConfig, fsdp_gather
    from chainermn_tpu_torch.parallel.mesh import BATCH_AXES
    from chainermn_tpu_torch.testing import replicas_bitwise

    comm = cmn.create_communicator()
    dev = comm.device
    mesh = MeshConfig(comm, **_mesh_axes(mesh_spec))
    S, s = mesh.axis_size("pipe"), mesh.axis_index("pipe")
    if moe == "1":
        cfg = ep_config(schedule, M, k)
    else:
        cfg = TransformerConfig(**dict(
            FLAGSHIP, remat=True, pipeline_schedule=schedule,
            num_microbatches=int(M)))
        tree = init_numpy_params(cfg, SEED)

    def whole():
        """The whole tree on the card, drawn again for each run and
        dropped once cut, so no run's peak holds it."""
        if moe != "1":
            return params_from_jax(tree, cfg, dev)
        w = moe_params(torch, cfg, dev)
        comm.bcast_data(w)
        return w

    x, y = ep_batch(np, cfg)
    variants = ("dense", "fsdp", "fsdp_bf16") if name == "data4" \
        else ("dense", "fsdp")
    data, batch = mesh.comm("data"), mesh.comm(*BATCH_AXES)
    experts = ("w1", "w2") if cfg.moe and mesh.axis_size("expert") > 1 \
        else ()
    runs, gathered = {}, {}
    for variant in variants:
        c = dataclasses.replace(
            cfg, fsdp=variant != "dense",
            fsdp_wire_dtype="bfloat16" if variant == "fsdp_bf16" else "")
        params = shard_params(mesh, c, whole())
        opt = training.adamw(3e-4)
        state = opt.init(params)
        step = make_train_step(c, opt, mesh=mesh)
        sharded = set(_fsdp_dims(c)) if c.fsdp else set()
        over_data = [v for kk, v in params.items() if kk != "blocks"] + [
            v for kk, v in params["blocks"].items() if kk not in sharded]
        over_batch = [v for kk, v in params.items() if kk != "blocks"] + [
            v for kk, v in params["blocks"].items()
            if kk not in sharded and kk not in experts]
        resident = resident_bytes(torch, params, state)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, losses, equal = [], [], []
        torch.cuda.synchronize()
        fsdp_gather.gathers = 0
        fa.launches = fa.dq_launches = fa.dkv_launches = 0  # path starts
        for _ in range(SEQ_STEPS):
            comm.barrier()
            t0 = time.perf_counter()
            params, state, loss = step(params, state, x, y)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
            equal.append(replicas_bitwise(data, over_data)
                         and replicas_bitwise(batch, over_batch))
        torch.cuda.synchronize()
        runs[variant] = dict(                                   # ended
            launches=(fa.launches, fa.dq_launches, fa.dkv_launches),
            predicted=pp_predicted_launches(c, S, s, SEQ_STEPS),
            gathers=fsdp_gather.gathers, times_ms=times, losses=losses,
            ranks_equal=equal, resident_gb=resident / 1e9,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        flat = params_to_numpy(params, c, mesh=mesh)
        if comm.rank == 0:
            gathered[variant] = np.concatenate([
                a.ravel() for a in torch.utils._pytree.tree_leaves(flat)])
        del params, state, step, opt, flat, over_data, over_batch
        gc.collect()
        torch.cuda.empty_cache()
    if comm.rank == 0:
        ref = gathered["dense"]
        for variant in variants[1:]:
            runs[variant]["params_rel_l2_dense"] = float(
                np.linalg.norm(gathered[variant] - ref) / np.linalg.norm(ref))
    ranks = comm.allgather_obj(dict(rank=comm.rank, coords=mesh.coords,
                                    runs=runs))
    if comm.rank == 0:
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "zero.json").write_text(json.dumps(dict(
            name=name, mesh=mesh.shape, schedule=schedule, M=int(M),
            moe=moe == "1", top_k=int(k), world=comm.size,
            tokens=8 * cfg.max_seq, ranks=ranks)))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def zero_resnet_rank(out):
    """``--four-cards zero`` (e): :func:`zero_resnet_runs` on 4 NCCL
    ranks; rank 0 writes ``out/resnet.json``."""
    import numpy as np
    import torch

    import chainermn_tpu_torch as cmn

    comm = cmn.create_communicator()
    torch.backends.cudnn.benchmark = True
    res = zero_resnet_runs(torch, np, comm, card_name())
    if comm.rank == 0:
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "resnet.json").write_text(json.dumps(res))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def four_cards_zero(root, smi):
    """``--four-cards``' data-axis sharding: each of ``ZERO_FOUR`` on 4
    ranks (:func:`zero_rank`): (a) the flagship at data=4 with FSDP
    against the same mesh without it, (b) with the bf16 wire, (c) the
    MoE flagship at data=2,expert=2, top-2, (d) pipe=2,data=2 under
    1F1B, M=4; on each the first loss bitwise the run without FSDP and
    the later ones within ``ZERO_LOSS_REL``, the gathered parameters
    within ``ZERO_PARAMS_REL``, the replicated leaves bitwise after every
    step, every rank's flash launches those of the same mesh without
    FSDP (:func:`pp_predicted_launches`), the gathers the same on every
    rank; ms a step (the median of steps 2-3), peak GiB and resident
    parameter-plus-moment GB a rank.  Then (e) ResNet-50 under
    ``StandardUpdater`` at data=4 with ZeRO-1 and ZeRO-2 against the
    replicated exchange (:func:`zero_resnet_rank`).  Prints
    ``{"zero": {...}}``."""
    import numpy as np

    from chainermn_tpu_torch import _build

    out = root / "build" / "four_cards" / "zero"
    me = str(Path(__file__).resolve())
    _build.build_all()          # once, before the children load them
    report = {}
    for name, mesh, schedule, M, moe, k in ZERO_FOUR:
        subprocess.run(["torchrun", "--standalone", "--nproc_per_node", "4",
                        me, "--zero-rank", str(out / name), name, mesh,
                        schedule, M, moe, k], check=True, timeout=600)
        r = json.loads((out / name / "zero.json").read_text())
        lead = r["ranks"][0]["runs"]
        rep = {}
        for variant, v in lead.items():
            rep[variant] = dict(
                {kk: vv for kk, vv in v.items() if kk not in (
                    "launches", "predicted", "gathers", "peak_gib",
                    "resident_gb")},
                steady_ms=statistics.median(v["times_ms"][1:]),
                tokens_per_s_per_card=r["tokens"]
                / statistics.median(v["times_ms"][1:]) * 1e3 / r["world"],
                launches={q["rank"]: q["runs"][variant]["launches"]
                          for q in r["ranks"]},
                gathers={q["rank"]: q["runs"][variant]["gathers"]
                         for q in r["ranks"]},
                peak_gib=[q["runs"][variant]["peak_gib"]
                          for q in r["ranks"]],
                resident_gb=[q["runs"][variant]["resident_gb"]
                             for q in r["ranks"]])
        report[name] = rep
        dense = lead["dense"]
        for variant in lead:
            for q in r["ranks"]:
                v = q["runs"][variant]
                require(tuple(v["launches"]) == tuple(v["predicted"])
                        == tuple(q["runs"]["dense"]["launches"]),
                        f"{name} {variant} rank {q['rank']}: launches "
                        f"{v['launches']}, without fsdp "
                        f"{q['runs']['dense']['launches']}, predicted "
                        f"{v['predicted']}")
                require(all(v["ranks_equal"]),
                        f"{name} {variant}: replicas differ "
                        f"{v['ranks_equal']}")
                require(all(np.isfinite(v["losses"])),
                        f"{name} {variant}: {v['losses']}")
            if variant == "dense":
                continue
            require(len({q["runs"][variant]["gathers"]
                         for q in r["ranks"]}) == 1,
                    f"{name} {variant}: gathers differ by rank")
            rel = [abs(a - b) / abs(b) for a, b in zip(
                lead[variant]["losses"], dense["losses"])]
            rep[variant]["loss_rel_dense"] = rel
            require(all(e <= bar for e, bar in zip(rel, ZERO_LOSS_REL)),
                    f"{name} {variant}: losses {lead[variant]['losses']} "
                    f"against {dense['losses']}: relative {rel}, bars "
                    f"{ZERO_LOSS_REL}")
            require(lead[variant]["params_rel_l2_dense"] < ZERO_PARAMS_REL,
                    f"{name} {variant}: parameters rel L2 "
                    f"{lead[variant]['params_rel_l2_dense']}")
    subprocess.run(["torchrun", "--standalone", "--nproc_per_node", "4",
                    me, "--zero-resnet", str(out / "resnet")], check=True,
                   timeout=600)
    res = json.loads((out / "resnet" / "resnet.json").read_text())
    report["resnet50_data4"] = res
    print(json.dumps({"zero": dict(report, card=smi)}))
    z1, z2 = res["runs"]["zero1"], res["runs"]["zero2"]
    for mode, v in res["runs"].items():
        require(all(v["equal"]), f"resnet {mode}: replicas differ")
        require(all(np.isfinite(v["losses"])), f"resnet {mode}: losses")
    require(z1["sharding"] == "zero1" and z2["sharding"] == "zero2",
            "resnet: the updater's sharding")
    require(z1["params_rel_l2_replicated"] < ZERO_PARAMS_REL
            and z2["params_rel_l2_replicated"] < ZERO_PARAMS_REL,
            f"resnet: ZeRO against the replicated exchange: rel L2 "
            f"{z1['params_rel_l2_replicated']}, "
            f"{z2['params_rel_l2_replicated']}")
    require(z2["params_bitwise_zero1"], "resnet: ZeRO-2 is not ZeRO-1")
    return 0


# --------------------------------------------------------------------- #
# 20: the flagship's decode options on one card
# --------------------------------------------------------------------- #

# 8 prompts of 128 tokens, 128 generated; speculative k=4 with the
# flagship's first 2 blocks as the draft; prompt lookup k=4 over bigrams
# on prompts that repeat a 16-token pattern; beam search at 4 beams
DECODE_P, DECODE_NEW = 128, 128
SPEC_K, SPEC_DRAFT_LAYERS = 4, 2
LOOKUP_K, LOOKUP_NGRAM, LOOKUP_PATTERN = 4, 2, 16
BEAM_K = 4
# int8 weights' first decode step against bf16's on the same weights:
# per-channel int8 rounds each weight by up to half a scale (~0.8 %
# relative RMS for Gaussian rows), compounded over 24 layers; a broken
# scale is off by 100 %
INT8_LOGITS_REL = 0.2


def tree_nbytes(tree):
    import torch

    from chainermn_tpu_torch.training.optimizers import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if torch.is_tensor(t))


def timed_decode(torch, fn, warm):
    """``warm()`` (the same decoder over 2 new tokens: the products' and
    the allocator's first calls), then one timed ``fn()``: ``(its
    result, ms, peak GiB above what was resident before it)``."""
    warm()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, (torch.cuda.max_memory_allocated() - base) / 2**30


def first_mismatch(a, b):
    """The first (row, position) where two token arrays differ, or
    None."""
    import numpy as np

    diff = np.argwhere(np.asarray(a) != np.asarray(b))
    return None if not len(diff) else tuple(int(i) for i in diff[0])


def phase_decode_options(torch, np, smi):
    """20. The flagship's decode options at full width on one card
    (8 prompts of 128 tokens, 128 generated; weights drawn on the card):
    (a) the int8 tree (``quantize_params_int8``): its bytes against the
    fp32 tree's, and the first decode step's logits against bf16's on
    the same weights (rel L2, argmax agreement); (b) greedy decoding in
    bf16, with int8 weights, with the int8 KV cache and with both: ms a
    decode step (one token a row), tokens/s and the peak memory above
    what was resident; (c) in fp32 (TF32 off: a step and a verify
    chunk then round alike), the tokens of speculative decoding (k=4,
    the draft the flagship's first 2 blocks), prompt lookup (k=4,
    bigrams, prompts repeating a 16-token pattern) and 1-beam search
    held equal to greedy's, with the mean accepted proposals; (d) in
    bf16 the speculative, lookup and 4-beam runs timed, and one beam
    reorder of the 4-beam cache (the gather along the rows of every
    layer's cache, in place) on its own.  The decode path runs no flash
    kernel (attention over the cache is plain, as in the JAX package):
    the counts are 0 from the phase's start to its end.  Returns the
    printed metrics."""
    from chainermn_tpu_torch.models import (
        TransformerConfig, make_beam_search_fn, make_generate_fn,
        make_lookup_generate_fn, make_speculative_generate_fn,
        quantize_params_int8)
    from chainermn_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    P, NEW = DECODE_P, DECODE_NEW
    L = P + NEW
    cfg = TransformerConfig(**FLAGSHIP)
    fa.launches = fa.dq_launches = fa.dkv_launches = 0      # path starts
    params = moe_params(torch, cfg, dev)
    q8 = quantize_params_int8(cfg, params)
    rng = np.random.RandomState(SEED + 20)
    prompts = torch.as_tensor(rng.randint(0, cfg.vocab_size, (8, P)),
                              device=dev)
    metrics = dict(card=smi, tree_bytes=dict(
        fp32=tree_nbytes(params), int8=tree_nbytes(q8)))

    # (a) the first decode step, int8 weights against bf16
    _, lb = make_generate_fn(cfg, max_len=P + 1, with_logits=True)(
        params, prompts)
    _, lq = make_generate_fn(cfg, max_len=P + 1, with_logits=True,
                             quantized=True)(q8, prompts)
    metrics["first_step"] = dict(
        rel_l2=rel_err(lq, lb),
        argmax_agreement=(lq.argmax(-1) == lb.argmax(-1)).float()
        .mean().item())
    del lb, lq
    tb = metrics["tree_bytes"]
    print(f"decode (a): int8 tree {tb['int8'] / 2**30:.3f} GiB against "
          f"fp32 {tb['fp32'] / 2**30:.3f} GiB; first step's logits vs "
          f"bf16 weights: rel L2 {metrics['first_step']['rel_l2']:.3e}, "
          f"argmax agreement {metrics['first_step']['argmax_agreement']}")
    require(metrics["first_step"]["rel_l2"] < INT8_LOGITS_REL,
            f"(a) int8 logits off bf16's: {metrics['first_step']}")

    # (b) greedy, the four precisions
    kv8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    metrics["greedy"] = {}
    tokens = {}
    for name, (c, tree, quant) in dict(
            bf16=(cfg, params, False), int8_weights=(cfg, q8, True),
            int8_kv=(kv8, params, False),
            int8_both=(kv8, q8, True)).items():
        fn = make_generate_fn(c, max_len=L, quantized=quant)
        warm = make_generate_fn(c, max_len=P + 2, quantized=quant)
        toks, ms, peak = timed_decode(torch, lambda: fn(tree, prompts),
                                      lambda: warm(tree, prompts))
        require(toks.shape == (8, L) and bool(
            (toks[:, :P] == prompts).all()) and bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"(b) {name}: tokens {tuple(toks.shape)}")
        tokens[name] = toks.cpu().numpy()
        metrics["greedy"][name] = dict(
            ms=ms, ms_per_step=ms / NEW, tokens_per_s=8 * NEW / ms * 1e3,
            peak_gib=peak, tokens_equal_bf16=float(
                (tokens[name][:, P:] == tokens["bf16"][:, P:]).mean()))
        print(f"decode (b) {name}: {ms / NEW:.3f} ms a step (8 tokens), "
              f"{8 * NEW / ms * 1e3:.0f} tokens/s, peak {peak:.3f} GiB "
              f"above resident; generated tokens equal to bf16's "
              f"{metrics['greedy'][name]['tokens_equal_bf16']:.3f}")

    # (c) fp32: speculative, lookup and 1-beam against greedy
    f32 = dataclasses.replace(cfg, dtype="float32")
    d32 = dataclasses.replace(f32, n_layers=SPEC_DRAFT_LAYERS)
    draft = dict(params, blocks={k: v[:SPEC_DRAFT_LAYERS]
                                 for k, v in params["blocks"].items()})
    greedy = make_generate_fn(f32, max_len=L)(params, prompts).cpu().numpy()
    spec, acc = make_speculative_generate_fn(
        f32, d32, k=SPEC_K, max_len=L, with_stats=True)(params, draft,
                                                        prompts)
    pattern = rng.randint(0, cfg.vocab_size, (8, LOOKUP_PATTERN))
    lp = torch.as_tensor(np.tile(pattern, (1, P // LOOKUP_PATTERN)),
                         device=dev)
    greedy_lp = make_generate_fn(f32, max_len=L)(params, lp).cpu().numpy()
    look, l_acc = make_lookup_generate_fn(
        f32, k=LOOKUP_K, ngram=LOOKUP_NGRAM, max_len=L, with_stats=True)(
        params, lp)
    beam1, _ = make_beam_search_fn(f32, beam_size=1, max_len=L)(params,
                                                                prompts)
    metrics["fp32"] = dict(
        speculative_mean_accepted=float(acc),
        lookup_mean_accepted=float(l_acc),
        speculative_first_mismatch=first_mismatch(spec.cpu(), greedy),
        lookup_first_mismatch=first_mismatch(look.cpu(), greedy_lp),
        beam1_first_mismatch=first_mismatch(beam1[:, 0].cpu(), greedy))
    print(f"decode (c) fp32: speculative k={SPEC_K} ({SPEC_DRAFT_LAYERS}-"
          f"block draft) mean accepted {float(acc):.3f}, lookup k="
          f"{LOOKUP_K} mean accepted {float(l_acc):.3f}; first mismatch "
          f"against greedy: speculative "
          f"{metrics['fp32']['speculative_first_mismatch']}, lookup "
          f"{metrics['fp32']['lookup_first_mismatch']}, beam 1 "
          f"{metrics['fp32']['beam1_first_mismatch']}")
    for what in ("speculative", "lookup", "beam1"):
        require(metrics["fp32"][f"{what}_first_mismatch"] is None,
                f"(c) {what} tokens differ from greedy's at "
                f"{metrics['fp32'][f'{what}_first_mismatch']}")
    del spec, look, beam1

    # (d) bf16: the speculative, lookup and 4-beam runs timed
    dcfg = dataclasses.replace(cfg, n_layers=SPEC_DRAFT_LAYERS)
    spec_fn, spec_warm = (make_speculative_generate_fn(
        cfg, dcfg, k=SPEC_K, max_len=n, with_stats=True) for n in (L, P + 2))
    (_, acc), ms, peak = timed_decode(
        torch, lambda: spec_fn(params, draft, prompts),
        lambda: spec_warm(params, draft, prompts))
    metrics["speculative"] = dict(ms=ms, ms_per_token=ms / NEW,
                                  mean_accepted=float(acc), peak_gib=peak)
    look_fn, look_warm = (make_lookup_generate_fn(
        cfg, k=LOOKUP_K, ngram=LOOKUP_NGRAM, max_len=n, with_stats=True)
        for n in (L, P + 2))
    (_, l_acc), ms, peak = timed_decode(torch, lambda: look_fn(params, lp),
                                        lambda: look_warm(params, lp))
    metrics["lookup"] = dict(ms=ms, ms_per_token=ms / NEW,
                             mean_accepted=float(l_acc), peak_gib=peak)
    beam_fn, beam_warm = (make_beam_search_fn(cfg, beam_size=BEAM_K,
                                              max_len=n) for n in (L, P + 2))
    (btoks, scores), ms, peak = timed_decode(
        torch, lambda: beam_fn(params, prompts),
        lambda: beam_warm(params, prompts))
    require(btoks.shape == (8, BEAM_K, L) and bool(
        torch.isfinite(scores).all()) and bool(
        (scores[:, :-1] >= scores[:, 1:]).all()),
        f"(d) beam: tokens {tuple(btoks.shape)}, scores {scores}")
    metrics["beam"] = dict(ms=ms, ms_per_token=ms / NEW, peak_gib=peak)
    # one reorder of the 4-beam cache: every layer's K and V gathered
    # along the rows, in place
    cache = [torch.zeros((cfg.n_layers, 8 * BEAM_K, L, cfg.kv_heads,
                          cfg.d_head), dtype=torch.bfloat16, device=dev)
             for _ in range(2)]
    order = torch.randint(0, 8 * BEAM_K, (8 * BEAM_K,), device=dev)

    def reorder():
        for c in cache:
            c.copy_(c.index_select(1, order))

    metrics["beam"]["reorder_ms"] = cuda_ms(reorder, reps=10, runs=3)
    metrics["beam"]["reorder_bytes"] = 2 * 2 * sum(c.numel() * 2
                                                   for c in cache)
    metrics["beam"]["reorder_bound_ms"] = bound_ms(
        0, metrics["beam"]["reorder_bytes"])[0]
    del cache
    print(f"decode (d) bf16: speculative {metrics['speculative']['ms']:.1f}"
          f" ms ({metrics['speculative']['ms_per_token']:.3f} ms a token, "
          f"mean accepted {metrics['speculative']['mean_accepted']:.3f}); "
          f"lookup {metrics['lookup']['ms']:.1f} ms (mean accepted "
          f"{metrics['lookup']['mean_accepted']:.3f}); beam {BEAM_K} "
          f"{metrics['beam']['ms']:.1f} ms "
          f"({metrics['beam']['ms_per_token']:.3f} ms a token), one cache "
          f"reorder "
          f"{metrics['beam']['reorder_ms']:.3f} ms (bound "
          f"{metrics['beam']['reorder_bound_ms']:.3f} ms)")
    torch.cuda.synchronize()
    got = (fa.launches, fa.dq_launches, fa.dkv_launches)   # path ended
    require(got == (0, 0, 0), f"decoding launched the flash kernels {got}")
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"decode_options": metrics}))
    del params, q8
    gc.collect()
    torch.cuda.empty_cache()
    return got, metrics


# --------------------------------------------------------------------- #
# --four-cards seq/ep/dots: "dots" remat under ring, Ulysses and the
# expert axis
# --------------------------------------------------------------------- #

# (name, mesh, attention, layout, moe, top-k)
DOTS_FOUR = (
    ("dots_ring_contiguous", "seq=4", "ring", "contiguous", "0", "1"),
    ("dots_ring_zigzag", "seq=4", "ring", "zigzag", "0", "1"),
    ("dots_ulysses", "seq=4", "ulysses", "contiguous", "0", "1"),
    ("dots_expert4_top1", "expert=4", "flash", "contiguous", "1", "1"),
    ("dots_data2_expert2_top2", "data=2,expert=2", "flash", "contiguous",
     "1", "2"))
DOTS_REPS = 2


def dots_rank(out, name, mesh_spec, attention, layout, moe, k):
    """One rank (under torchrun, 4 ranks) of the flagship's gradients
    (8 x 2048 tokens, bf16; the MoE flagship's with ``moe`` = 1) over a
    mesh with a seq or an expert axis under remat ``"full"`` and
    ``"dots"``, from the same parameters: per policy a warm-up, then
    the flash launches counted from 0 around one ``value_and_grad``
    (beside :func:`seq_predicted_launches`, the forward once a layer
    under "dots"), then ``DOTS_REPS`` calls timed and the peak memory;
    the two policies' gradients compared bitwise (the largest difference
    otherwise).  Then one AdamW step under "dots" and the ranks' leaves
    compared bitwise: every leaf over the batch-like group, the experts
    over ``(data, seq)``.  Rank 0 writes ``out/dots.json``."""
    import numpy as np
    import torch

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_train_step,
        make_value_and_grad_fn, params_from_jax, shard_params)
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel import MeshConfig, zigzag_indices
    from chainermn_tpu_torch.parallel.mesh import BATCH_AXES
    from chainermn_tpu_torch.testing import replicas_bitwise

    comm = cmn.create_communicator()
    mesh = MeshConfig(comm, **_mesh_axes(mesh_spec))
    if moe == "1":
        cfg = ep_config("gpipe", 1, k)
        whole = moe_params(torch, cfg, comm.device)
        comm.bcast_data(whole)
        params = shard_params(mesh, cfg, whole)
        del whole
    else:
        cfg = TransformerConfig(**dict(FLAGSHIP, attention=attention,
                                       seq_layout=layout, remat=True))
        params = params_from_jax(init_numpy_params(cfg, SEED), cfg,
                                 comm.device, mesh=mesh)
    gc.collect()
    torch.cuda.empty_cache()
    toks = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (8, cfg.max_seq + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    if layout == "zigzag":
        perm = zigzag_indices(mesh.axis_size("seq"), cfg.max_seq).reshape(-1)
        x, y = x[:, perm], y[:, perm]
    mine = dict(rank=comm.rank, coords=mesh.coords, policies={})
    grads = {}
    for policy in ("full", "dots"):
        run = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        fn = make_value_and_grad_fn(run, mesh=mesh)
        fn(params, x, y)                                   # warm-up
        torch.cuda.synchronize()
        comm.barrier()
        fa.launches = fa.dq_launches = fa.dkv_launches = 0  # path starts
        loss, grads[policy] = fn(params, x, y)
        torch.cuda.synchronize()
        got = (fa.launches, fa.dq_launches, fa.dkv_launches)  # ended
        want = list(seq_predicted_launches(cfg, mesh, 1))
        if policy == "dots":
            want[0] = want[1]
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(DOTS_REPS):
            comm.barrier()
            t0 = time.perf_counter()
            fn(params, x, y)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        mine["policies"][policy] = dict(
            loss=loss.item(), launches=got, predicted=tuple(want),
            ms=statistics.median(times),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    diffs = [(a.float() - b.float()).abs().max().item() for a, b in zip(
        torch.utils._pytree.tree_leaves(grads["full"]),
        torch.utils._pytree.tree_leaves(grads["dots"]))]
    mine.update(grads_bitwise=max(diffs) == 0.0, max_abs_diff=max(diffs))
    del grads
    run = dataclasses.replace(cfg, remat=True, remat_policy="dots")
    opt = training.adamw(3e-4)
    state = opt.init(params)
    params, state, loss = make_train_step(run, opt, mesh=mesh)(
        params, state, x, y)
    torch.cuda.synchronize()
    experts = ("w1", "w2") if cfg.moe else ()
    repl = [v for kk, v in params.items() if kk != "blocks"] + [
        v for kk, v in params["blocks"].items() if kk not in experts]
    mine["step_loss"] = loss.item()
    mine["ranks_equal"] = replicas_bitwise(mesh.comm(*BATCH_AXES), repl) \
        and replicas_bitwise(mesh.comm("data", "seq"), [
            params["blocks"][kk] for kk in experts])
    ranks = comm.allgather_obj(mine)
    if comm.rank == 0:
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "dots.json").write_text(json.dumps(dict(
            name=name, mesh=mesh.shape, attention=cfg.attention,
            layout=layout, moe=cfg.moe, top_k=cfg.router_top_k,
            world=comm.size, ranks=ranks)))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def four_cards_dots(root, smi, runs=DOTS_FOUR):
    """Each of ``runs`` (:func:`dots_rank`) under torchrun on 4 ranks:
    every rank's flash launches under each policy what the schedule
    predicts (the forward once a layer and pair under "dots", twice
    under "full"), the losses of the two policies equal, and the ranks'
    leaves bitwise after a "dots" step; the gradients' largest
    difference between the policies (0 when bitwise) and each policy's
    ms and peak memory reported."""
    from chainermn_tpu_torch import _build

    out = root / "build" / "four_cards" / "dots"
    me = str(Path(__file__).resolve())
    _build.build_all()
    report = {}
    for name, *args in runs:
        subprocess.run(["torchrun", "--standalone", "--nproc_per_node", "4",
                        me, "--dots-rank", str(out / name), name, *args],
                       check=True, timeout=420)
        r = json.loads((out / name / "dots.json").read_text())
        ranks = r["ranks"]
        report[name] = dict(
            mesh=r["mesh"], moe=r["moe"], top_k=r["top_k"],
            grads_bitwise=all(q["grads_bitwise"] for q in ranks),
            max_abs_diff=max(q["max_abs_diff"] for q in ranks),
            ranks_equal=all(q["ranks_equal"] for q in ranks),
            **{pol: dict(
                ms=max(q["policies"][pol]["ms"] for q in ranks),
                peak_gib=max(q["policies"][pol]["peak_gib"]
                             for q in ranks),
                loss=ranks[0]["policies"][pol]["loss"],
                launches={q["rank"]: q["policies"][pol]["launches"]
                          for q in ranks},
                predicted={q["rank"]: q["policies"][pol]["predicted"]
                           for q in ranks}) for pol in ("full", "dots")})
        rep = report[name]
        print(f"dots {name} ({r['mesh']}): gradients bitwise full remat's "
              f"{rep['grads_bitwise']} (largest difference "
              f"{rep['max_abs_diff']:.3e}); value_and_grad "
              f"{rep['dots']['ms']:.1f} ms under dots, "
              f"{rep['full']['ms']:.1f} under full; peak "
              f"{rep['dots']['peak_gib']:.2f} / {rep['full']['peak_gib']:.2f}"
              f" GiB; launches by rank {rep['dots']['launches']}")
        for pol in ("full", "dots"):
            got = {int(k): tuple(v) for k, v in rep[pol]["launches"].items()}
            want = {int(k): tuple(v)
                    for k, v in rep[pol]["predicted"].items()}
            require(got == want, f"{name} {pol}: flash launches by rank "
                    f"{got}, the schedule predicts {want}")
        require(rep["ranks_equal"], f"{name}: ranks' leaves differ after "
                "a dots step")
        require(rep["full"]["loss"] == rep["dots"]["loss"],
                f"{name}: losses {rep['full']['loss']} (full) and "
                f"{rep['dots']['loss']} (dots)")
    print(json.dumps({"dots_four_cards": dict(report, card=smi)}))
    return 0


# --------------------------------------------------------------------- #
# 21: seq2seq and the convnets on one card; 22: shard-only sets;
# --four-cards elastic: resume at another world size
# --------------------------------------------------------------------- #

# phase 21 (a): each convnet at its native size, bf16, batch 64, 3
# StandardUpdater updates (the first a warm-up for the time); the
# parameter counts are the JAX package's (jax.eval_shape)
CONVNET_COUNTS = {"alex": 62_378_344, "nin": 7_595_176,
                  "vgg16": 138_357_544, "googlenet": 13_378_280}
CONVNET_B, CONVNET_UPDATES = 64, 3
# fp32 logits of the card against the CPU's, TF32 off: the convolution
# algorithms sum in other orders
CONVNET_FWD_REL = 1e-4
# (b) seq2seq at Seq2seqConfig()'s defaults on 64 ragged pairs of 3-50
# tokens: the loss and each gradient leaf against the CPU's (relative of
# the leaf's largest element), the greedy tokens equal
S2S_PAIRS, S2S_MAX = 64, 50
S2S_REL = 1e-5
S2S_STEPS = 5


def leaves_rel(torch, got, want):
    """The largest ``max|a - b| / max|b|`` over two lists of tensors."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        worst = max(worst, ((a - b).abs().max()
                            / b.abs().max().clamp_min(1e-30)).item())
    return worst


def convnet_runs(torch, np, comm):
    """21 (a): each of AlexNet, NiN, VGG-16 and GoogLeNet at its native
    size (reference geometry): its parameter count, one fp32 forward's
    logits on 2 images against the CPU's on the same numpy parameters,
    and ``CONVNET_UPDATES`` bf16 updates of ``sgd(0.01, momentum=0.9)``
    under ``StandardUpdater`` on ``CONVNET_B`` seeded images (GoogLeNet
    with its aux loss): ms an update, images/s, peak GiB."""
    import torch.utils._pytree as pytree

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import (
        ConvNetConfig, convnet_apply, convnet_params_from_jax,
        init_convnet_numpy, softmax_cross_entropy)

    out = {}
    for arch in ("alex", "nin", "vgg16", "googlenet"):
        cfg = ConvNetConfig(arch=arch)
        tree = init_convnet_numpy(cfg, SEED)
        n = sum(a.size for a in pytree.tree_leaves(tree))
        require(n == CONVNET_COUNTS[arch],
                f"{arch}: {n} parameters, the JAX package has "
                f"{CONVNET_COUNTS[arch]}")
        size = cfg.insize
        rng = np.random.default_rng(SEED)
        x = rng.standard_normal((CONVNET_B, size, size, 3), dtype=np.float32)
        y = rng.integers(0, cfg.num_classes, CONVNET_B).astype(np.int32)
        f32 = dataclasses.replace(cfg, dtype="float32")
        with torch.no_grad():
            card = convnet_apply(f32, convnet_params_from_jax(
                tree, f32, device=comm.device), torch.as_tensor(
                x[:2], device=comm.device)).cpu()
            host = convnet_apply(f32, convnet_params_from_jax(
                tree, f32, device="cpu"), torch.as_tensor(x[:2]))
        fwd_rel = rel_err(card, host)
        require(fwd_rel < CONVNET_FWD_REL,
                f"{arch}: fp32 logits off the CPU's: rel L2 {fwd_rel}")
        aux = arch == "googlenet"

        def loss_fn(p, xb, yb, cfg=cfg, aux=aux):
            if aux:
                logits, a1, a2 = convnet_apply(cfg, p, xb, with_aux=True)
                return (softmax_cross_entropy(logits, yb)
                        + 0.3 * (softmax_cross_entropy(a1, yb)
                                 + softmax_cross_entropy(a2, yb)))
            return softmax_cross_entropy(convnet_apply(cfg, p, xb), yb)

        params = convnet_params_from_jax(tree, cfg, device=comm.device)
        del tree
        opt = training.create_multi_node_optimizer(
            training.sgd(0.01, momentum=0.9), comm)
        up = training.StandardUpdater(
            SerialIterator(list(zip(x, y)), CONVNET_B, shuffle=False), opt,
            loss_fn, params, comm)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(CONVNET_UPDATES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            up.update()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(up.observation["main/loss"]))
        require(all(np.isfinite(losses)), f"{arch}: losses {losses}")
        ms = statistics.median(times[1:])
        out[arch] = dict(size=size, params=n, fwd_rel_l2_cpu=fwd_rel,
                         losses=losses, times_ms=times, step_ms=ms,
                         images_per_s=CONVNET_B / ms * 1e3,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"21 (a) {arch} at {size} px, {n} parameters: fp32 logits vs "
              f"CPU rel L2 {fwd_rel:.3e}; bf16 batch {CONVNET_B}: "
              f"{ms:.2f} ms an update = {CONVNET_B / ms * 1e3:.1f} "
              f"images/s, peak {out[arch]['peak_gib']:.2f} GiB, losses "
              f"{losses}")
        del up, opt, params, x
    return out


def seq2seq_runs(torch, np, comm, root):
    """21 (b): seq2seq at ``Seq2seqConfig()``'s defaults on the
    example's ``make_dataset`` of ``S2S_PAIRS`` ragged pairs of 3 to
    ``S2S_MAX`` tokens: the loss and gradients against the CPU's, the
    greedy tokens equal, ms an ``adam`` step, real target tokens/s, and
    one step's host launches and device kernels."""
    import torch.utils._pytree as pytree

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        Seq2seqConfig, init_seq2seq_numpy, seq2seq_loss,
        seq2seq_params_from_jax, seq2seq_translate)

    ex = load_example(root, "examples/seq2seq/seq2seq_torch.py",
                      "seq2seq_torch")
    cfg = Seq2seqConfig()
    train, test = ex.make_dataset(n=S2S_PAIRS, vocab=cfg.src_vocab,
                                  max_len=S2S_MAX, seed=SEED)
    src, tgt = ex.make_converter(S2S_MAX, S2S_MAX + 1)(train + test)
    tree = init_seq2seq_numpy(cfg, SEED)
    n = sum(a.size for a in pytree.tree_leaves(tree))

    def value_and_grad(dev):
        p = seq2seq_params_from_jax(tree, cfg, device=dev)
        leaves = pytree.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = seq2seq_loss(cfg, p, src, tgt)
        return p, loss.detach(), torch.autograd.grad(loss, leaves)

    params, loss, grads = value_and_grad(comm.device)
    host_p, host_loss, host_grads = value_and_grad("cpu")
    loss_rel = abs(loss.item() - host_loss.item()) / abs(host_loss.item())
    grad_rel = leaves_rel(torch, grads, host_grads)
    require(loss_rel <= S2S_REL and grad_rel <= S2S_REL,
            f"seq2seq: loss rel {loss_rel}, gradients rel {grad_rel} "
            f"against the CPU's (bar {S2S_REL})")
    toks = seq2seq_translate(cfg, params, src, max_len=S2S_MAX + 1).cpu()
    host_toks = seq2seq_translate(cfg, host_p, src, max_len=S2S_MAX + 1)
    require(torch.equal(toks, host_toks), "seq2seq: greedy tokens differ "
            "from the CPU's")
    opt = training.adam(1e-3)
    state = opt.init(params)
    leaves, spec = pytree.tree_flatten(params)

    def step():
        g = torch.autograd.grad(seq2seq_loss(cfg, params, src, tgt), leaves)
        opt.update(pytree.tree_unflatten(list(g), spec), state, params)

    step()                                        # warm-up
    times = []
    for _ in range(S2S_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    host, kernels = host_launches(torch, step)
    real = int((tgt != 0).sum())
    res = dict(params=n, pairs=S2S_PAIRS, real_target_tokens=real,
               loss=loss.item(), loss_rel_cpu=loss_rel,
               grad_rel_cpu=grad_rel, tokens_equal_cpu=True,
               times_ms=times, step_ms=ms,
               target_tokens_per_s=real / ms * 1e3,
               host_launches_a_step=host, device_kernels_a_step=kernels)
    print(f"21 (b) seq2seq {n / 1e6:.2f} M parameters, {S2S_PAIRS} pairs "
          f"({real} real target tokens): loss rel {loss_rel:.2e} and "
          f"gradients rel {grad_rel:.2e} vs CPU, greedy tokens equal; an "
          f"adam step {ms:.2f} ms = {real / ms * 1e3:.0f} target "
          f"tokens/s, {host} host launches and {kernels} device kernels "
          "a step")
    return res


def seq2seq_example_run(root):
    """21 (c): ``seq2seq_torch.py --epoch 2`` on the card in a process
    of its own (a one-rank world of its own): its epochs' losses, which
    must fall, and its exact-match line."""
    import os
    import re

    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(root / "examples" / "seq2seq" /
                             "seq2seq_torch.py"), "--epoch", "2",
         "--device", "cuda", "--out",
         str(root / "build" / "chip_smoke" / "seq2seq")],
        capture_output=True, text=True, timeout=600, env=env)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"seq2seq_torch.py exited "
            f"{proc.returncode}: {proc.stderr[-2000:]}")
    losses = [float(m) for m in re.findall(r"main/loss=([0-9.eE+-]+)",
                                            proc.stdout)]
    match = re.findall(r"greedy exact-match on (\d+) held-out pairs: "
                       r"([0-9.]+)", proc.stdout)
    require(len(losses) == 2 and losses[1] < losses[0] and match,
            f"seq2seq_torch.py: losses {losses}, {proc.stdout[-1000:]}")
    print(f"21 (c) seq2seq_torch.py --epoch 2: losses {losses}, greedy "
          f"exact-match {match[0][1]} on {match[0][0]} pairs, {wall:.1f} s")
    return dict(losses=losses, exact_match=float(match[0][1]),
                wall_s=wall)


def phase_models(torch, np, root, smi, comm):
    """21. The other example models on one card (TF32 off): (a) the
    convnets (:func:`convnet_runs`), (b) seq2seq (:func:`seq2seq_runs`),
    (c) the seq2seq example end to end.  No hand-written kernel runs:
    the counts stay at 0.  Prints ``{"models_one_card": {...}}``."""
    from chainermn_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the path starts
    res = dict(convnets=convnet_runs(torch, np, comm),
               seq2seq=seq2seq_runs(torch, np, comm, root),
               example=seq2seq_example_run(root))
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)
    require(counts == (0, 0, 0), f"phase 21 launched the flash kernels "
            f"{counts} times")
    res.update(card=smi, launches=list(counts),
               phase_s=time.perf_counter() - t0)
    print(json.dumps({"models_one_card": res}))
    return counts, res


# 22 and --four-cards elastic: ResNet-50 under ZeRO-1 (sync BN, 224 px,
# sgd(0.1, momentum=0.9), fp32 wire) on one global batch of 128 seeded
# images, split evenly over the ranks (32 a rank at world 4)
ELASTIC_B = 128
ELASTIC_AT, ELASTIC_TO = 2, 2
# the post-resume updates against the uninterrupted world-4 run: the
# ranks' shares (gradients, sync BN's moments, the loss) are summed in
# another order (Queue C check 3: each mean within 3u/(1-3u)·Σ|g|/4 of
# the exact one), which the bf16 activations' roundings and sgd
# momentum grow; on the card ZeRO-1 against the replicated exchange
# drifted 2.8e-5 in 4 updates (PR 15)
ELASTIC_LOSS_REL = 1e-4
ELASTIC_PARAMS_REL = 1e-4


def elastic_resnet_job(torch, np, comm, ckpt, shard_only=True,
                       global_batch=ELASTIC_B):
    """A ZeRO-1 ResNet-50 job on this rank's share of the global batch
    (the same images whatever the world), with an ``elastic=True``
    checkpointer; returns ``(trainer, updater, checkpointer)``."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import (
        ResNetConfig, init_resnet_numpy, resnet_apply,
        resnet_params_from_jax, softmax_cross_entropy)

    cfg = ResNetConfig()
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal((global_batch, 224, 224, 3), dtype=np.float32)
    y = rng.integers(0, 1000, global_batch).astype(np.int32)
    n = global_batch // comm.size
    lo = comm.rank * n
    params, state = resnet_params_from_jax(
        *init_resnet_numpy(cfg, SEED), cfg, device=comm.device)

    def loss_fn(prm, st, xb, yb):
        logits, new = resnet_apply(cfg, prm, st, xb, train=True, comm=comm)
        return softmax_cross_entropy(logits, yb), new

    opt = training.create_multi_node_optimizer(
        training.sgd(0.1, momentum=0.9), comm, zero1=True)
    up = training.StandardUpdater(
        SerialIterator(list(zip(x[lo:lo + n], y[lo:lo + n])), n,
                       shuffle=False), opt, loss_fn, params, comm,
        state=state)
    trainer = training.Trainer(up, (ELASTIC_AT + 2, "iteration"),
                               out=str(Path(ckpt).parent / "out"))
    cp = create_multi_node_checkpointer(comm, str(ckpt), elastic=True,
                                        shard_only=shard_only)
    return trainer, up, cp


def timed_ms(torch, fn):
    """``(fn(), ms)`` of one call, the card synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def set_bytes(ckpt):
    """``{filename: bytes}`` of a checkpoint directory."""
    import os

    return {fn: os.path.getsize(Path(ckpt) / fn)
            for fn in sorted(os.listdir(ckpt))}


def phase_shard_only(torch, np, root, smi, comm):
    """22. Shard-only sets on one card (in the one-rank NCCL world):
    ResNet-50 under ZeRO-1, 2 updates, then one full and one shard-only
    save of the same state; each resumed into a fresh job by an
    ``elastic=True`` checkpointer takes the exact path, and the two
    resumed states are bitwise each other and the saved one.  Prints
    ``{"shard_only_one_card": {...}}`` with save and load ms and the
    set bytes."""
    import shutil

    from chainermn_tpu_torch.ops import flash_attention as fa

    base = root / "build" / "chip_smoke" / "shard_only"
    shutil.rmtree(base, ignore_errors=True)
    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the path starts
    _, up, _ = elastic_resnet_job(torch, np, comm, base / "x",
                                  global_batch=ZERO_RESNET_B)
    up.update()
    up.update()
    saved = grab(torch, up)
    res = {}
    for name, shard_only in (("full", False), ("shard_only", True)):
        _, _, cp = elastic_resnet_job(torch, np, comm, base / name,
                                      shard_only=shard_only,
                                      global_batch=ZERO_RESNET_B)
        _, save_ms = timed_ms(torch, lambda: cp.save(up))
        _, again, cp2 = elastic_resnet_job(torch, np, comm, base / name,
                                           shard_only=shard_only,
                                           global_batch=ZERO_RESNET_B)
        at, load_ms = timed_ms(torch, lambda: cp2.maybe_load(again))
        got = grab(torch, again)
        same = {k: tree_diff(torch, np, got[k], saved[k])[0]
                for k in ("params", "state", "opt")}
        require(at == 2 and cp2.last_resume_mode == "exact"
                and all(same.values()),
                f"22 {name}: resumed at {at} by {cp2.last_resume_mode}, "
                f"bitwise {same}")
        res[name] = dict(save_ms=save_ms, load_ms=load_ms,
                         mode=cp2.last_resume_mode, bitwise=same,
                         bytes=set_bytes(base / name))
        res[name]["resumed"] = got
        del again, cp2
    eq = {k: tree_diff(torch, np, res["shard_only"]["resumed"][k],
                       res["full"]["resumed"][k])[0]
          for k in ("params", "state", "opt")}
    require(all(eq.values()), f"22: shard-only resume not the full's {eq}")
    for name in res:
        res[name].pop("resumed")
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)
    require(counts == (0, 0, 0), f"phase 22 launched {counts}")
    res.update(card=smi, shard_only_bitwise_full=True, images=ZERO_RESNET_B)
    print(f"22 shard-only at world 1: save {res['shard_only']['save_ms']:.1f}"
          f" ms, load {res['shard_only']['load_ms']:.1f} ms (full "
          f"{res['full']['save_ms']:.1f} / {res['full']['load_ms']:.1f}); "
          "both resumes exact and bitwise")
    print(json.dumps({"shard_only_one_card": res}))
    return res


def _world_rows_bitwise(torch, np, up, ckpt, it):
    """Whether this rank's ZeRO state is bitwise row ``rank`` of the
    from-scratch sharding, at this world, of the state gathered from
    the shard-only set of iteration ``it`` in ``ckpt`` (read and
    assembled here on the host)."""
    import os

    from chainermn_tpu_torch.parallel.sharded_state import (
        gather_state_leaves, shard_state_leaves)
    from chainermn_tpu_torch.training import optimizer_state_tree
    from chainermn_tpu_torch.training.elastic import rank_state_row
    from chainermn_tpu_torch.utils.serialization import (
        assemble_shard_state, load_state_with_stamps)

    parts, topo = [], None
    for fn in sorted(os.listdir(ckpt)):
        if fn.startswith(f"snapshot_iter_{it}.s"):
            tree, t, sp = load_state_with_stamps(str(Path(ckpt) / fn))
            topo = t if sp["root"] else topo
            parts.append((sp, tree))
    stacked = assemble_shard_state(parts)["opt_state"]
    recs = topo["opt_leaves"]
    want = rank_state_row(shard_state_leaves(gather_state_leaves(
        stacked, recs), recs, up.comm.size), recs, up.comm.rank)
    return tree_diff(torch, np, optimizer_state_tree(up.opt_state),
                     want)[0]


def elastic_rank(out, step):
    """One rank of ``--four-cards elastic``'s drill (under torchrun):
    ``save`` at world 4 (``FaultPlan(resize_at_iteration=2,
    resize_to=2)`` through a shard-only checkpointer, a full save beside
    it for the bytes, then the uninterrupted run's updates 3-4),
    ``resume`` at world 2 or 1 from that set (the re-laid state against
    the from-scratch sharding, updates 3-4; at 2 a shard-only save at
    iteration 4 for the grow), ``grow`` at world 4 from the world-2 set.
    Rank 0 writes ``out/{step}_{world}.json``."""
    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.testing import FaultInjector, FaultPlan

    comm = cmn.create_communicator()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    out = Path(out)
    W = comm.size
    res = dict(step=step, world=W, card=card_name())

    def updates(up, k):
        losses = []
        for _ in range(k):
            up.update()
            losses.append(float(up.observation["main/loss"]))
        return losses

    def params_flat(up):
        return np.concatenate([t.detach().float().cpu().numpy().ravel()
                               for t in pytree.tree_leaves(up.params)])

    if step == "save":
        trainer, up, cp = elastic_resnet_job(torch, np, comm,
                                             out / "drill" / "ckpt")
        save_ms = []
        real = cp.save

        def timed_save(*a, **k):
            _, ms = timed_ms(torch, lambda: real(*a, **k))
            save_ms.append(ms)

        cp.save = timed_save
        injector = FaultInjector(FaultPlan(resize_at_iteration=ELASTIC_AT,
                                           resize_to=ELASTIC_TO), comm,
                                 checkpointer=cp)
        trainer.extend(injector, trigger=(1, "iteration"))
        trainer.run()
        require(up.iteration == ELASTIC_AT and injector.fired == [
            ("resize", ELASTIC_AT, ELASTIC_TO)], f"fired {injector.fired}")
        _, _, full = elastic_resnet_job(torch, np, comm,
                                        out / "full" / "ckpt",
                                        shard_only=False)
        _, full_ms = timed_ms(torch, lambda: full.save(up))
        res.update(save_ms=comm.allgather_obj(save_ms[0]),
                   full_save_ms=comm.allgather_obj(full_ms),
                   losses_after=updates(up, 2))
    else:
        src = "grow" if step == "grow" else "drill"
        _, up, cp = elastic_resnet_job(torch, np, comm, out / src / "ckpt")
        at, load_ms = timed_ms(torch, lambda: cp.maybe_load(up))
        it = up.iteration
        res.update(at=at, mode=cp.last_resume_mode,
                   load_ms=comm.allgather_obj(load_ms),
                   bitwise=comm.allgather_obj(_world_rows_bitwise(
                       torch, np, up, out / src / "ckpt", it)))
        if step == "resume":
            res["losses_after"] = updates(up, 2)
            if W == ELASTIC_TO:
                _, _, grow = elastic_resnet_job(torch, np, comm,
                                                out / "grow" / "ckpt")
                grow.save(up)
    if comm.rank == 0:
        if "losses_after" in res:
            np.save(out / f"params_{step}_{W}.npy", params_flat(up))
        (out / f"{step}_{W}.json").write_text(json.dumps(res))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


# --four-cards elastic (ii): a 4-layer LSTM, one layer a stage, at the
# seq2seq width; (iii) seq2seq data-parallel at 4 ranks
RNN_SHAPE = dict(L=4, D=256, B=64, T=50)
RNN_REL = 1e-6        # the chain's outputs against one card's stack
RNN_GRAD_REL = 1e-5   # the owner sums 4 equal cotangents, then / 4
S2S_DP_REL = 1e-5     # the ranks' token-weighted shares, summed


def rnn_dp_rank(out):
    """``--four-cards elastic`` (ii) and (iii) on one rank (under
    torchrun, 4 ranks): (ii) ``create_multi_node_n_step_rnn`` over the 4
    ranks on ragged masks, its ``(ys, hy, cy)`` and each stage's
    reduced gradients of ``sum(ys²)`` against this card's sequential
    stack, ms a forward and backward (the median of 3 after a
    warm-up); (iii) one seq2seq gradient at ``Seq2seqConfig()``'s
    defaults on a ragged global batch of 64 pairs, 16 a rank, each
    rank's loss weighted by its share of the real target tokens and the
    gradients summed, against this card's on the whole batch.  Rank 0
    writes ``out/rnn_dp.json``."""
    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.links import create_multi_node_n_step_rnn
    from chainermn_tpu_torch.links.n_step_rnn import stage_apply
    from chainermn_tpu_torch.models import (
        Seq2seqConfig, chain_params_from_jax, init_seq2seq_numpy,
        seq2seq_loss, seq2seq_params_from_jax)

    comm = cmn.create_communicator()
    torch.backends.cuda.matmul.allow_tf32 = False
    r, W = comm.rank, comm.size
    L, D, B, T = (RNN_SHAPE[k] for k in ("L", "D", "B", "T"))
    chain = create_multi_node_n_step_rnn(L, D, D, L, comm=comm)
    tree = [c.init(SEED + i) for i, c in enumerate(chain.components)]
    chain.load_params(chain_params_from_jax(tree, chain))
    rng = np.random.default_rng(SEED)
    xs = rng.standard_normal((B, T, D), dtype=np.float32)
    lens = rng.integers(3, T + 1, B)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    x = torch.as_tensor(xs * mask[..., None], device=comm.device)
    m = torch.as_tensor(mask, device=comm.device)

    def fwd_bwd():
        for p in chain.parameters():
            p.grad = None
        ys, hy, cy = chain((x, m))
        (ys ** 2).sum().backward()
        return ys, hy, cy

    ys, hy, cy = fwd_bwd()
    times = [timed_ms(torch, fwd_bwd)[1] for _ in range(3)]
    grads = chain.reduce_grads(chain.grads())
    seq = [pytree.tree_map(lambda a: torch.tensor(
        a, device=comm.device, requires_grad=True), layer)
        for stage in tree for layer in stage]
    s_ys, s_hy, s_cy = stage_apply(seq, x, m, "lstm")
    (s_ys ** 2).sum().backward()
    mine = [layer for layer, c in zip(seq, chain.components)
            if c.owner == r]
    rnn = dict(
        ys_rel=leaves_rel(torch, [ys], [s_ys]),
        hy_rel=leaves_rel(torch, [hy, cy], [s_hy[-1:], s_cy[-1:]]),
        grad_rel=leaves_rel(
            torch, [g for g in pytree.tree_leaves(grads[r])],
            [t.grad for t in pytree.tree_leaves(mine)]),
        times_ms=times, ms=statistics.median(times))

    # (iii) seq2seq data-parallel
    ex = load_example(Path(__file__).resolve().parent,
                      "examples/seq2seq/seq2seq_torch.py", "seq2seq_torch")
    cfg = Seq2seqConfig()
    train, test = ex.make_dataset(n=S2S_PAIRS, vocab=cfg.src_vocab,
                                  max_len=S2S_MAX, seed=SEED)
    src, tgt = ex.make_converter(S2S_MAX, S2S_MAX + 1)(train + test)
    s2s = init_seq2seq_numpy(cfg, SEED)

    def grads_of(rows, weight):
        p = seq2seq_params_from_jax(s2s, cfg, device=comm.device)
        leaves = pytree.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = seq2seq_loss(cfg, p, src[rows], tgt[rows]) * weight
        return torch.autograd.grad(loss, leaves)

    n = S2S_PAIRS // W
    rows = slice(r * n, (r + 1) * n)
    tokens = (tgt != 0).sum(1)
    share = float(tokens[rows].sum()) / float(tokens.sum())
    dp = [comm.allreduce(g, "sum") for g in grads_of(rows, share)]
    one = grads_of(slice(None), 1.0)
    s2s_res = dict(grad_rel=leaves_rel(torch, dp, one), share=share)
    res = dict(rnn=comm.allgather_obj(rnn), seq2seq=comm.allgather_obj(
        s2s_res), shape=RNN_SHAPE, card=card_name())
    if r == 0:
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "rnn_dp.json").write_text(json.dumps(res))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def four_cards_elastic(root, smi):
    """``--four-cards elastic``: what exists only across cards.  (i) The
    shrink/grow drill on ResNet-50 under ZeRO-1 (:func:`elastic_rank`):
    saved at world 4 as a shard-only set, resumed at 2 and at 1 (each
    rank's re-laid state bitwise the from-scratch sharding; two more
    updates within ``ELASTIC_LOSS_REL`` and ``ELASTIC_PARAMS_REL`` of the
    uninterrupted world-4 run), grown 2 → 4 (bitwise); set bytes a rank
    against a full save's, save and resume ms.  (ii) and (iii)
    (:func:`rnn_dp_rank`).  Prints ``{"elastic": {...}}``."""
    import shutil

    import numpy as np

    out = root / "build" / "four_cards" / "elastic"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    me = str(Path(__file__).resolve())
    t0 = time.perf_counter()

    def launch(n, *args):
        subprocess.run(["torchrun", "--standalone", "--nproc_per_node",
                        str(n), me, *args], check=True, timeout=600)

    launch(4, "--elastic-rank", str(out), "save")
    launch(2, "--elastic-rank", str(out), "resume")
    launch(1, "--elastic-rank", str(out), "resume")
    launch(4, "--elastic-rank", str(out), "grow")
    launch(4, "--rnn-dp-rank", str(out))
    runs = {f.stem: json.loads(f.read_text()) for f in out.glob("*.json")}
    straight = np.load(out / "params_save_4.npy")
    base = runs["save_4"]["losses_after"]
    report = dict(card=smi, drill={}, command_s=None)
    for name in ("resume_2", "resume_1", "grow_4"):
        r = runs[name]
        require(r["at"] in (ELASTIC_AT, ELASTIC_AT + 2)
                and r["mode"] == "relayout" and all(r["bitwise"]),
                f"{name}: resumed at {r['at']} by {r['mode']}, bitwise "
                f"{r['bitwise']}")
        rep = dict(at=r["at"], mode=r["mode"], bitwise=r["bitwise"],
                   load_ms=r["load_ms"])
        if "losses_after" in r:
            got = np.load(out / f"params_{name}.npy")
            rep["loss_rel"] = [abs(a - b) / abs(b) for a, b in
                               zip(r["losses_after"], base)]
            rep["params_rel_l2"] = float(np.linalg.norm(got - straight)
                                         / np.linalg.norm(straight))
            require(max(rep["loss_rel"]) <= ELASTIC_LOSS_REL
                    and rep["params_rel_l2"] <= ELASTIC_PARAMS_REL,
                    f"{name}: after 2 updates losses rel {rep['loss_rel']}"
                    f", parameters rel L2 {rep['params_rel_l2']} against "
                    "the uninterrupted world-4 run")
        report["drill"][name] = rep
    shard = set_bytes(out / "drill" / "ckpt")
    full = set_bytes(out / "full" / "ckpt")
    report["drill"]["save_4"] = dict(
        save_ms=runs["save_4"]["save_ms"],
        full_save_ms=runs["save_4"]["full_save_ms"],
        shard_bytes=shard, full_bytes=full,
        set_over_full=sum(shard.values()) / sum(full.values()))
    rd = runs["rnn_dp"]
    for q in rd["rnn"]:
        require(q["ys_rel"] <= RNN_REL and q["hy_rel"] <= RNN_REL
                and q["grad_rel"] <= RNN_GRAD_REL,
                f"n-step RNN against one card: {q}")
    require(all(q["grad_rel"] <= S2S_DP_REL for q in rd["seq2seq"]),
            f"seq2seq data-parallel against one card: {rd['seq2seq']}")
    report.update(rnn=rd["rnn"], seq2seq_dp=rd["seq2seq"],
                  rnn_shape=rd["shape"])
    report["command_s"] = time.perf_counter() - t0
    print(json.dumps({"elastic": report}))
    return 0


# --------------------------------------------------------------------- #
# 23 and --four-cards live: the sinks and the live resize
# --------------------------------------------------------------------- #

# the checkpoint spans phase 23 (a) must find in the trace
SINK_SPANS = ("checkpoint/save", "checkpoint/crc_walk",
              "checkpoint/save_shard", "checkpoint/resume",
              "checkpoint/load")
SPAN_COST_CALLS, SPAN_COST_BLOCKS = 1000, 100      # 100k calls a median
SINK_UPDATE_PAIRS = 8           # timed updates a phase-23 (a) arm
# --four-cards live: ResNet-50 under ZeRO-1 on a global batch of 128,
# live 4 -> 2 at iteration 2 and back to 4 at 4, 6 updates
LIVE_B, LIVE_SET = 128, 256
LIVE_AT, LIVE_BACK, LIVE_STOP = 2, 4, 6
LIVE_MEM_SLACK = 64 * 2**20


def card_memory(torch):
    """The card's memory in bytes, after the caching allocator returned
    its free segments: ``used`` as ``cudaMemGetInfo`` counts it (what
    NVML and nvidia-smi report: every context's allocations, NCCL's
    buffers included); ``reserved``, the allocator's segments left, so
    that ``used - reserved`` lies outside it (the context, NCCL, the
    library handles); ``allocated``, its live tensors, so that
    ``reserved - allocated`` is the segments' unused part."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return dict(used=total - free, reserved=torch.cuda.memory_reserved(),
                allocated=torch.cuda.memory_allocated())


def live_resnet_job(torch, np, comm, root, stop=LIVE_STOP, n=LIVE_SET,
                    batch=LIVE_B):
    """ResNet-50 (sync BN over the updater's communicator, 224 px,
    ``sgd(0.1, momentum=0.9)``, fp32 wire) under ZeRO-1 on the
    global-batch feed: every rank iterates the same seeded ``n`` images
    in the same shuffled order, ``batch`` a step, and takes its rows.
    Returns ``(trainer, updater)``."""
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.iterators import (
        GlobalBatchConverter, SerialIterator)
    from chainermn_tpu_torch.models import (
        ResNetConfig, init_resnet_numpy, resnet_apply,
        resnet_params_from_jax, softmax_cross_entropy)

    cfg = ResNetConfig()
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal((n, 224, 224, 3), dtype=np.float32)
    y = rng.integers(0, 1000, n).astype(np.int32)
    params, state = resnet_params_from_jax(
        *init_resnet_numpy(cfg, SEED), cfg, device=comm.device)
    box = []

    def loss_fn(prm, st, xb, yb):
        # the updater's communicator of the moment: a live resize
        # rebinds it
        logits, new = resnet_apply(cfg, prm, st, xb, train=True,
                                   comm=box[0].comm)
        return softmax_cross_entropy(logits, yb), new

    up = training.StandardUpdater(
        SerialIterator((x, y), batch, shuffle=True, seed=7),
        live_opt(comm), loss_fn, params, comm, state=state,
        converter=GlobalBatchConverter(comm))
    box.append(up)
    return training.Trainer(up, (stop, "iteration"),
                            out=str(Path(root) / "out")), up


def live_opt(comm):
    from chainermn_tpu_torch import training

    return training.create_multi_node_optimizer(
        training.sgd(0.1, momentum=0.9), comm, zero1=True)


def live_world(n):
    """The live resize's world: the launch's ranks ``[0, n)`` (every
    rank calls it; ``None`` outside)."""
    from chainermn_tpu_torch.communicators import create_communicator

    return create_communicator(ranks=range(n))


def span_cost_us(rec):
    """Host µs of one ``with rec.span(...)``: the median over
    ``SPAN_COST_BLOCKS`` blocks of ``SPAN_COST_CALLS`` calls."""
    per = []
    for _ in range(SPAN_COST_BLOCKS):
        t0 = time.perf_counter()
        for _ in range(SPAN_COST_CALLS):
            with rec.span("step/probe", cat="probe"):
                pass
        per.append((time.perf_counter() - t0) / SPAN_COST_CALLS * 1e6)
    rec.clear()
    return statistics.median(per)


def phase_sinks_and_live(torch, np, root, smi, comm):
    """23. (a) The metrics registry and the flight recorder on the card:
    phase 22's ResNet-50 ZeRO-1 job, its updates, a shard-only save, the
    integrity walk of its parts (``verify_state``), a resume into a
    fresh job, with a registry and a recorder enabled; the Chrome trace
    and the Prometheus text exported, the text parsed back; every
    checkpoint span present and its duration, ``checkpoint/
    snapshots_written`` the saves made; after a warm-up update,
    ``SINK_UPDATE_PAIRS`` updates timed with the sinks off and as many
    with them on, alternating; one ``span()``'s host cost enabled and
    disabled.  (b) A same-world live resize 1 → 1 on a communicator of
    its own: an epoch only, the next 2 updates bitwise the
    uninterrupted run, its pause.  Prints ``{"sinks_one_card": ...}``
    and ``{"live_one_card": ...}``."""
    import os
    import shutil

    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.training.elastic import ResizeController
    from chainermn_tpu_torch.utils import (
        MetricsRegistry, TraceRecorder, parse_prometheus_text,
        set_recorder, set_registry, to_prometheus, verify_state)

    base = root / "build" / "chip_smoke" / "sinks"
    shutil.rmtree(base, ignore_errors=True)
    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the path starts
    reg, rec = MetricsRegistry(enabled=True), TraceRecorder(enabled=True)
    prev_reg, prev_rec = set_registry(reg), set_recorder(rec)
    _, up, _ = elastic_resnet_job(torch, np, comm, base / "x",
                                  global_batch=ZERO_RESNET_B)
    # one warm-up update, then the sinks off and on in alternating
    # pairs (off-on, on-off, ...) so that drift falls on both arms
    up.update()
    off_ms, on_ms = [], []
    for i in range(SINK_UPDATE_PAIRS):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            for sink in (rec, reg):
                (sink.enable if on else sink.disable)()
            (on_ms if on else off_ms).append(timed_ms(torch, up.update)[1])
    rec.enable()
    reg.enable()
    _, _, cp = elastic_resnet_job(torch, np, comm, base / "ckpt",
                                  global_batch=ZERO_RESNET_B)
    cp.save(up)
    saved = grab(torch, up)
    for fn in sorted(os.listdir(base / "ckpt")):
        verify_state(str(base / "ckpt" / fn))
    _, again, cp2 = elastic_resnet_job(torch, np, comm, base / "ckpt",
                                       global_batch=ZERO_RESNET_B)
    at = cp2.maybe_load(again)
    same = {k: tree_diff(torch, np, grab(torch, again)[k], saved[k])[0]
            for k in ("params", "state", "opt")}
    require(at == 1 + 2 * SINK_UPDATE_PAIRS and all(same.values()),
            f"23 (a): resumed at {at}, bitwise {same}")
    trace = base / "trace.json"
    rec.export_chrome(str(trace))
    doc = json.loads(trace.read_text())
    spans = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X":
            spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    missing = [n for n in SINK_SPANS if n not in spans]
    require(not missing, f"23 (a): spans {missing} missing from the trace")
    text = to_prometheus(reg, labels={"rank": "0"})
    (base / "metrics.prom").write_text(text)
    parsed = parse_prometheus_text(text)
    written = parsed.get("checkpoint_snapshots_written", {}).get("value")
    require(written == 1.0,
            f"23 (a): checkpoint/snapshots_written reads {written}, one "
            "save was made")
    set_registry(prev_reg)
    set_recorder(prev_rec)
    cost = {"enabled_us": span_cost_us(TraceRecorder(enabled=True)),
            "disabled_us": span_cost_us(TraceRecorder(enabled=False))}
    sinks = dict(card=smi, images=ZERO_RESNET_B,
                 span_ms={n: spans[n] for n in SINK_SPANS},
                 snapshots_written=written, metrics=sorted(parsed),
                 update_ms_sinks_off=off_ms, update_ms_sinks_on=on_ms,
                 span_cost=cost, trace_events=len(doc["traceEvents"]))
    del up, again, cp, cp2
    print(f"23 (a) sinks on the card: spans (ms) "
          + ", ".join(f"{n} {statistics.median(spans[n]):.1f}"
                      for n in SINK_SPANS)
          + f"; update ms off median {statistics.median(off_ms):.1f} "
          f"[{min(off_ms):.1f}, {max(off_ms):.1f}], on median "
          f"{statistics.median(on_ms):.1f} [{min(on_ms):.1f}, "
          f"{max(on_ms):.1f}] ({SINK_UPDATE_PAIRS} each); span() "
          f"{cost['enabled_us']:.3f} µs enabled, {cost['disabled_us']:.3f}"
          f" µs disabled; {smi}")
    print(json.dumps({"sinks_one_card": sinks}))

    # (b) a same-world live resize, 1 -> 1
    ref_trainer, ref = live_resnet_job(torch, np, live_world(1),
                                       base / "ref", batch=ZERO_RESNET_B,
                                       n=2 * ZERO_RESNET_B)
    for _ in range(4):
        ref.update()
    want = grab(torch, ref)
    want_losses = float(ref.observation["main/loss"])
    ref.comm.close()
    del ref, ref_trainer
    trainer, up = live_resnet_job(torch, np, live_world(1), base / "live",
                                  batch=ZERO_RESNET_B,
                                  n=2 * ZERO_RESNET_B)
    ctrl = ResizeController(live_world, live_opt)
    up.update()
    up.update()
    old = up.comm
    ctrl.resize(trainer, 1)
    require(up.comm is not old and old.closed and ctrl.epoch == 1,
            "23 (b): the resize did not re-form the world")
    up.update()
    up.update()
    got = grab(torch, up)
    same = {k: tree_diff(torch, np, got[k], want[k])[0]
            for k in ("params", "state", "opt")}
    loss_same = float(up.observation["main/loss"]) == want_losses
    require(all(same.values()) and loss_same,
            f"23 (b): after a 1 -> 1 resize the updates are not the "
            f"uninterrupted run's: bitwise {same}, loss {loss_same}")
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)
    require(counts == (0, 0, 0), f"phase 23 launched {counts}")
    live = dict(card=smi, resize=ctrl.resizes[0], bitwise=same,
                images=ZERO_RESNET_B)
    up.comm.close()
    print(f"23 (b) live 1 -> 1: epoch {ctrl.epoch}, pause "
          f"{ctrl.resizes[0]['pause_s'] * 1e3:.1f} ms, the next 2 updates "
          f"bitwise the uninterrupted run; {smi}")
    print(json.dumps({"live_one_card": live}))
    return sinks, live


def _opt_rows(np, up):
    """This rank's optimizer tree, flattened into one fp32 vector."""
    from chainermn_tpu_torch.training import optimizer_state_tree
    from chainermn_tpu_torch.utils import tree_flatten

    leaves = tree_flatten(optimizer_state_tree(up.opt_state))[0]
    return np.concatenate([
        np.asarray(t.detach().float().cpu() if hasattr(t, "detach") else t,
                   np.float64).ravel() for t in leaves])


def _params_flat(np, up):
    import torch.utils._pytree as pytree

    return np.concatenate([t.detach().float().cpu().numpy().ravel()
                           for t in pytree.tree_leaves(up.params)])


def live_rank(out, arm):
    """One rank (under torchrun) of ``--four-cards live``.  ``live``:
    arm B, the job on 4, ``FaultPlan(resize_live_at_iteration=2,
    resize_live_to=2)``, a request back to 4 at iteration 4, 6 updates
    (ranks 2 and 3 parked in between), then two further 4 → 2 → 4
    cycles by ``resize`` calls, the first with an update at world 2 and
    the second without; each card's memory (:func:`card_memory`) after
    every resize and after the first update at world 4 that follows
    the 2nd, 4th and 6th.
    ``save4``/``save2``/``resume4``: arm A, the save/restart chain (a
    fresh job resumed by an ``elastic=True`` checkpointer at each
    boundary).  Each rank writes its losses, its optimizer rows, the
    parameters (rank 0) and its numbers under ``out``."""
    import numpy as np
    import torch

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer)
    from chainermn_tpu_torch.testing import FaultInjector, FaultPlan
    from chainermn_tpu_torch.training.elastic import ResizeController

    t_start = time.time()
    cmn.init_distributed()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    r = torch.distributed.get_rank()
    out = Path(out)
    res = dict(arm=arm, rank=r, card=card_name())

    def save_rows(name, up):
        np.save(out / f"opt_{name}_{r}.npy", _opt_rows(np, up))
        if r == 0:
            np.save(out / f"params_{name}.npy", _params_flat(np, up))

    if arm == "live":
        c4 = live_world(4)
        trainer, up = live_resnet_job(torch, np, c4, out / "live")
        mem = {}

        def on_resize(ctrl, new, epoch):
            mem[f"resize{epoch}"] = card_memory(torch)

        ctrl = ResizeController(live_world, live_opt, on_resize=on_resize)
        log = cmn.training.LogReport(trigger=(1, "iteration"))
        for ext in [log] + [
                FaultInjector(FaultPlan(resize_live_at_iteration=at,
                                        resize_live_to=to), c4,
                              resize_controller=ctrl)
                for at, to in ((LIVE_AT, 2), (LIVE_BACK, 4))] + [ctrl]:
            trainer.extend(ext)

        class AfterUpdate:
            """The card's memory after the first update at world 4 that
            follows the second resize (iteration 5)."""

            trigger, priority = (1, "iteration"), 3

            def __call__(self, trainer):
                if trainer.updater.iteration == LIVE_BACK + 1:
                    mem["update2"] = card_memory(torch)

        trainer.extend(AfterUpdate())
        torch.cuda.reset_peak_memory_stats()
        trainer.run()
        res.update(losses={e["iteration"]: e["main/loss"]
                           for e in log.log}, resizes=list(ctrl.resizes),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        save_rows("live", up)
        # resizes 3 and 4: a further 4 -> 2 -> 4 cycle, an update after
        # each resize (ranks 2 and 3 return from the shrink's resize only
        # once the grow has brought them back); resizes 5 and 6: one
        # more with no update at world 2, the schedule whose 4th resize
        # read high once (ROADMAP Queue C)
        for tag, between in (("4", True), ("6", False)):
            ctrl.resize(trainer, 2)
            if r < 2:
                if between:
                    up.update()
                ctrl.resize(trainer, 4)
            up.update()
            mem[f"update{tag}"] = card_memory(torch)
        res.update(memory=mem, resizes_all=list(ctrl.resizes))
        up.comm.close()
    else:
        world = 2 if arm == "save2" else 4
        ck = out / "restart" / "ckpt"
        comm = live_world(world)
        if comm is not None:
            trainer, up = live_resnet_job(torch, np, comm, out / "restart")
            cp = create_multi_node_checkpointer(comm, str(ck), elastic=True)
            resumed, load_ms = None, 0.0
            if arm != "save4":
                resumed, load_ms = timed_ms(torch,
                                            lambda: cp.maybe_load(up))
            t_ready = time.time()
            stop = {"save4": LIVE_AT, "save2": LIVE_BACK,
                    "resume4": LIVE_STOP}[arm]
            losses = {}
            while up.iteration < stop:
                up.update()
                losses[int(up.iteration)] = float(
                    up.observation["main/loss"])
            save_ms = None
            if arm != "resume4":
                _, save_ms = timed_ms(torch, lambda: cp.save(up))
            res.update(losses=losses, resumed=resumed,
                       mode=cp.last_resume_mode, load_ms=load_ms,
                       save_ms=save_ms, t_start=t_start, t_ready=t_ready)
            if arm == "resume4":
                save_rows("restart", up)
            comm.close()
    (out / f"{arm}_{r}.json").write_text(json.dumps(res))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def live_control_rank(out):
    """``--four-cards live`` (ii) on one rank (under torchrun): the
    control plane over torchrun's store, the port's
    ``battery_live_control`` of ``tests/test_torch_world.py``."""
    import torch

    import chainermn_tpu_torch as cmn

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_world as world

    comm = cmn.create_communicator()
    got = world.battery_live_control(comm, dict(root=str(out)))
    if comm.rank == 0:
        (Path(out) / "control.json").write_text(json.dumps(got))
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def four_cards_live(root, smi):
    """``--four-cards live``: (i) the acceptance drill on ResNet-50 under
    ZeRO-1 (:func:`live_rank`): arm B live 4 → 2 → 4 in one torchrun,
    arm A the save/restart chain in three; every loss, the final
    parameters and every rank's optimizer rows bitwise across the arms
    (else the first leaf that differs and its largest relative
    difference are printed, and the run fails); each resize's pause
    against arm A's save, relaunch and resume; the bytes a rank received
    and its peak GiB; a further 4 → 2 → 4 cycle with an update after
    each resize, each card's used memory after the fourth resize, and
    after the first update that follows it, within 64 MiB of the same
    reading at the second; one more cycle with no update at world 2,
    its readings printed.
    (ii) The control plane over torchrun's store
    (:func:`live_control_rank`).  Prints ``{"live_resize": {...}}``."""
    import shutil

    import numpy as np

    out = root / "build" / "four_cards" / "live"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    me = str(Path(__file__).resolve())
    t0 = time.perf_counter()
    launched = {}

    def launch(n, *args):
        launched[args[-1]] = time.time()
        subprocess.run(["torchrun", "--standalone", "--nproc_per_node",
                        str(n), me, *args], check=True, timeout=600)

    launch(4, "--live-rank", str(out), "live")
    launch(4, "--live-rank", str(out), "save4")
    launch(2, "--live-rank", str(out), "save2")
    launch(4, "--live-rank", str(out), "resume4")
    launch(4, "--live-control", str(out))

    def rows(arm):
        return [json.loads((out / f"{arm}_{r}.json").read_text())
                for r in range(2 if arm == "save2" else 4)]

    live = rows("live")
    # the global mean loss of each iteration in arm A, from every rank
    # that ran it (they must agree)
    restart = {}
    diffs = []
    for arm in ("save4", "save2", "resume4"):
        for q in rows(arm):
            for it, loss in q.get("losses", {}).items():
                if restart.setdefault(it, loss) != loss:
                    diffs.append(("arm A loss", q["rank"], it, loss,
                                  restart[it]))
    report = dict(card=smi, global_batch=LIVE_B, schedule=dict(
        at=LIVE_AT, back=LIVE_BACK, stop=LIVE_STOP))
    # (i) bitwise across the arms: every rank's log is the job's (the
    # ranks parked for iterations 3-4 took rank 0's when they joined)
    for q in live:
        if q["losses"] != restart:
            diffs.append(("loss", q["rank"], q["losses"], restart))
    for name in [f"opt_{{}}_{r}.npy" for r in range(4)] + ["params_{}.npy"]:
        a = np.load(out / name.format("live"))
        b = np.load(out / name.format("restart"))
        if a.shape != b.shape or not np.array_equal(a, b):
            i = int(np.argmax(a != b)) if a.shape == b.shape else -1
            rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b),
                                                          1e-30))) \
                if a.shape == b.shape else float("inf")
            diffs.append((name.format("*"), "first differing element", i,
                          "largest relative difference", rel))
    report["bitwise"] = not diffs
    report["first_difference"] = diffs[:1]
    # the pause against arm A's save, relaunch and resume
    s4 = rows("save4")
    s2 = rows("save2")
    r4 = rows("resume4")
    arm_a = []
    for saves, nxt, arm in ((s4, s2, "save2"), (s2, r4, "resume4")):
        save = max(q["save_ms"] for q in saves if q.get("save_ms"))
        ready = max(q["t_ready"] for q in nxt if "t_ready" in q)
        load = max(q["load_ms"] for q in nxt if "load_ms" in q)
        arm_a.append(dict(save_ms=save, resume_ms=load,
                          relaunch_and_resume_ms=(ready - launched[arm])
                          * 1e3,
                          total_ms=save + (ready - launched[arm]) * 1e3))
    report["pause_ms"] = [[x["pause_s"] * 1e3 for x in q["resizes"]]
                          for q in live]
    report["arm_a_ms"] = arm_a
    report["bytes_received"] = [[x["bytes_moved"] for x in q["resizes"]]
                                for q in live]
    report["peak_gib"] = [q["peak_gib"] for q in live]
    # each card's memory (MiB) at every reading, and the growth of its
    # used memory from the 2nd resize to the 4th (and 6th): right after
    # the resize and after the first update that follows it
    mem = {q["rank"]: q["memory"] for q in live}
    report["memory_mib"] = {
        r: {tag: {k: v / 2**20 for k, v in m.items()}
            for tag, m in mm.items()} for r, mm in mem.items()}
    growth = {f"{b}-{a}": {r: (mm[b]["used"] - mm[a]["used"]) / 2**20
                           for r, mm in mem.items()}
              for a, b in (("resize2", "resize4"), ("update2", "update4"),
                           ("resize2", "resize6"), ("update2", "update6"))}
    report["used_growth_mib"] = growth
    # enforced: the 4th resize against the 2nd; resizes 5-6 (no update
    # between) are read for the open question in ROADMAP Queue C
    enforced = ("resize4-resize2", "update4-update2")
    over = {k: growth[k] for k in enforced
            if any(d > LIVE_MEM_SLACK / 2**20 for d in growth[k].values())}
    ctl = json.loads((out / "control.json").read_text())
    report["control_plane"] = ctl
    report["command_s"] = time.perf_counter() - t0
    print(json.dumps({"live_resize": report}))
    pauses = report["pause_ms"][0]
    print(f"live 4 -> 2 -> 4 on ResNet-50 ZeRO-1, global batch {LIVE_B}: "
          f"bitwise {report['bitwise']}, pause ms {pauses}, arm A save + "
          f"relaunch + resume ms {[round(x['total_ms']) for x in arm_a]}, "
          f"used MiB growth by rank {growth}; {smi}")
    require(not diffs, f"live against save/restart: {diffs[:3]}")
    require(not over, f"used memory after the 4th resize exceeds the "
            f"2nd's by more than 64 MiB: {over}")
    require(ctl.get("ok"), f"the control plane over the store: {ctl}")
    return 0


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--four-cards"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        print(card_name())
        here = Path(__file__).resolve().parent
        if sys.argv[2:3] == ["seq"]:
            # the sequence axis alone, its "dots" runs after
            sys.exit(four_cards_seq(here, card_name())
                     or four_cards_dots(here, card_name(), DOTS_FOUR[:3]))
        if sys.argv[2:3] == ["dots"]:
            # "dots" remat under the ring, Ulysses and the expert axis
            sys.exit(four_cards_dots(here, card_name()))
        if sys.argv[2:3] == ["tp"]:
            # the model axis alone
            sys.exit(four_cards_tp(here, card_name()))
        if sys.argv[2:3] == ["pp"]:
            # the pipe axis alone
            sys.exit(four_cards_pp(here, card_name()))
        if sys.argv[2:3] == ["ep"]:
            # the expert axis alone, its "dots" runs after
            sys.exit(four_cards_ep(here, card_name())
                     or four_cards_dots(here, card_name(), DOTS_FOUR[3:]))
        if sys.argv[2:3] == ["zero"]:
            # ZeRO-1/2 and FSDP over the data axis alone
            sys.exit(four_cards_zero(here, card_name()))
        if sys.argv[2:3] == ["elastic"]:
            # resume at another world size, the n-step RNN, seq2seq DP
            sys.exit(four_cards_elastic(here, card_name()))
        if sys.argv[2:3] == ["live"]:
            # the live resize and its control plane
            sys.exit(four_cards_live(here, card_name()))
        sys.exit(four_cards(here, card_name())
                 or four_cards_seq(here, card_name())
                 or four_cards_tp(here, card_name())
                 or four_cards_pp(here, card_name())
                 or four_cards_ep(here, card_name())
                 or four_cards_dots(here, card_name())
                 or four_cards_zero(here, card_name())
                 or four_cards_elastic(here, card_name())
                 or four_cards_live(here, card_name()))
    if sys.argv[1:2] == ["--live-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(live_rank(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--live-control"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(live_control_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--elastic-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(elastic_rank(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--rnn-dp-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(rnn_dp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--zero-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(zero_rank(*sys.argv[2:9]))
    if sys.argv[1:2] == ["--zero-resnet"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(zero_resnet_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--seq-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(seq_rank(*sys.argv[2:9]))
    if sys.argv[1:2] == ["--pp-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(pp_rank(*sys.argv[2:8]))
    if sys.argv[1:2] == ["--ep-sim"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(ep_sim_child(sys.argv[2]))
    if sys.argv[1:2] == ["--dots-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(dots_rank(*sys.argv[2:9]))
    if sys.argv[1:2] == ["--ep-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(ep_rank(*sys.argv[2:8]))
    if sys.argv[1:2] == ["--ep-decode"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(ep_decode_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--pp-decode"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(pp_decode_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--tp-decode"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(tp_decode_rank(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--seq-decode"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(seq_decode_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--drift-child"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(drift_child(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--wire-witness"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(wire_witness_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--lm-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(lm_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--two-stage-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(two_stage_rank())
    if sys.argv[1:2] == ["--kill-drill"]:
        # phase 9's child: it never returns, the fault plan kills it
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(kill_drill_child(sys.argv[2]))
    sys.exit(main())
