#!/usr/bin/env python3
"""Where the port's time goes on the card: a ``torch.profiler`` trace of
one scoring forward, one greedy generation and one training step of the
flagship config that ``chip_smoke.py`` drives, summed by kernel, and
each hand-written kernel's registers, spills and shared memory as
``nvcc -Xptxas -v`` reports them.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 profile_port.py
    python3 profile_port.py resnet
    python3 profile_port.py ring
    python3 profile_port.py remat
    python3 profile_port.py moe
    torchrun --nproc_per_node 4 profile_port.py moe
    torchrun --nproc_per_node 4 profile_port.py fsdp
    python3 profile_port.py variants NAME=SOURCE.cu [NAME=SOURCE.cu ...]
    python3 profile_port.py variants bwd NAME=SOURCE.cu [NAME=SOURCE.cu ...]

For each path it prints the host wall time of one synchronised call,
the device busy time (the sum of kernel times; one stream, so kernels
do not overlap), the idle share, the time by kind of kernel (the flash
kernels, matrix products, the optimizer, the rest) and the ten kernels
that take most of it.  The training step is ``make_train_step`` with
``adamw(3e-4)``, remat on, on ``bench_transformer.py``'s 8 x 2048-token
batch, traced after one warm-up step.  Weights are random (numpy
seed 0).

``resnet`` traces ChainerMN's data-parallel step instead, as
``chip_smoke.py`` phase 7 drives it (ResNet-50 with synchronised BN,
224 px, batch 256, bf16, ``sgd(0.1, momentum=0.9)``, a bf16 gradient
wire, one NCCL rank, a fixed batch on the card, three warm-up steps):
one ``updater.update()``, then the gradient exchange alone
(``multi_node_mean_grad`` of that step's gradients), by kind of kernel
(cuDNN convolutions, the BN and ReLU elementwise passes, reductions,
copies and casts — the bucket pack and unpack among them, NCCL, the
SGD foreach kernels).

``ring`` traces ``chip_smoke.py`` phase 15 (a)'s ring schedule instead:
the ring bodies of 4 virtual ranks on one card (``simulate_ring``, the
flagship's attention shape, B=8, T=2048, 16 query and 4 kv heads, D=64,
bf16), forward and forward + backward, contiguous and zigzag, and the
whole-sequence kernel call, each with its wall time and the flash
kernels' device time per launched pair.

``remat`` traces the flagship's training step (``make_train_step``,
``adamw(3e-4)``, 8 x 2048 tokens) under each remat mode instead:
``remat_policy="full"``, ``"dots"`` (a selective checkpoint whose
dispatch mode sees every op of a block) and no remat, each after one
warm-up step.

``moe`` traces one block of ``chip_smoke.py``'s MoE flagship instead
(phase 18: attention, then the Switch MLP of 8 experts at capacity
factor 1.25, bf16, 8 x 2048 tokens), forward and forward + backward,
the block and its MoE MLP alone; for each, beside the time by kind, the
all-to-all's time (the NCCL kernels) and the products' (cuBLAS; in the
MLP alone, the router's and the experts').  On one card the expert axis
has one rank and no exchange, and the whole MoE flagship's training
step (top-1, AdamW, full remat) is traced after them; under
``torchrun --nproc_per_node X`` the mesh is ``expert=X``, each rank
with ``8/X`` rows and ``8/X`` experts, and rank 0 prints.

``fsdp`` traces one training step of the flagship over the mesh
``data=WORLD_SIZE`` (under torchrun; 8 x 2048 tokens globally) with
``fsdp=True`` and then without it: rank 0 prints each, with the NCCL
kernels (FSDP's per-block gathers and gradient reduce-scatters, the
replicated leaves' all-reduce) beside the compute, and the idle share.

``variants`` times versions of the forward kernel side by side instead:
each SOURCE has the C entry point of ``csrc/flash_fwd.cu`` (the same
argument list), such as an earlier version from git history or a copy
with one part taken out.  Each is compiled with the port's ``nvcc``
flags (all at once, ``csrc/`` on the include path for ``hopper.cuh``),
loaded with ctypes and called as the wrapper calls its kernel at the
flagship scoring shape (B=8, H=16, T=2048, D=64, bf16); it prints each
build's spills, each version's relative L2 error against the plain
version (a copy with a part taken out is wrong by design), and two
rounds of causal timings and one of non-causal, SDPA's first in each,
with ``chip_smoke.cuda_ms``, in milliseconds.  ``variants bwd`` does the
same for versions of ``csrc/flash_bwd.cu`` (its two entry points) at the
flagship training shape, causal: each version's dq, dk and dv against
the plain versions, then two rounds of SDPA's backward (dq, dk and dv in
one call) and each version's dq and dk/dv kernels.
"""

import dataclasses
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

from chip_smoke import FLAGSHIP, SEED, cuda_ms


def kind(name):
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if kernel + "_kernel" in name:
            return kernel
    low = name.lower()
    if "nccl" in low:
        return "NCCL collectives"
    if "multi_tensor_apply" in low:
        return "optimizer (torch.optim foreach kernels)"
    # cuDNN's convolutions (forward, data and weight gradients) before
    # the matmul rule: their implicit-GEMM kernels say xmma/gemm too
    if any(w in low for w in ("conv", "cudnn", "fprop", "dgrad", "wgrad")):
        return "convolution (cuDNN)"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout transposes (cuDNN)"
    if any(w in low for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                              "cublas")):
        return "matmul (cuBLAS)"
    if "reduce_kernel" in low:
        return "reductions"
    if "copy" in low:
        return "copies and casts"
    return "other elementwise"


def trace(torch, fn, label, warm=True, show=True):
    """Trace one synchronised ``fn()`` (after a warm-up call unless
    ``warm`` is false) and print, unless ``show`` is false, its wall
    time, device busy time, idle share and time by kind of kernel.
    Returns those as a dict: ``by_kind`` maps each kind to its ms and
    its number of kernels."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()                               # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, by_kind = defaultdict(float), defaultdict(lambda: [0.0, 0])
    launches = 0
    for e in prof.events():
        # kernels only: a user annotation on the device's timeline (the
        # optimizer's step) spans kernels that are counted themselves
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            by_name[e.name] += e.device_time_total
            by_kind[kind(e.name)][0] += e.device_time_total
            by_kind[kind(e.name)][1] += 1
            launches += 1
    busy = sum(by_name.values())
    if busy <= 0:
        raise RuntimeError(f"{label}: the profiler saw no device time")
    summary = dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                   idle=1 - busy / wall_us, kernels=launches,
                   by_kind={k: [us / 1e3, n] for k, (us, n) in
                            by_kind.items()})
    if not show:
        return summary
    print(f"{label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, idle {1 - busy / wall_us:.1%}, "
          f"{launches} kernel launches")
    for k, (us, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {k:40s} {us / 1e3:9.3f} ms {us / busy:6.1%} {n:6d} "
              f"kernels")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / 1e3:9.3f} ms {us / busy:6.1%}  {name[:90]}")
    return summary


def ptxas_kernels(log):
    """``(kernel, dtype, D, registers, static smem bytes, spill line)`` of
    each kernel instance in the output of ``nvcc -Xptxas -v``."""
    found, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?"
                      r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(\w+?)Li"
                      r"(\d+)E", line)
        if m:
            name = (m[1], m[2].lstrip("0123456789"), int(m[3]))
        elif "spill stores" in line:
            spill = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            found.append((*name, int(m[1]), int(smem[1]) if smem else 0,
                          spill))
            name = None
    return found


def kernel_resources():
    """Registers, spills and shared memory of every kernel instance, from
    ``nvcc -Xptxas -v`` on each ``csrc/*.cu`` (a build apart from the
    loaded libraries, into the build directory, removed after).  The
    kernels' shared memory is dynamic: its size comes from the libraries'
    ``flash_fwd_smem_bytes`` and ``flash_bwd_smem_bytes``, the sources'
    own constants."""
    from chainermn_tpu_torch import _build

    fwd_smem = _build.load_library("flash_fwd").flash_fwd_smem_bytes
    bwd_smem = _build.load_library("flash_bwd").flash_bwd_smem_bytes
    dynamic_smem = {
        "flash_fwd_kernel": fwd_smem,
        "flash_bwd_dq_kernel": lambda d: bwd_smem(d, 0),
        "flash_bwd_dkv_kernel": lambda d: bwd_smem(d, 1)}

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    scratch = _build.BUILD_DIR / "ptxas-report.so"
    for src in sorted(_build.CSRC.glob("*.cu")):
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(scratch), str(src)], capture_output=True, text=True,
            check=True, timeout=600)
        scratch.unlink(missing_ok=True)
        for kernel, dtype, d, regs, smem, spill in ptxas_kernels(
                out.stdout + out.stderr):
            print(f"  {kernel}<{dtype}, D={d}>: {regs} registers, {smem} "
                  f"bytes static smem, {dynamic_smem[kernel](d)} bytes "
                  f"dynamic smem; {spill}")


def build_variants(specs, out, entry_points):
    """Compile each ``(name, source)`` at once; for each version that
    builds, its C entry points ``{entry: (n_ptrs, n_strides)}`` with the
    wrapper's argument list (``ops.flash_attention._kernel``)."""
    import ctypes

    from chainermn_tpu_torch import _build

    out.mkdir(parents=True, exist_ok=True)
    procs = [(name, out / f"{name}.so", subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-o", str(out / f"{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, src in specs]
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    versions = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        spills = [f"{k.removesuffix('_kernel')}<{t}, D={d}> "
                  f"{sp.replace('bytes ', '')}"
                  for k, t, d, _, _, sp in ptxas_kernels(log)
                  if sp and " 0 bytes spill stores" not in sp]
        serialised = log.count("wgmma.mma_async instructions are serialized")
        print(f"build {name}: rc {proc.returncode}, spills: "
              + ("; ".join(spills) or "none")
              + f"; kernels whose wgmma ptxas serialises: {serialised}")
        if proc.returncode:
            print(log[-3000:])
            continue
        lib = ctypes.CDLL(str(so))
        versions[name] = {}
        for entry, (n_ptrs, n_strides) in entry_points.items():
            fn = getattr(lib, entry)
            fn.argtypes = ([ptr] * n_ptrs + [i32] * 6 + [i64] * n_strides
                           + [i32] * 4 + [ctypes.c_float, ptr])
            fn.restype = ctypes.c_int
            versions[name][entry] = fn
    return versions


def call_variant(torch, fn, q, k, v, causal):
    from chainermn_tpu_torch.ops.flash_attention import (
        _KERNEL_DTYPES,
        _strides,
    )

    B, T, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, H, T, T, D, _KERNEL_DTYPES[q.dtype],
             *_strides(q, k, v, o), int(causal), 0, 0, 0, D ** -0.5,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")
    return o


def variants(torch, specs):
    from chainermn_tpu_torch.ops import flash_attention_reference

    fns = {name: entries["flash_fwd"] for name, entries in build_variants(
        specs, Path(__file__).resolve().parent / "build" / "variants",
        {"flash_fwd": (5, 12)}).items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, T, H, D = 8, 2048, 16, 64
    q, k, v = (torch.randn(B, T, H, D, device="cuda", generator=gen,
                           dtype=torch.bfloat16) for _ in range(3))
    o_ref, _ = flash_attention_reference(q, k, v, causal=True)
    for name, fn in fns.items():
        o = call_variant(torch, fn, q, k, v, True).float()
        torch.cuda.synchronize()
        rel = ((o - o_ref.float()).norm() / o_ref.float().norm()).item()
        print(f"{name}: relative L2 error against the plain version "
              f"{rel:.3e}")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, causal, rounds in (("causal", True, 2),
                                  ("non-causal", False, 1)):
        for r in range(rounds):
            times = [("sdpa", cuda_ms(lambda: sdpa(qt, kt, vt,
                                                   is_causal=causal)))]
            times += [(name, cuda_ms(lambda: call_variant(
                torch, fn, q, k, v, causal))) for name, fn in fns.items()]
            print(f"{label} round {r}, B={B} H={H} T={T} D={D} bf16, ms: "
                  + "  ".join(f"{n} {t:.4f}" for n, t in times))


def call_bwd_variant(torch, fns, q, k, v, do, lse, delta, dkv):
    """One version's dq kernel (``dkv`` False) or dk/dv kernel, called
    as ``_launch_dq``/``_launch_dkv`` call theirs, causal; its outputs."""
    from chainermn_tpu_torch.ops.flash_attention import (
        _KERNEL_DTYPES,
        _strides,
    )

    B, T, H, D = q.shape
    outs = [torch.empty_like(k), torch.empty_like(v)] if dkv \
        else [torch.empty_like(q)]
    fn = fns["flash_bwd_dkv" if dkv else "flash_bwd_dq"]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
             B, H, T, T, D, _KERNEL_DTYPES[q.dtype],
             *_strides(q, k, v, do, *outs), 1, 0, 0, 0, D ** -0.5,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")
    return outs


def variants_bwd(torch, specs):
    """Versions of ``csrc/flash_bwd.cu`` side by side at the flagship
    training shape, causal, beside SDPA's backward."""
    import importlib

    from chainermn_tpu_torch.ops import flash_attention

    # the wrapper module (the package exports its function of that name)
    ops = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    versions = build_variants(
        specs, Path(__file__).resolve().parent / "build" / "variants",
        {"flash_bwd_dq": (7, 15), "flash_bwd_dkv": (8, 18)})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, T, H, D = 8, 2048, 16, 64
    q, k, v, do = (torch.randn(B, T, H, D, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    do_, lse_, delta = ops._bwd_operands(q, o, lse, do, None)
    want = [ops._dq_reference(q, k, v, do_, lse_, delta, causal=True),
            *ops._dkv_reference(q, k, v, do_, lse_, delta, causal=True)]
    for name, fns in versions.items():
        got = (call_bwd_variant(torch, fns, q, k, v, do_, lse_, delta, False)
               + call_bwd_variant(torch, fns, q, k, v, do_, lse_, delta,
                                  True))
        torch.cuda.synchronize()
        rels = [((a.float() - b.float()).norm() / b.float().norm()).item()
                for a, b in zip(got, want)]
        print(f"{name}: relative L2 error against the plain version: dq "
              f"{rels[0]:.3e} dk {rels[1]:.3e} dv {rels[2]:.3e}")
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    for r in range(2):
        times = [("sdpa_bwd", cuda_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True)))]
        for name, fns in versions.items():
            for part, dkv in (("dq", False), ("dkv", True)):
                times.append((f"{name}.{part}", cuda_ms(
                    lambda: call_bwd_variant(torch, fns, q, k, v, do_, lse_,
                                             delta, dkv))))
        print(f"causal round {r}, B={B} H={H} T={T} D={D} bf16, ms: "
              + "  ".join(f"{n} {t:.4f}" for n, t in times))


def profile_ring(torch):
    """Trace ``chip_smoke.py`` phase 15 (a)'s ring schedule on one card:
    every rank's ring body of ``S`` virtual ranks (``simulate_ring``),
    forward and forward + backward, contiguous and zigzag, beside the
    whole-sequence kernel call; per launched pair, its wall time and
    the flash kernels' device time."""
    from chip_smoke import SEED, SEQ_SHAPE, _ring_run
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel import (
        broadcast_kv, simulate_ring, zigzag_indices)
    from chainermn_tpu_torch.parallel.ring_attention import ring_launches

    S, B, T, H, G, D = (SEQ_SHAPE[k] for k in "S B T H G D".split())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, do = (torch.randn(B, T, H, D, device="cuda", generator=gen,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, T, G, D, device="cuda", generator=gen,
                        dtype=torch.bfloat16) for _ in range(2))
    kb, vb = broadcast_kv(k, v, H // G)
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    for layout in ("contiguous", "zigzag"):
        perm = torch.as_tensor(zigzag_indices(S, T).reshape(-1),
                               device="cuda") if layout == "zigzag" \
            else torch.arange(T, device="cuda")
        lq, lk, lv, ldo = (t[:, perm].contiguous() for t in (q, k, v, do))
        pairs = ring_launches(S, T // S, causal=True, layout=layout)

        def ring(a, b, c, layout=layout):
            return simulate_ring(a, b, c, S=S, causal=True,
                                 use_flash=True, layout=layout)

        runs = [(f"ring {layout} forward", True,
                 lambda: ring(lq, lk, lv)),
                (f"ring {layout} forward+backward", False,
                 lambda: _ring_run(torch, ring, lq, lk, lv, ldo))]
        if layout == "contiguous":
            runs += [("whole-sequence call forward", True,
                      lambda: fa(q, kb, vb, causal=True)),
                     ("whole-sequence call forward+backward", False,
                      lambda: _ring_run(torch, lambda a, b, c: fa(
                          a, b, c, causal=True), q, kb, vb, do))]
        for label, no_grad, fn in runs:
            with torch.set_grad_enabled(not no_grad):
                got = trace(torch, fn, f"{label}, S={S} B={B} T={T} H={H} "
                            f"G={G} D={D} bf16")
            n = 1 if label.startswith("whole") else pairs
            dev_ms = sum(got["by_kind"].get(f, [0.0])[0] for f in flash)
            print(f"  per pair ({n}): wall {got['wall_ms'] / n:.4f} ms, "
                  f"device busy {got['busy_ms'] / n:.4f} ms, the flash "
                  f"kernels {dev_ms / n:.4f} ms")


def profile_moe(torch):
    """Trace one MoE block (and its MLP alone) of the MoE flagship,
    forward and forward + backward, on one card or over the mesh
    ``expert=WORLD_SIZE`` under torchrun."""
    import os

    from chip_smoke import MOE, moe_params
    from chainermn_tpu_torch.communicators import LoopbackCommunicator
    from chainermn_tpu_torch.models import TransformerConfig, shard_params
    from chainermn_tpu_torch.models.transformer import _block, _layer, _mlp

    dev = torch.device("cuda")
    cfg = TransformerConfig(**dict(MOE, n_layers=1))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = None
    if world > 1:
        import chainermn_tpu_torch as cmn
        from chainermn_tpu_torch.parallel import MeshConfig

        comm = cmn.create_communicator()
        mesh = MeshConfig(comm, expert=world)
        dev = comm.device
    params = moe_params(torch, cfg, dev)
    loop = LoopbackCommunicator(device=dev)
    expert, rows, lead = loop, 8, True
    if mesh is not None:
        params = shard_params(mesh, cfg, params)
        expert, rows, lead = mesh.comm("expert"), 8 // world, comm.rank == 0
    blk = {k: v.detach().requires_grad_()
           for k, v in _layer(params, 0).items()}
    g = torch.Generator(device=dev).manual_seed(SEED)
    h = torch.randn((rows, cfg.max_seq, cfg.d_model), generator=g,
                    device=dev).to(cfg.compute_dtype)

    def block(x):
        return _block(cfg, x, blk, loop, loop, expert, loop)

    def mlp(x):
        return _mlp(cfg, x, blk, loop, expert)

    def backward(fn):
        x = h.detach().requires_grad_()
        out, aux = fn(x)
        (out.float().mean() + aux).backward()

    for label, fn, grad in (("MoE block forward", block, False),
                            ("MoE block forward+backward", block, True),
                            ("MoE MLP forward", mlp, False),
                            ("MoE MLP forward+backward", mlp, True)):
        run = (lambda fn=fn: backward(fn)) if grad else (lambda fn=fn: fn(h))
        with torch.set_grad_enabled(grad):
            got = trace(torch, run, f"{label}, expert={world}, {rows} x "
                        f"{cfg.max_seq} tokens a rank, bf16", show=lead)
        if lead:
            a2a = got["by_kind"].get("NCCL collectives", [0.0, 0])
            mm = got["by_kind"].get("matmul (cuBLAS)", [0.0, 0])
            print(f"  all-to-all {a2a[0]:.3f} ms ({a2a[1]} kernels), "
                  f"products {mm[0]:.3f} ms ({mm[1]} kernels)")
    if world > 1:
        return
    # one card: the whole MoE flagship's training step (top-1, AdamW)
    import numpy as np

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import make_train_step

    del params, blk
    cfg = TransformerConfig(**MOE)
    params = moe_params(torch, cfg, dev)
    toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size,
                                               (8, cfg.max_seq + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    opt = training.adamw(3e-4)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    trace(torch, lambda: step(params, state, x, y),
          f"MoE flagship training step, 8x{cfg.max_seq} tokens, top-1, "
          "remat, AdamW")


def profile_fsdp(torch):
    """Trace one training step of the flagship (8 x 2048 tokens
    globally, bf16, full remat, ``adamw(3e-4)``) over the mesh
    ``data=WORLD_SIZE`` under torchrun, with ``fsdp=True`` and without:
    rank 0 prints each step's wall time, busy time, idle share and time
    by kind, the NCCL kernels (FSDP's gathers and reduce-scatters, the
    gradient all-reduce) beside the compute.  On one card the data axis
    has one member and FSDP gathers nothing."""
    import os

    import numpy as np

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_numpy_params, make_train_step,
        params_from_jax)
    from chainermn_tpu_torch.parallel import MeshConfig

    world = int(os.environ.get("WORLD_SIZE", "1"))
    comm = cmn.create_communicator()
    mesh = MeshConfig(comm, data=world)
    cfg = TransformerConfig(**dict(FLAGSHIP, remat=True))
    tree = init_numpy_params(cfg, SEED)
    toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size,
                                               (8, cfg.max_seq + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    for fsdp in (True, False):
        c = dataclasses.replace(cfg, fsdp=fsdp)
        params = params_from_jax(tree, c, comm.device, mesh=mesh)
        opt = training.adamw(3e-4)
        state = opt.init(params)
        step = make_train_step(c, opt, mesh=mesh)
        got = trace(torch, lambda: step(params, state, x, y),
                    f"training step, data={world}, fsdp {fsdp}, "
                    f"{8 // world} x {cfg.max_seq} tokens a rank",
                    show=comm.rank == 0)
        if comm.rank == 0:
            nccl = got["by_kind"].get("NCCL collectives", [0.0, 0])
            print(f"  NCCL {nccl[0]:.3f} ms ({nccl[1]} kernels) of "
                  f"{got['busy_ms']:.3f} ms busy")
        del params, state, step


def profile_resnet(torch):
    """Trace one data-parallel ResNet-50 step and its exchange alone."""
    import itertools

    import numpy as np
    import torch.utils._pytree as pytree

    from chainermn_tpu_torch.communicators import init_distributed
    from chip_smoke import load_example

    root = Path(__file__).resolve().parent
    ex = load_example(root, "examples/imagenet/train_imagenet_torch.py",
                      "train_imagenet_torch")
    init_distributed()
    torch.backends.cudnn.benchmark = True
    run = ex.build(ex.parse_args(
        ["--grad-dtype", "bfloat16", "--n-images", "300", "--out",
         str(root / "build" / "profile_port")]), quiet=True)
    up, comm = run.updater, run.comm
    rng = np.random.RandomState(SEED)
    x = torch.as_tensor(rng.randn(256, 224, 224, 3).astype(np.float32),
                        device="cuda")
    y = torch.as_tensor(rng.randint(0, 1000, 256), device="cuda")
    up.iterator = itertools.repeat((x, y))
    for _ in range(3):
        up.update()
    trace(torch, up.update, "dp resnet50 step, batch 256, bf16, bf16 wire")
    leaves, treedef = pytree.tree_flatten(up.params)
    loss, _ = up.loss_fn(up.params, up.state, x, y)
    grads = pytree.tree_unflatten(
        list(torch.autograd.grad(loss, leaves)), treedef)
    trace(torch, lambda: comm.multi_node_mean_grad(grads, torch.bfloat16),
          "dp resnet50 gradient exchange alone (pack, cast, NCCL, unpack)")
    torch.distributed.destroy_process_group()


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        TransformerConfig,
        init_numpy_params,
        make_forward_fn,
        make_generate_fn,
        make_train_step,
        params_from_jax,
    )

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    if sys.argv[1:2] == ["resnet"]:
        profile_resnet(torch)
        return 0
    if sys.argv[1:2] == ["ring"]:
        profile_ring(torch)
        return 0
    if sys.argv[1:2] == ["moe"]:
        profile_moe(torch)
        return 0
    if sys.argv[1:2] == ["fsdp"]:
        profile_fsdp(torch)
        return 0
    if sys.argv[1:3] == ["variants", "bwd"]:
        variants_bwd(torch, [a.split("=", 1) for a in sys.argv[3:]])
        return 0
    if sys.argv[1:2] == ["variants"]:
        variants(torch, [a.split("=", 1) for a in sys.argv[2:]])
        return 0
    cfg = TransformerConfig(**FLAGSHIP)
    params = params_from_jax(init_numpy_params(cfg, SEED), cfg)
    if sys.argv[1:2] == ["remat"]:
        toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size,
                                                   (8, 2048 + 1))
        x = torch.as_tensor(toks[:, :-1], device="cuda")
        y = torch.as_tensor(toks[:, 1:], device="cuda")
        for name, kw in (("full", dict(remat=True, remat_policy="full")),
                         ("dots", dict(remat=True, remat_policy="dots")),
                         ("none", dict(remat=False))):
            opt = training.adamw(3e-4)
            state = opt.init(params)
            step = make_train_step(dataclasses.replace(cfg, **kw), opt)
            trace(torch, lambda: step(params, state, x, y),
                  f"training step 8x2048 tokens, remat {name}, AdamW")
            del state
        return 0
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 2048)),
                             device="cuda")
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 128)),
                              device="cuda")
    forward = make_forward_fn(cfg)
    generate = make_generate_fn(cfg, max_len=128 + 64)
    with torch.inference_mode():
        trace(torch, lambda: forward(params, tokens),
              "scoring 8x2048 tokens")
        trace(torch, lambda: generate(params, prompts),
              "generate 8 x (128 prompt + 64 new), no eos")
    toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size,
                                               (8, 2048 + 1))
    x = torch.as_tensor(toks[:, :-1], device="cuda")
    y = torch.as_tensor(toks[:, 1:], device="cuda")
    opt = training.adamw(3e-4)
    state = opt.init(params)                 # updated in place from here
    step = make_train_step(cfg, opt)
    trace(torch, lambda: step(params, state, x, y),
          "training step 8x2048 tokens, remat, AdamW")
    print("kernel resources (nvcc -Xptxas -v, sm_90a):")
    kernel_resources()
    return 0


if __name__ == "__main__":
    sys.exit(main())
