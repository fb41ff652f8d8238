#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``chainermn_tpu_torch``) on one NVIDIA
H100: the quickest proof that the port still starts on the card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. build every kernel under ``chainermn_tpu_torch/csrc`` with ``nvcc``;
2. hold each kernel against its plain PyTorch version on the card, and
   time kernel, plain version and a library yardstick;
3. scoring at full width: the flagship GQA transformer (24 layers,
   d_model 1024, 16 query / 4 KV heads, vocab 32000) on 8 x 2048 tokens
   in bf16 through ``make_forward_fn``, every layer through the flash
   kernel, checked against an fp32 forward with plain attention;
4. answering requests: greedy ``make_generate_fn`` on 8 prompts of 128
   tokens, 64 new tokens, with ``eos_id`` set, its decode logits checked
   against the full forward on the generated sequence.

It prints the card's name and power limit, a ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``.  Weights are random,
from numpy seed 0.  fp32 references run with TF32 off.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
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


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def flash_bound_ms(B, H, Tq, Tk, D, causal, window, q_off, k_off):
    """Least time for the call: tensor-core FLOPs of QK^T and PV over the
    allowed pairs, or the bytes of q, k, v, o (bf16) and lse (fp32)."""
    flops = 4 * B * H * D * allowed_pairs(Tq, Tk, causal, window, q_off,
                                          k_off)
    nbytes = 2 * B * H * D * (2 * Tq + 2 * Tk) + 4 * B * H * Tq
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes \
        else "bytes"


def phase_kernel(torch, fa):
    """Kernel against plain version; returns the JSON fields of the row."""
    from chainermn_tpu_torch.ops import flash_attention_reference

    cases = [
        ("smoke causal", 8, 2048, dict(causal=True)),
        ("non-causal", 8, 2048, dict(causal=False)),
        ("window 256", 8, 2048, dict(causal=True, window=256)),
        ("k_offset > q_offset", 8, 2048,
         dict(causal=True, q_offset=0, k_offset=1024)),
        ("ragged T=2000", 8, 2000, dict(causal=True)),
    ]
    H, D = 16, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    row = None
    for name, B, T, kw in cases:
        q, k, v = (torch.randn(B, T, H, D, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(3))
        o, lse = fa(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_reference(q, k, v, **kw)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        # bf16 o: final rounding (one ulp = 2^-8 relative) plus rare
        # one-ulp flips of p where fp32 sums differ in order; lse is fp32
        torch.testing.assert_close(o.float(), o_ref.float(), rtol=1e-2,
                                   atol=1e-2)
        torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
        require(bool(torch.isfinite(o.float()).all()),
                f"{name}: o not finite")
        if kw.get("k_offset", 0) > kw.get("q_offset", 0):
            masked = kw["k_offset"] - kw.get("q_offset", 0)
            require(bool((o[:, :masked] == 0).all()),
                    f"{name}: fully masked rows are not zero")
            require(bool((lse[:, :masked] <= -1e29).all()),
                    f"{name}: fully masked rows' lse above -1e29")
        worst = max(worst, err_o)
        print(f"kernel flash_fwd [{name}] B={B} T={T} H={H} D={D}: "
              f"max|o-plain|={err_o:.3e} max|lse-plain|={err_lse:.3e}")
        if row is None:   # the smoke shape: time kernel, plain, library
            ms = cuda_ms(lambda: fa(q, k, v, **kw))
            plain_ms = cuda_ms(
                lambda: flash_attention_reference(q, k, v, **kw), reps=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            library_ms = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
            bound, by = flash_bound_ms(B, H, T, T, D, True, None, 0, 0)
            print(f"kernel flash_fwd timing at B={B} H={H} T={T} D={D} "
                  f"causal bf16: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms(sdpa)={library_ms:.4f} "
                  f"bound={bound * 1e3:.1f} us ({by}) -> "
                  f"{bound / ms:.1%} of bound")
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=by, library_ms=library_ms)
    row["max_abs_err"] = worst
    return row


def rel_err(a, b):
    return ((a - b).norm() / b.norm()).item()


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
    t0 = time.perf_counter()
    logits = forward(params, tokens)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    launches = flash_attention.launches          # the main path ended
    peak = torch.cuda.max_memory_allocated()
    require(launches == cfg.n_layers,
            f"scoring launched flash_fwd {launches} times, want "
            f"{cfg.n_layers}")
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

    kernels = [dict(name="flash_fwd", route="cuda",
                    source="chainermn_tpu_torch/csrc/flash_fwd.cu",
                    replaces="chainermn_tpu/ops/pallas_attention.py:65",
                    launches=launches, matched=True, **row)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
