#!/usr/bin/env python3
"""Where the port's time goes on the card: a ``torch.profiler`` trace of
one scoring forward and one greedy generation of the flagship config
that ``chip_smoke.py`` drives, summed by kernel.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 profile_port.py

For each path it prints the host wall time of one synchronised call,
the device busy time (the sum of kernel times; one stream, so kernels
do not overlap), the idle share, the time by kind of kernel (the flash
kernel, matrix products, the rest) and the ten kernels that take most
of it.  Weights are random (numpy seed 0).
"""

import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

from chip_smoke import FLAGSHIP, SEED


def kind(name):
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    low = name.lower()
    if any(w in low for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                              "cublas")):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def trace(torch, fn, label):
    from torch.profiler import ProfilerActivity, profile

    fn()                                   # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, by_kind, launches = defaultdict(float), defaultdict(float), 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.device_time_total
            by_kind[kind(e.name)] += e.device_time_total
            launches += 1
    busy = sum(by_name.values())
    if busy <= 0:
        raise RuntimeError(f"{label}: the profiler saw no device time")
    print(f"{label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, idle {1 - busy / wall_us:.1%}, "
          f"{launches} kernel launches")
    for k, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {k:40s} {us / 1e3:9.3f} ms {us / busy:6.1%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / 1e3:9.3f} ms {us / busy:6.1%}  {name[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from chainermn_tpu_torch.models import (
        TransformerConfig,
        init_numpy_params,
        make_forward_fn,
        make_generate_fn,
        params_from_jax,
    )

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    cfg = TransformerConfig(**FLAGSHIP)
    params = params_from_jax(init_numpy_params(cfg, SEED), cfg)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
