#!/usr/bin/env python3
"""Where a training step's time goes on the card, for the PyTorch/CUDA port.

    python3 scripts/torch_train_profile.py [--ce-variant residual]
        [--attention local|flash] [--steps 5] [--batch 8] [--seq 1024]
        [--size small|tiny|medium] [--trace PATH]

GPT-2-small (or `--size`; f32 master weights, bf16 compute, random
weights from a seed) trained by the LM benchmark's step (`benchmarks.lm.build_lm_train`:
`gpt_fused_loss` with the K2 kernels, the benchmark's AdamW, the plain
causal mixer or the K1 flash kernels). After two warmup steps,
`--steps` steps are timed without the profiler (host
wall, fenced by a loss read), then `--steps` more are traced with
torch.profiler (CPU and CUDA activities). Prints the card's name and
power limit, the torch and CUDA versions and, per step: both host
walls, device busy time (the union of kernel intervals), the device's
idle share against the unprofiled wall (the profiler's own host cost
inflates the profiled wall, not the kernels), the number of kernels
launched, device time by kernel (top 15), and the shares of K1, of K2,
of the cuBLAS products and of the optimizer's multi-tensor kernels.
`--trace` also writes the Chrome trace.

Needs one CUDA card; exits non-zero without one or when the profiler
records no device activity.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _group(name: str) -> str:
    """A kernel's group: K1, K2, cuBLAS products, the optimizer, or
    other."""
    low = name.lower()
    if "k1_" in name or "k1s_" in name:
        return "k1"
    if "k2_" in name:
        return "k2"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "products"
    if "multi_tensor" in low:
        return "optimizer"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ce-variant", default="residual",
                    choices=("residual", "recompute"))
    ap.add_argument("--attention", default="local",
                    choices=("local", "flash"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--size", default="small",
                    choices=("tiny", "small", "medium"))
    ap.add_argument("--trace", default="")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(HERE))
    from kungfu_tpu_torch.benchmarks.lm import build_lm_train

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    _, _, step, tokens = build_lm_train(args.size, args.batch, args.seq,
                                        args.ce_variant, "cuda",
                                        args.attention)
    for _ in range(2):
        step(tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step(tokens)
    float(loss)
    plain_wall_us = 1e6 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = step(tokens)
        float(loss)
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device events, without the ranges that user annotations (such as
    # "Optimizer.step#AdamW.step") add on the device timeline
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        print("torch_train_profile: the profiler recorded no device "
              "activity", file=sys.stderr)
        return 1
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    by_name, by_group = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        g = _group(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
    n = args.steps
    summary = {
        "card": card, "torch": torch.__version__, "size": args.size,
        "ce_variant": args.ce_variant, "attention": args.attention,
        "batch": args.batch, "seq": args.seq, "steps": n,
        "host_wall_ms_per_step": plain_wall_us / n / 1e3,
        "profiled_host_wall_ms_per_step": wall_us / n / 1e3,
        "device_busy_ms_per_step": busy_us / n / 1e3,
        "device_idle_share": 1.0 - busy_us / plain_wall_us,
        "kernels_per_step": len(kernels) / n,
        "ms_per_step_by_group": {g: us / n / 1e3
                                 for g, us in sorted(by_group.items())},
        "share_of_busy_by_group": {g: us / busy_us
                                   for g, us in sorted(by_group.items())},
    }
    print(json.dumps(summary))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / n / 1e3:8.3f} ms/step {100 * us / busy_us:5.1f}%  "
              f"{name[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
