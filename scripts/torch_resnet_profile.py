#!/usr/bin/env python3
"""Where a ResNet-50 S-SGD step's time goes on the card, for the
PyTorch/CUDA port.

    python3 scripts/torch_resnet_profile.py [--steps 5] [--batch 128]
        [--image 224] [--trace PATH]

`bench.py`'s configuration through the port's throughput benchmark
(`benchmarks.throughput.build_image_train`): ResNet-50 v1.5 with the
space-to-depth stem, bf16 compute over f32 parameters and BatchNorm
statistics, synthetic images, sync_sgd(SGD(0.1, momentum 0.9)) with the
statistics synced, under a one-rank NCCL group (random weights from a
seed). After three warmup steps (cuDNN's algorithm search runs there),
`--steps` steps are timed without the profiler (host wall, fenced by a
loss read), then `--steps` more are traced with torch.profiler (CPU and
CUDA activities). Prints the card's name and power limit, the torch and
CUDA versions and, per step: both host walls, device busy time (the
union of kernel intervals), the device's idle share against the
unprofiled wall, the number of kernels launched, device time by kernel
(top 15), and by group: convolutions and products (cuDNN's and cuBLAS's
kernels, the head's one small product among them), the all-reduce
(NCCL's kernels), device-to-device copies and fills (at one rank NCCL
runs no kernel), the optimizer (the SGD's multi-tensor kernels), and
BatchNorm and the other elementwise work, with each group's three
largest kernels. `--trace` also writes the Chrome trace.

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

CONV_WORDS = ("conv", "fprop", "dgrad", "wgrad", "implicit", "xmma",
              "cudnn", "gemm", "cutlass", "nvjet", "cublas")


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _group(name: str) -> str:
    low = name.lower()
    if "nccl" in low:
        return "all_reduce"
    if low.startswith(("memcpy", "memset")):
        return "memcpy"
    if "multi_tensor" in low:
        return "optimizer"
    if any(w in low for w in CONV_WORDS):
        return "convolutions"
    return "bn_elementwise"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--trace", default="")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_resnet_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(HERE))
    from kungfu_tpu_torch.benchmarks.throughput import build_image_train
    from kungfu_tpu_torch.parallel import (init_distributed,
                                           shutdown_distributed)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    init_distributed(device="cuda")
    try:
        torch.backends.cudnn.benchmark = True
        _, _, step, shard = build_image_train("resnet50", args.batch,
                                              args.image)
        for _ in range(3):
            step(shard)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = step(shard)
        float(loss)
        plain_wall_us = 1e6 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                loss = step(shard)
            float(loss)
            wall_us = 1e6 * (time.perf_counter() - t0)
    finally:
        shutdown_distributed()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        print("torch_resnet_profile: the profiler recorded no device "
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
        "card": card, "torch": torch.__version__, "batch": args.batch,
        "image": args.image, "steps": n,
        "host_wall_ms_per_step": plain_wall_us / n / 1e3,
        "images_per_sec": args.batch * n / (plain_wall_us / 1e6),
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
              f"[{_group(name)}] {name[:100]}")
    for g in sorted(by_group):
        top = sorted(((us, k) for k, us in by_name.items()
                      if _group(k) == g), reverse=True)[:3]
        for us, k in top:
            print(f"  [{g}] {us / n / 1e3:8.3f} ms/step  {k[:120]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
