#!/usr/bin/env python3
"""Where a decode step's time goes on the card, for the PyTorch/CUDA port.

    python3 scripts/torch_decode_profile.py [--steps 20] [--batch 8]
        [--prompt 256] [--trace PATH]

GPT-2-small (bf16, random weights from a seed) behind `DecodeEngine`
(block 16, max_len 1024, the default kernel: K3 on the card) with
`--batch` rows decoding at once after a `--prompt`-token prefill each.
`--steps` steady-state `step()` calls are traced with torch.profiler
(CPU and CUDA activities). Prints, per step: host wall, device busy
time (the union of kernel intervals), the device's idle share, the
number of kernels launched, and device time by kernel (top 12) with
K3's share. `--trace` also writes the Chrome trace.

Needs one CUDA card; exits non-zero without one or when the profiler
records no device activity.
"""

from __future__ import annotations

import argparse
import json
import os
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--trace", default="")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(HERE))
    from kungfu_tpu_torch.serve import DecodeEngine, build_lm

    model = build_lm("small", max_position=1024, seed=0)
    eng = DecodeEngine(model, max_batch=args.batch, block_tokens=16,
                       max_len=1024)
    eng.warm()
    rng = np.random.default_rng(0)
    for r in range(args.batch):
        prompt = [int(t) for t in rng.integers(0, 50257, args.prompt)]
        eng.admit(r, prompt, 1024)
    for _ in range(5):                      # steady state: every row decoding
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("torch_decode_profile: the profiler recorded no device "
              "activity", file=sys.stderr)
        return 1
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    k3_us = sum(v for k, v in by_name.items() if "k3_" in k)
    n = args.steps
    summary = {
        "card": torch.cuda.get_device_name(0), "batch": args.batch,
        "prompt": args.prompt, "steps": n, "kernel": eng.kernel,
        "host_wall_ms_per_step": wall_us / n / 1e3,
        "device_busy_ms_per_step": busy_us / n / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernels_per_step": len(kernels) / n,
        "k3_ms_per_step": k3_us / n / 1e3,
        "k3_share_of_busy": k3_us / busy_us,
    }
    print(json.dumps(summary))
    for name, us in top[:12]:
        print(f"  {us / n:9.1f} us/step {100 * us / busy_us:5.1f}%  "
              f"{name[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
