"""Achieved device-memory bandwidth beside the ResNet-50 step: the port of
`kungfu_tpu/benchmarks/roofline.py`'s device half.

- **Achieved-bandwidth suite** (`measure_bandwidth_suite`): streams over
  ~0.5 GiB in four access patterns and reports what the card sustains.
  ``f32_add`` (2 reads + 1 write), ``bf16_add`` and ``bf16_copy``
  (``z = -z``: 1 read + 1 write) are eager torch elementwise ops, the
  counterpart of the JAX package's XLA fusions; ``stream_kernel`` is
  kernel R1 (`ops.stream.stream_neg`, ``o = -x`` over ``[rows, 1024]``
  bf16), the counterpart of its Pallas ``pallas_stream``. The max over
  patterns is the denominator for "at roofline".
- **The ResNet-50 step** (`build_resnet_step`): `bench.py`'s train step,
  timed beside the suite.

The JAX package also parses the compiled step's HLO into a per-op
traffic table and checks that the implied GB/s reconciles with the
suite. An eager torch program has no HLO, so that table and the
`reconciles` verdict are not ported (ROADMAP: a traffic source for the
port's roofline).

  python -m kungfu_tpu_torch.benchmarks.roofline           # on the card
  python -m kungfu_tpu_torch.benchmarks.roofline --device cpu  # smoke

Prints one JSON line: GB/s by pattern, the best, the card's published
peak where known, the step's ms, and R1's launches in the run.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from ..ops import stream as r1
from ..parallel import init_distributed, shutdown_distributed
from .throughput import build_image_train

#: published device-memory bytes/s per card, keyed by
#: torch.cuda.get_device_name (NVIDIA's data sheet, H100 SXM)
_HBM_BYTES_S_BY_KIND = {"NVIDIA H100 80GB HBM3": 3.35e12}

PATTERNS = ("f32_add", "bf16_add", "bf16_copy", "stream_kernel")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def build_resnet_step(device="cuda"):
    """`bench.py`'s ResNet-50 train step on this process's group
    (joined from the KF_* env when there is none; the caller leaves it
    with `parallel.shutdown_distributed`): returns ``(step, args,
    platform)``, run as ``step(*args)``. Batch 128 at 224x224 a card, 8
    at 64x64 on the CPU, as the JAX function."""
    dev = _device(device)
    init_distributed(device=dev)
    cpu = dev.type == "cpu"
    _, _, step, shard = build_image_train("resnet50", 8 if cpu else 128,
                                          64 if cpu else 224)
    return step, (shard,), "cpu" if cpu else "gpu"


def measure_achieved_bandwidth(gib: float = 0.5, iters: int = 20,
                               device="cuda") -> float:
    """Sustained GB/s of the f32 streaming add (2 reads + 1 write),
    slope-timed as `measure_bandwidth_suite`."""
    return measure_bandwidth_suite(gib, iters, ("f32_add",),
                                   device)["f32_add"]


def measure_bandwidth_suite(gib: float = 0.5, iters: int = 20,
                            patterns=PATTERNS, device="cuda"):
    """GB/s by access pattern over ~`gib` GiB, slope-timed: each pattern
    runs k_lo = 2 and k_hi = 3 * max(iters, 20) chained iterations,
    fenced by `torch.cuda.synchronize`, and the rate is the bytes of one
    iteration over (t(k_hi) - t(k_lo)) / (k_hi - k_lo), the median of 3
    — the slope cancels the fixed cost of starting and fencing a run.
    `stream_kernel` is R1 on a ``[rows, 1024]`` bf16 tensor (rows the
    JAX suite's, a multiple of 512). On the CPU this is a harness check,
    not a device rate."""
    dev = _device(device)
    k_lo, k_hi = 2, max(iters, 20) * 3

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(op, x, nbytes_per_iter, reps=3):
        def run(k):
            z = x
            for _ in range(k):
                z = op(z)
            sync()

        for k in (k_lo, k_hi):
            run(k)
        pers = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(k_lo)
            tl = time.perf_counter() - t0
            t0 = time.perf_counter()
            run(k_hi)
            th = time.perf_counter() - t0
            pers.append((th - tl) / (k_hi - k_lo))
        pers.sort()
        return nbytes_per_iter / pers[len(pers) // 2] / 1e9

    results = {}
    if "f32_add" in patterns:
        n = int(gib * (1 << 30) / 4)
        x = torch.arange(n, dtype=torch.float32, device=dev)
        y = torch.ones(n, device=dev)
        results["f32_add"] = timed(lambda z: z + y, x, 3 * n * 4)
        del x, y
    n = int(gib * (1 << 30) / 2)
    if "bf16_add" in patterns:
        xb = torch.ones(n, dtype=torch.bfloat16, device=dev)
        yb = torch.full((n,), 1.0078125, dtype=torch.bfloat16,
                        device=dev)  # 1 + 2**-7: exact in bf16
        results["bf16_add"] = timed(lambda z: z + yb, xb, 3 * n * 2)
        del xb, yb
    if "bf16_copy" in patterns:
        xc = torch.ones(n, dtype=torch.bfloat16, device=dev)
        results["bf16_copy"] = timed(torch.neg, xc, 2 * n * 2)
        del xc
    if "stream_kernel" in patterns:
        rows = (n // 1024) // 512 * 512
        xp = torch.ones(rows, 1024, dtype=torch.bfloat16, device=dev)
        results["stream_kernel"] = timed(r1.stream_neg, xp,
                                         2 * rows * 1024 * 2)
        del xp
    return results


def roofline_report(gib: float = 0.5, iters: int = 20,
                    device="cuda") -> dict:
    """What `main` prints: the bandwidth suite over ~`gib` GiB, then
    `bench.py`'s ResNet-50 step (3 warmup steps, `iters` timed, fenced
    by one loss read; cuDNN's algorithm search on, as `measure_rate`),
    on this process's group (joined from the KF_* env when there is
    none, and left at the end). On the CPU, a harness check at 1/256
    GiB and 3 steps."""
    dev = _device(device)
    if dev.type == "cpu":
        gib, iters = min(gib, 1 / 256), min(iters, 3)
    launches0 = r1.LAUNCHES["neg"]
    suite = measure_bandwidth_suite(gib, iters, device=dev)
    owns = not dist.is_initialized()
    bench = torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.benchmark = True
        step, step_args, platform = build_resnet_step(dev)
        for _ in range(3):
            loss = step(*step_args)
        float(loss)
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = step(*step_args)
        float(loss)   # one fence: each step depends on the one before
        dt = (time.perf_counter() - t0) / iters
    finally:
        torch.backends.cudnn.benchmark = bench
        if owns:
            shutdown_distributed()
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = _HBM_BYTES_S_BY_KIND.get(kind)
    return {
        "metric": "achieved_bandwidth_gb_per_s", "value": max(suite.values()),
        "unit": "GB/s", "platform": platform, "device_kind": kind,
        "peak_gb_per_s": peak / 1e9 if peak else None,
        "achieved_by_pattern_gb_per_s": suite,
        "achieved_streaming_gb_per_s": suite["f32_add"],
        "fraction_of_peak_by_pattern": (
            {k: v * 1e9 / peak for k, v in suite.items()} if peak
            else None),
        "resnet50_step_ms": dt * 1e3,
        "stream_kernel_launches": r1.LAUNCHES["neg"] - launches0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--gib", type=float, default=0.5)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    print(json.dumps(roofline_report(args.gib, args.iters, args.device)))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
