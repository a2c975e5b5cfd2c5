"""Microbenchmark: SIMD vs portable reduce-kernel throughput.

The port of `kungfu_tpu/benchmarks/reduce_kernels.py`. Times
``kf_accumulate`` (the kernel every libkf collective accumulates
received chunks with) on both dispatch paths across buffer sizes, in
f16, bf16, f32 and f64 (reference: srcs/go/kungfu/base/f16.c + op.cpp
kernels, exercised by kungfu-bench-allreduce). The work runs on the
host's CPU cores: libkf sums host buffers.

What differs from the reference: bf16 needs no ``ml_dtypes``. Its
buffers are bf16 torch tensors passed as `ffi.host_view`'s uint16 views
with dtype code 9 (`ffi.BF16_CODE`).

Run:  python -m kungfu_tpu_torch.benchmarks.reduce_kernels [--json]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import ffi

#: (name, torch dtype): each row's buffers are standard normal from one
#: seeded generator, cast to the dtype
DTYPES = [
    ("f16", torch.float16),
    ("bf16", torch.bfloat16),
    ("f32", torch.float32),
    ("f64", torch.float64),
]

SIZES = (1 << 12, 1 << 16, 1 << 20, 1 << 24)


def _time_one(dst, src, code, *, force_scalar: bool,
              min_time_s: float = 0.2):
    """Best-of-batches GB/s for one accumulate configuration."""
    def acc():
        ffi.accumulate(dst, src, "sum", force_scalar=force_scalar, code=code)

    acc()  # warm up
    nbytes = dst.nbytes * 2  # read src + read/write dst, count r+w once
    iters = max(1, int(2e7 // max(dst.nbytes, 1)))
    best = 0.0
    t_end = time.perf_counter() + min_time_s
    while time.perf_counter() < t_end:
        t0 = time.perf_counter()
        for _ in range(iters):
            acc()
        dt = (time.perf_counter() - t0) / iters
        best = max(best, nbytes / dt / 1e9)
    return best


def run(sizes=None, min_time_s: float = 0.2):
    """One row a (dtype, size) of `sizes` (default `SIZES`): ``{"dtype",
    "bytes", "scalar_gbps", "simd_gbps", "speedup"}``."""
    g = torch.Generator().manual_seed(0)
    rows = []
    for name, dtype in DTYPES:
        for nbytes in sizes or SIZES:
            n = nbytes // torch.empty((), dtype=dtype).element_size()
            src, code, _ = ffi.host_view(torch.randn(n, generator=g)
                                         .to(dtype))
            dst, _, _ = ffi.host_view(torch.randn(n, generator=g).to(dtype))
            scalar = _time_one(dst.copy(), src, code, force_scalar=True,
                               min_time_s=min_time_s)
            simd = _time_one(dst.copy(), src, code, force_scalar=False,
                             min_time_s=min_time_s)
            rows.append({
                "dtype": name,
                "bytes": nbytes,
                "scalar_gbps": scalar,
                "simd_gbps": simd,
                "speedup": simd / scalar,
            })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true",
                    help="print one JSON object instead of a table")
    args = ap.parse_args(argv)
    rows = run()
    simd = ffi.simd_enabled(np.float32)
    if args.json:
        print(json.dumps({"simd_enabled": simd, "rows": rows}))
        return 0
    print(f"simd dispatch active: {simd}")
    print(f"{'dtype':>6} {'size':>10} {'scalar GB/s':>12} "
          f"{'simd GB/s':>10} {'speedup':>8}")
    for r in rows:
        print(f"{r['dtype']:>6} {r['bytes']:>10} {r['scalar_gbps']:>12.2f} "
              f"{r['simd_gbps']:>10.2f} {r['speedup']:>8.2f}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
