"""Flash-attention kernel efficiency: achieved FLOP/s against the card's
peak — the flash mode of `kungfu_tpu/benchmarks/flash_eff.py`.

Times `ops.flash.flash_attention` forward and forward+backward alone at
one shape, divides by the VISIBLE-pair FLOP count
(`flash_attention_flops`: masked score area is overhead, not work) and
reports achieved TFLOP/s and the efficiency against the card's dense
bf16 peak where the kind is listed (`benchmarks.lm._BF16_PEAK_BY_KIND`),
with the tile plan that ran (`flash_plan`).

  python -m kungfu_tpu_torch.benchmarks.flash_eff --seq 1024 --heads 12
  python -m kungfu_tpu_torch.benchmarks.flash_eff --seq 4096 --window 512

`benchmarks/lm.py --attention flash` embeds the same measurement in its
meta (key ``flash_kernel``). The ``--paged`` decode measurement comes
with the benchmarks slice of the port.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..ops import flash as fl


def measure_flash_efficiency(batch: int = 8, seq: int = 1024,
                             heads: int = 12, head_dim: int = 64,
                             causal: bool = True, window: int | None = None,
                             dtype: str = "bfloat16", iters: int = 20,
                             warmup: int = 3, device: str = "cuda"):
    """Achieved flash-kernel FLOP/s at one attention shape.

    Returns a meta dict: fwd_ms / fwdbwd_ms (per call, slope-timed:
    ``(t(3n) - t(n)) / 2n`` over runs fenced by
    ``torch.cuda.synchronize()``, so the fence's own cost cancels),
    achieved TFLOP/s for both, `efficiency_vs_bf16_peak` (fwd+bwd, the
    number a training step sees; None off listed kinds and for f32), the
    `flash_plan` and ``launches``: the K1 launches this measurement made
    (so a caller that counts a training run's launches can take these
    out). On the CPU the shape shrinks (batch <= 2, seq <= 256, heads
    <= 4, 2 timed calls) and the plain versions run."""
    from .lm import _BF16_PEAK_BY_KIND

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type == "cpu":
        batch, seq, heads = min(batch, 2), min(seq, 256), min(heads, 4)
        iters, warmup = min(iters, 2), min(warmup, 1)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(batch, seq, heads, head_dim, generator=g)
               .to(dev, dt).requires_grad_() for _ in range(3))
    before = dict(fl.LAUNCHES)

    def fwd():
        with torch.no_grad():
            return fl.flash_attention(q, k, v, causal=causal, window=window)

    def grad():
        out = fl.flash_attention(q, k, v, causal=causal, window=window)
        return torch.autograd.grad(out.float().sum(), (q, k, v))

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        k_lo, k_hi = max(iters, 1), 3 * max(iters, 1)

        def run(n):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            fence()
            return time.perf_counter() - t0

        for _ in range(max(warmup, 1)):
            fn()
        fence()
        t_lo = min(run(k_lo) for _ in range(2))
        t_hi = min(run(k_hi) for _ in range(2))
        return max((t_hi - t_lo) / (k_hi - k_lo), 1e-9)

    t_fwd = timed(fwd)
    t_both = timed(grad)
    f_fwd = fl.flash_attention_flops(batch, seq, heads, head_dim, causal,
                                     window)
    f_both = fl.flash_attention_flops(batch, seq, heads, head_dim, causal,
                                      window, backward=True)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    peak = (_BF16_PEAK_BY_KIND.get(kind) if dtype == "bfloat16" else None)
    return {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "batch": batch, "seq": seq, "heads": heads, "head_dim": head_dim,
        "causal": causal, "window": window, "dtype": dtype, "iters": iters,
        "fwd_ms": t_fwd * 1000, "fwdbwd_ms": t_both * 1000,
        "fwd_tflops": f_fwd / t_fwd / 1e12,
        "fwdbwd_tflops": f_both / t_both / 1e12,
        "efficiency_vs_bf16_peak": (f_both / t_both / peak if peak
                                    else None),
        "device_kind": kind,
        "plan": fl.flash_plan(seq, head_dim, causal=causal, window=window),
        "launches": {n: fl.LAUNCHES[n] - before[n] for n in before},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--no-causal", action="store_true")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paged", action="store_true",
                    help="the paged decode kernel's bandwidth (not ported "
                         "yet)")
    args = ap.parse_args(argv)
    if args.paged:
        raise NotImplementedError(
            "--paged is not ported yet; it comes with the benchmarks slice "
            "of the port")
    meta = measure_flash_efficiency(
        args.batch, args.seq, args.heads, args.head_dim,
        causal=not args.no_causal, window=args.window, dtype=args.dtype,
        iters=args.iters, device=args.device)
    print(json.dumps({
        "metric": "flash_kernel_efficiency_vs_bf16_peak",
        "value": meta["efficiency_vs_bf16_peak"],
        "unit": "fraction_of_peak",
        "details": meta,
    }))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
