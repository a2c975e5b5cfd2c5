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
meta (key ``flash_kernel``).

``--paged`` measures the serving side's paged-attention DECODE kernel
instead (K3, `ops.paged_attn`). Decode attention is memory-bound, so
its roofline axis is bytes/s: the traffic model is the block-pool bytes
the table-chasing kernel VISITS (`paged_traffic_bytes`: the visible
blocks of each ragged row, K and V), divided by the measured time of a
call. The point of the paged kernel is that visited bytes, not
``B * max_blocks * block_tokens``, is what moves.

  python -m kungfu_tpu_torch.benchmarks.flash_eff --paged --max-len 2048
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops import flash as fl
from ..ops import paged_attn as pa


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
        "plan": fl.flash_plan(seq, head_dim, causal=causal, window=window,
                              dtype=dt),
        "launches": {n: fl.LAUNCHES[n] - before[n] for n in before},
    }


def paged_inputs(batch: int, max_len: int, block_tokens: int, heads: int,
                 head_dim: int, dtype: torch.dtype, device):
    """The paged measurement's inputs: ``(q, k_pool, v_pool, tables,
    lengths)`` on `device` in `dtype` — q ``[batch, heads, head_dim]``
    and pools of ``1 + batch * max_blocks`` blocks ``[bt, heads,
    head_dim]`` (block 0 the scratch block), standard normal from seed 0
    on the host; ragged lengths ``np.random.default_rng(0).integers(
    max_len // 2, max_len - 1, batch)`` (the traffic model's point) and
    disjoint tables ``1 + arange(batch * max_blocks)``, as the JAX
    package's measurement draws them, so its visited bytes are the same
    number."""
    bt = block_tokens
    max_blocks = -(-max_len // bt)
    num_pool = 1 + batch * max_blocks
    g = torch.Generator().manual_seed(0)
    q = torch.randn(batch, heads, head_dim, generator=g)
    k_pool = torch.randn(num_pool, bt, heads, head_dim, generator=g)
    v_pool = torch.randn(num_pool, bt, heads, head_dim, generator=g)
    rng = np.random.default_rng(0)
    lengths = rng.integers(max_len // 2, max_len - 1,
                           size=batch).astype(np.int32)
    tables = (1 + np.arange(batch * max_blocks, dtype=np.int32)
              .reshape(batch, max_blocks))
    return (q.to(device, dtype), k_pool.to(device, dtype),
            v_pool.to(device, dtype), torch.from_numpy(tables).to(device),
            torch.from_numpy(lengths).to(device))


def measure_paged_bandwidth(batch: int = 8, max_len: int = 2048,
                            block_tokens: int = 16, heads: int = 12,
                            head_dim: int = 64, dtype: str = "bfloat16",
                            iters: int = 20, warmup: int = 3,
                            device: str = "cuda"):
    """Achieved bandwidth of the paged-attention decode kernel (K3) at
    one serving shape. Returns a meta dict.

    Inputs are `paged_inputs`'; every call is `ops.paged_attn.
    paged_attention` with `paged_plan`'s scheme (on the card the CUDA
    kernel, on the CPU its plain version). Per-call time is slope-timed
    as in the JAX package: `warmup` calls, one settling run of ``k_lo =
    iters`` calls, then the least of two runs at ``k_lo`` and at ``k_hi
    = 3 * iters``, each fenced by ``torch.cuda.synchronize()``, and
    ``(t_hi - t_lo) / (k_hi - k_lo)``. Traffic is `paged_traffic_bytes`
    over the ragged lengths. The meta holds the JAX package's keys
    (`decode_ms`, `visited_bytes`, `visited_fraction_of_pool` — the
    saving over a dense gather —, `achieved_gbps`, the plan) plus
    `calls` (the calls made), `launches` (K3's launch counts this
    measurement added, by scheme, and its plain calls) and, on a kind
    listed in `lm._HBM_BYTES_S_BY_KIND`, `bound_ms` (visited bytes over the
    data-sheet rate). The port's `paged_plan` always picks a kernel
    scheme (resident or stream), so the JAX package's ``skipped``
    branch (its plan's functional fallback) has no counterpart here. On
    the CPU the pool shrinks as the JAX package's smoke does (batch <=
    2, max_len <= 64, heads <= 4, bt <= 8, 2 timed calls)."""
    from .lm import _HBM_BYTES_S_BY_KIND

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type == "cpu":
        batch, max_len, heads = min(batch, 2), min(max_len, 64), \
            min(heads, 4)
        block_tokens = min(block_tokens, 8)
        iters, warmup = min(iters, 2), min(warmup, 1)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    bt = block_tokens
    max_blocks = -(-max_len // bt)
    plan = pa.paged_plan(max_blocks, bt, heads, head_dim, dtype=dt)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    meta = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "batch": batch, "max_len": max_len, "block_tokens": bt,
        "heads": heads, "head_dim": head_dim, "dtype": dtype,
        "iters": iters, "plan": plan, "device_kind": kind,
    }
    args = paged_inputs(batch, max_len, bt, heads, head_dim, dt, dev)
    lengths = args[4].cpu().numpy()
    num_pool = args[1].shape[0]
    before = dict(pa.LAUNCHES)
    calls = 0

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(n):
        nonlocal calls
        t0 = time.perf_counter()
        for _ in range(n):
            pa.paged_attention(*args, scheme=plan["scheme"])
        calls += n
        fence()
        return time.perf_counter() - t0

    # the same slope-timing discipline as the flash measurement: the
    # end-of-loop fence is a constant that cancels in the difference
    k_lo, k_hi = max(iters, 1), 3 * max(iters, 1)
    run(max(warmup, 1))
    run(k_lo)
    t_lo = min(run(k_lo) for _ in range(2))
    t_hi = min(run(k_hi) for _ in range(2))
    t = max((t_hi - t_lo) / (k_hi - k_lo), 1e-9)

    isz = args[0].element_size()
    visited = pa.paged_traffic_bytes(lengths, bt, heads, head_dim, isz)
    pool_bytes = 2 * (num_pool - 1) * bt * heads * head_dim * isz
    meta.update({
        "lengths": [int(n) for n in lengths],
        "decode_ms": t * 1000,
        "visited_bytes": int(visited),
        "visited_fraction_of_pool": visited / pool_bytes,
        "achieved_gbps": visited / t / 1e9,
        "calls": calls,
        "launches": {n: pa.LAUNCHES[n] - before[n] for n in before},
    })
    rate = _HBM_BYTES_S_BY_KIND.get(kind)
    if rate:
        meta["bound_ms"] = visited / rate * 1e3
    return meta


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
                    help="measure the paged-attention decode kernel's "
                         "achieved bandwidth instead")
    ap.add_argument("--max-len", type=int, default=2048,
                    help="--paged: per-sequence pool reservation")
    ap.add_argument("--block-tokens", type=int, default=16,
                    help="--paged: KV block size in tokens")
    args = ap.parse_args(argv)
    if args.paged:
        meta = measure_paged_bandwidth(
            args.batch, args.max_len, args.block_tokens, args.heads,
            args.head_dim, dtype=args.dtype, iters=args.iters,
            device=args.device)
        print(json.dumps({
            "metric": "paged_decode_achieved_gbps",
            "value": meta["achieved_gbps"],
            "unit": "GB/s of visited block-pool bytes",
            "details": meta,
        }))
        return 0
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
