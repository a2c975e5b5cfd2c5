#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`kungfu_tpu_torch`) on one card.

    python3 chip_smoke.py

Builds every CUDA kernel of the serving, training and roofline paths
from the sources in this checkout (nvcc, sm_90a; one nvcc per library,
all four started together, beside libkf's g++ build), then runs,
failing on the first phase that fails:

1. kernel — K3 (`paged_attn.resident`, `paged_attn.stream`) against its
   plain PyTorch version at the serving shapes (B=8, h=12, d=64, bt=16,
   max_blocks=64, a 12-layer pool viewed through block_base) in bf16
   and f32, and a second launch bitwise equal to the first;
2. kernel-K2 — the four fused head+CE kernels (`fused_ce.fwd` with and
   without the residual, `fused_ce.residual_d`, `fused_ce.dw`,
   `fused_ce.dx`) against their plain versions at the GPT-2-small
   training shape (N = 8 x 1023 rows, H=768, V=50257, padded to the
   port's tiles), with rows whose target is -1 and rows whose target
   is >= v_pad; loss, lse, tl, logits, d, db, dW and dx;
2b. kernel-K1 — the three flash-attention kernels (`flash.fwd`,
   `flash.dq`, `flash.dkv`) on bf16 inputs against their plain versions
   run in f32 on the same values: o, lse, delta, dq, dk and dv at (a)
   the training shape B=8, T=1024, h=12, d=64, causal; (b) B=2, T=4096,
   causal, window 512; (c) B=2, T=1024, non-causal, d=128; (d) the ring
   hop's contract: the global (o, lse) of a causal 2048-token sequence,
   and `flash_bwd` of its second-half queries against each half of the
   keys;
2c. kernel-R1 — the HBM streaming probe (`stream.neg`, ``o = -x`` in
   bf16) bitwise against its plain version, torch.neg: at the bandwidth
   suite's shape [262144, 1024] (0.5 GiB), a ragged row count, the
   lengths at the edges of its plan (below one vector, one chunk +- 8,
   the grid's chunks +- 1, an odd length: the tail path), a tensor of
   +-0, +-inf, NaNs of both signs, denormals and +-max, and all 65536
   bf16 bit patterns; a second launch bitwise equal to the first;
3. serve — GPT-2-small at full width (bf16, random weights from a
   seed) behind `DecodeEngine` (max_batch 8, bt 16, max_len 1024,
   prefix sharing, 256-token prefill chunks) answering 12 requests;
   driven once with the default kernel ("auto", the plan's resident
   scheme) and once with kernel="stream", the launch counts zeroed just
   before each run and read just after;
4. parity — a 2-layer f32 model at GPT-2-small width: the engine's
   kernel paths give the same tokens as its functional oracle and as
   dense-cache `gpt_generate`;
5. train — `benchmarks.lm.measure_lm_rate` on GPT-2-small at full
   width and depth (f32 master weights, bf16 compute, batch 8, seq
   1024), once with the residual fused-CE backward and once with the
   recompute one, the K2 launch counts zeroed just before each run and
   read just after; the loss must be finite and fall (the batch is the
   same every step); then a third time with attention="flash" (residual
   CE), where K1 must launch 12 times a step per kernel and its plain
   versions never;
5b. resnet — `bench.py`'s headline through the port's entry point,
   `benchmarks.throughput.measure_rate("resnet50", 1)`: ResNet-50 v1.5
   at full size (space-to-depth stem, bf16 compute over f32 parameters
   and BatchNorm statistics, batch 128 at 224x224, synthetic data),
   sync_sgd(SGD(0.1, momentum 0.9)) under a one-rank NCCL group, 3
   warmup and 20 timed steps; the loss must be finite and fall, the
   BatchNorm running statistics finite and moved, and sync_sgd must
   have issued its 161 gradient all-reduces a step; the group is gone
   after it;
5c. roofline — `benchmarks.roofline.roofline_report`, `main`'s path:
   the bandwidth suite (f32 add, bf16 add, bf16 neg, R1) over 0.5 GiB
   beside the card's 3.35 TB/s, and the ResNet-50 step; R1 must have
   launched, its plain version never (R1's launch count is zeroed just
   before and read just after);
7. elastic — runs after 5c and before the timing of 6: the elastic
   training worker path through the port's harness
   (`elastic.harness`): a config server, ``kfrun -w``
   (`python -m kungfu_tpu_torch.run`) and continuity workers
   (`elastic.continuity_worker --model gpt`) sharing the card, each
   training GPT-2-small at full width and depth (batch 8 x 1024,
   flash attention, residual fused CE, AdamW, f32 master weights, bf16
   compute) with its gradients fused into one f32 buffer and summed by
   libkf. (a) schedule 3:1,3:2,3:1 over 9 steps: grow 1 -> 2 (the
   joiner proves the broadcast parameters and AdamW state beat its
   fresh init), then shrink to 1 with an eviction; (b) two workers,
   rank 1 killed by a chaos fault after step 3 of 8: the survivor
   recovers (every KF_MTTR phase), trains on, and the schedule grows a
   replacement joiner back. Every continuity and recovery marker must
   show, a parameter digest must be agreed after every resync, and each
   worker's flash and fused-CE kernels must have launched, their plain
   versions never. Prints, per cluster size, the step's wall, compute,
   libkf all-reduce and staging ms, each resync's ms and bytes, the
   KF_MTTR phases and each worker's peak memory, beside the card;
6. timing — each K3 scheme per launch at B=8 full 1023-token rows and
   at the serve run's mixed lengths (32..576), cycling through the 12
   layers' pools, and each K2 kernel per launch at the training shape,
   beside its bound, its plain version and the library calls that do
   the same work (scaled_dot_product_attention on pre-gathered K/V for
   K3, with and without the mask, with the backend it took; the cuBLAS
   products inside each K2 kernel; timed here only — the port never
   calls them); and each K1 kernel per launch at shapes (a) and (b) by
   device time, cycling over four input sets so L2 holds none of a
   launch's inputs, beside its bound, its plain version and
   scaled_dot_product_attention's forward and its backward alone (the
   one call that computes dq, dk and dv: the library time of the pair
   dq + dkv), with the backends SDPA picks and each one's time when
   forced; and R1 per
   launch at [262144, 1024] by device time (and by events) beside its
   byte bound and torch.neg (its plain version and the library call at
   once), timed the same way.

Prints the card's name and power limit, the measurements, a
``{"kernels": [...]}`` line (K1's and K2's rows also carry
``elastic_launches``, the elastic workers' launches) and, last,
``{"ok": true, "device": ...}``.
Exits non-zero without that line when there is no CUDA card or the
package is missing. Takes no arguments: every phase runs every time.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

#: the H100 SXM's published peaks (NVIDIA data sheet): HBM3 bytes/s,
#: f32 FLOP/s outside the tensor cores (K3's arithmetic, K2's
#: elementwise work) and dense bf16 tensor-core FLOP/s (K2's products)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

BT, HEADS, HEAD_DIM, BATCH, MAX_LEN = 16, 12, 64, 8, 1024
MAX_BLOCKS = MAX_LEN // BT
LAYERS = 12
DEVICE = "cuda"
#: (atol, rtol). bf16: both sides round an f32 result once, so they may
#: differ by one bf16 ulp, at most 2**-7 = 7.8e-3 of |ref|; atol 1e-3
#: only covers values near zero. f32: the same arithmetic in another
#: summation order.
TOL = {"bfloat16": (1e-3, 8e-3), "float32": (1e-5, 1e-5)}
REPLACES = {"resident": "kungfu_tpu/ops/paged_attn.py:158",
            "stream": "kungfu_tpu/ops/paged_attn.py:195"}

#: the GPT-2-small training shape of the fused head: B=8 x (T-1)=1023
#: rows, H=768, V=50257
K2_N, K2_H, K2_V = 8 * 1023, 768, 50257
K2_REPLACES = {"fwd": "kungfu_tpu/ops/fused_ce.py:145",
               "residual_d": "kungfu_tpu/ops/fused_ce.py:189",
               "dw": "kungfu_tpu/ops/fused_ce.py:240",
               "dx": "kungfu_tpu/ops/fused_ce.py:267"}
#: K2 tolerances. f32 outputs (lse, tl, db, the loss): sums of the same
#: f32 terms in another order — rtol 1e-5, atol 1e-5 * max|ref|. bf16
#: outputs of short sums (logits: 768 terms; d: one value): both sides
#: round an f32 value once, and sums in different orders may straddle a
#: rounding boundary, so an element may differ by one bf16 ulp (<= 2**-7
#: * |ref|): 99.9 % of elements within that, every element within
#: 2**-7 * max|ref|. dW and dx sum n = 8192 (dW) or 50304 (dx) products
#: with heavy cancellation (the one-hot term against the softmax mass),
#: where the order of an f32 sum moves a small result by more than an
#: ulp: every element within one ulp of |ref| plus twice the worst-case
#: f32 summation error n * 2**-23 * sum|terms| (2**-23: the tensor
#: cores' accumulation may truncate), and 99 % within one ulp.
K2_F32_RTOL = 1e-5
K2_BF16_ULP = 2.0 ** -7
K2_BF16_OUTSIDE = 1e-3
K2_SUM_OUTSIDE = 1e-2
#: train phase: timed steps after the warmup steps, per CE variant
TRAIN_WARMUP, TRAIN_ITERS = 2, 8

#: K1's shapes: (B, T, h, d, causal, window); (a) is the training shape
K1_SHAPES = {"a": (8, 1024, 12, 64, True, None),
             "b": (2, 4096, 12, 64, True, 512),
             "c": (2, 1024, 8, 128, False, None)}
#: (d) the ring hop: (B, Ts, h, d), keys split in two halves of Ts
K1_HOP = (4, 1024, 12, 64)
K1_REPLACES = {
    "fwd": "kungfu_tpu/ops/flash.py:437 (_fwd_res_kernel, resident), "
           ":375 (_kernel, stream)",
    "dq": "kungfu_tpu/ops/flash.py:477 (_dq_res_kernel, resident), "
          ":801 (_bwd_dq_kernel, stream)",
    "dkv": "kungfu_tpu/ops/flash.py:510 (_dkv_res_kernel, resident), "
           ":845 (_bwd_dkv_kernel, stream)"}

#: R1: the bandwidth suite's stream shape (0.5 GiB of bf16)
R1_SHAPE = (262144, 1024)
R1_REPLACES = "kungfu_tpu/benchmarks/roofline.py:237"
#: bf16 bit patterns R1 must negate as torch.neg does: +-0, +-inf, quiet
#: and signalling NaNs of both signs, +-smallest denormal, +-max, 1
R1_SPECIALS = (0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7F81,
               0xFF81, 0x7FFF, 0x0001, 0x8001, 0x7F7F, 0xFF7F, 0x3F80)
#: the ResNet-50 S-SGD run: sync_sgd's gradient all-reduces a step (one
#: per parameter leaf)
RESNET_LEAVES = 161
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def pools(torch, dtype, seed=0):
    """A serving-shaped pool: 12 layers x (512 blocks + scratch), as
    `DecodeEngine(max_batch=8, block_tokens=16, max_len=1024)` holds."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    nbp1 = BATCH * MAX_BLOCKS + 1
    shape = (LAYERS * nbp1, BT, HEADS, HEAD_DIM)
    kp = torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    vp = torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    return kp, vp, nbp1


def tables_for(torch, lengths, seed=1):
    g = torch.Generator().manual_seed(seed)
    tbl = (torch.randperm(BATCH * MAX_BLOCKS, generator=g) + 1).reshape(
        BATCH, MAX_BLOCKS).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32)
    tbl[lens == 0] = 0
    return tbl.to(DEVICE), lens.to(DEVICE)


def phase_kernel(torch, pa):
    """Both schemes against the plain version; returns max errors."""
    errs = {}
    lengths = [0, 15, 16, 17, 511, 1023, 255, 700]
    tables, lens = tables_for(torch, lengths)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        kp, vp, nbp1 = pools(torch, dtype)
        g = torch.Generator(device=DEVICE).manual_seed(2)
        q = torch.randn(BATCH, HEADS, HEAD_DIM, generator=g,
                        device=DEVICE).to(dtype)
        base = (LAYERS // 2) * nbp1         # a middle layer of the pool
        ref = pa.paged_attention_reference(q, kp, vp, tables, lens,
                                           block_base=base)
        plan = pa.paged_plan(MAX_BLOCKS, BT, HEADS, HEAD_DIM, dtype=dtype)
        for scheme in ("resident", "stream"):
            got = pa.paged_attention(q, kp, vp, tables, lens,
                                     block_base=base, scheme=scheme)
            again = pa.paged_attention(q, kp, vp, tables, lens,
                                       block_base=base, scheme=scheme)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  f"{scheme} {name}: non-finite output")
            check(torch.equal(got, again),
                  f"{scheme} {name}: a second launch gave other bits")
            err = (got.float() - ref.float()).abs()
            atol, rtol = TOL[name]
            bad = err > atol + rtol * ref.float().abs()
            errs[(scheme, name)] = float(err.max())
            log(f"kernel {scheme:8s} {name:8s} max_abs_err "
                f"{errs[(scheme, name)]:.3e} (tolerance {atol:g} + "
                f"{rtol:g}*|ref|), second launch bitwise equal; "
                f"{plan['splits']} splits of {plan['split_blocks']} blocks "
                f"(grid {plan['splits']} x {HEADS} x {BATCH}), tiles of "
                f"{plan['tile_blocks']} blocks, smem {plan[scheme + '_bytes']}"
                f" B")
            check(not bool(bad.any()), f"{scheme} {name}: "
                  f"{int(bad.sum())} elements outside tolerance")
        del kp, vp
    return errs


def k2_inputs(torch, fc, seed=0):
    """Padded fused-head operands at the training shape: x [8192, 768]
    bf16 (rows past N zero), W [768, 50304] bf16 ~ N(0, 1/H), b f32
    (padded columns _PAD_BIAS), t int32 with -1 on the pad rows and on
    every 97th row, and a target >= v_pad on every 101st row (a valid
    row whose target lies in another vocab shard); scale = 1/N_valid."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n_pad = -(-K2_N // fc.ROW_MULTIPLE) * fc.ROW_MULTIPLE
    v_pad = -(-K2_V // fc.COL_MULTIPLE) * fc.COL_MULTIPLE
    x = torch.zeros(n_pad, K2_H, device=DEVICE, dtype=torch.bfloat16)
    x[:K2_N] = torch.randn(K2_N, K2_H, generator=g, device=DEVICE)
    w = torch.zeros(K2_H, v_pad, device=DEVICE, dtype=torch.bfloat16)
    w[:, :K2_V] = torch.randn(K2_H, K2_V, generator=g, device=DEVICE) \
        * K2_H ** -0.5
    b = torch.full((1, v_pad), fc._PAD_BIAS, device=DEVICE)
    b[0, :K2_V] = torch.randn(K2_V, generator=g, device=DEVICE) * 0.02
    t = torch.full((n_pad, 1), -1, dtype=torch.int32, device=DEVICE)
    t[:K2_N, 0] = torch.randint(0, K2_V, (K2_N,), generator=g,
                                device=DEVICE, dtype=torch.int32)
    t[0:K2_N:97, 0] = -1
    t[5:K2_N:101, 0] = v_pad + 3
    scale = (1.0 / (t >= 0).sum().float()).reshape(1, 1)
    return x, w, b, t, scale


def k2_check(torch, name, got, ref, n_sum=0, absum=None):
    """Hold a K2 output against its plain version (tolerances above);
    `absum` is sum|terms| of each element of a long sum of `n_sum`
    products. Returns the max |got - ref|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    top = float(ref.abs().max())
    if absum is not None:
        bound = K2_BF16_ULP * ref.abs() + 2 * n_sum * 2.0 ** -23 * absum
        outside = float((err > K2_BF16_ULP * ref.abs()).float().mean())
        log(f"kernel-K2 {name:6s} max_abs_err {float(err.max()):.3e} "
            f"(max |ref| {top:.3e}); beyond one bf16 ulp: {outside:.2e} "
            f"of elements (tolerance {K2_SUM_OUTSIDE:g}); max err / bound "
            f"{float(torch.where(bound > 0, err / bound, err).max()):.3f}")
        check(outside <= K2_SUM_OUTSIDE and not bool((err > bound).any()),
              f"K2 {name} outside tolerance")
    elif name in ("logits", "d"):
        outside = float((err > K2_BF16_ULP * ref.abs()).float().mean())
        log(f"kernel-K2 {name:6s} max_abs_err {float(err.max()):.3e} "
            f"(max |ref| {top:.3e}); beyond one bf16 ulp: {outside:.2e} "
            f"of elements (tolerance {K2_BF16_OUTSIDE:g}, and "
            f"{K2_BF16_ULP:g}*max|ref|)")
        check(outside <= K2_BF16_OUTSIDE
              and float(err.max()) <= K2_BF16_ULP * top,
              f"K2 {name} outside tolerance")
    else:
        bad = err > K2_F32_RTOL * (ref.abs() + top)
        log(f"kernel-K2 {name:6s} max_abs_err {float(err.max()):.3e} "
            f"(max |ref| {top:.3e}; tolerance {K2_F32_RTOL:g}*(|ref| + "
            f"max|ref|))")
        check(not bool(bad.any()), f"K2 {name}: {int(bad.sum())} elements "
              f"outside tolerance")
    check(bool(torch.isfinite(got).all()), f"K2 {name}: non-finite")
    return float(err.max())


def phase_kernel_k2(torch, fc):
    """The four K2 kernels against their plain versions at the training
    shape; returns {kernel: max_abs_err} (fwd: over lse, tl and the
    logits residual)."""
    x, w, b, t, scale = k2_inputs(torch, fc)
    plan = fc.fused_ce_plan(x.shape[0], K2_H, w.shape[1])
    log(f"kernel-K2 shape x {tuple(x.shape)} W {tuple(w.shape)}; plan "
        f"{json.dumps(plan)}")
    errs = {}
    rl, rlse, rtl = fc.plain_fwd(x, w, b, t, True)
    logits, lse, tl = fc.fused_ce_fwd(x, w, b, t, True)
    _, lse2, tl2 = fc.fused_ce_fwd(x, w, b, t, False)
    torch.cuda.synchronize()
    errs["fwd"] = max(k2_check(torch, "lse", lse, rlse),
                      k2_check(torch, "tl", tl, rtl),
                      k2_check(torch, "lse-nr", lse2, rlse),
                      k2_check(torch, "tl-nr", tl2, rtl),
                      k2_check(torch, "logits", logits, rl))
    check(float(tl[0]) == 0.0 and float(tl[5]) == 0.0,
          "K2 fwd: a sentinel target hit a column")
    loss, _ = fc._loss_from(lse, tl, t)
    ref_loss, _ = fc._loss_from(rlse, rtl, t)
    k2_check(torch, "loss", loss.reshape(1), ref_loss.reshape(1))
    del logits
    d, db = fc.fused_ce_residual_d(scale, rl.clone(), rlse, t)
    rd, rdb = fc.plain_residual_d(scale, rl, rlse, t)
    torch.cuda.synchronize()
    errs["residual_d"] = k2_check(torch, "d", d, rd)
    k2_check(torch, "db", db, rdb)
    check(not bool(d[0].float().any()) and not bool(d[:, K2_V:].float()
                                                     .any()),
          "K2 residual_d: gradient on a dropped row or a padded column")
    del d, rd, rl
    torch.cuda.empty_cache()
    dw, db = fc.fused_ce_dw(scale, x, w, b, t, rlse)
    rdw, rdb = fc.plain_dw(scale, x, w, b, t, rlse)
    # sum|terms| of each product element: |x|^T |bf16(d)| and |bf16(d)| |W|^T
    ad = fc._d_f32(fc._logits_f32(x, w, b), rlse, t, scale).to(
        torch.bfloat16).float().abs()
    torch.cuda.synchronize()
    errs["dw"] = k2_check(torch, "dW", dw, rdw, x.shape[0],
                          x.float().abs().t() @ ad)
    k2_check(torch, "db-dw", db, rdb)
    del dw, rdw
    torch.cuda.empty_cache()
    dx = fc.fused_ce_dx(scale, x, w, b, t, rlse)
    rdx = fc.plain_dx(scale, x, w, b, t, rlse)
    torch.cuda.synchronize()
    errs["dx"] = k2_check(torch, "dx", dx, rdx, w.shape[1],
                          ad @ w.float().abs().t())
    del ad
    check(not bool(dx[0].float().any()), "K2 dx: gradient on a dropped row")
    torch.cuda.empty_cache()
    return errs


def k1_inputs(torch, b, t, h, d, seed):
    """q, k, v, dO [B, T, h, d] bf16 ~ N(0, 1) from a seed."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn(b, t, h, d, generator=g, device=DEVICE).to(
        torch.bfloat16) for _ in range(4)]


def k1_check(torch, tag, name, got, ref, bound):
    """Hold a K1 output against its plain version with the element-wise
    tolerance of `ops.flash.kernel_error_bounds` (its docstring gives
    the reasons): |got - ref| <= 2**-8 |ref| + bound for the bf16 o, dq,
    dk and dv, <= bound for the f32 lse and delta. Returns max |err|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if name in ("o", "dq", "dk", "dv"):
        bound = bound + 2.0 ** -8 * ref.abs()
    ratio = float((err / bound).max())
    log(f"kernel-K1 {tag} {name:5s} max_abs_err {float(err.max()):.3e} (max "
        f"|ref| {float(ref.abs().max()):.3e}); max err / tolerance "
        f"{ratio:.3f}")
    check(bool(torch.isfinite(got).all()), f"K1 {tag} {name}: non-finite")
    check(ratio <= 1.0, f"K1 {tag} {name}: outside tolerance")
    return float(err.max())


def k1_case(torch, fl, tag, b, t, h, d, causal, window, seed=0):
    """The three kernels on one shape against their plain versions on
    the same inputs: dq and the plain dq get the forward kernel's (o,
    lse), dkv and the plain dkv also the dq kernel's delta. Returns
    {kernel: max_abs_err}."""
    q, k, v, do = k1_inputs(torch, b, t, h, d, seed)
    plan = fl.flash_plan(t, d, causal, window)
    log(f"kernel-K1 ({tag}) B={b} T={t} h={h} d={d} causal={causal} "
        f"window={window}; plan {json.dumps(plan)}")
    o, lse = fl.flash_fwd(q, k, v, causal, None, window)
    dq, delta = fl.flash_dq(q, k, v, o, lse, do, causal, None, window)
    dk, dv = fl.flash_dkv(q, k, v, do, lse, delta, causal, None, window)
    torch.cuda.synchronize()
    f = [x.float() for x in (q, k, v, do)]
    ro, rlse = fl.plain_fwd(*f[:3], causal, None, window)
    bound = fl.kernel_error_bounds(*f[:3], ro, rlse, f[3], causal, None,
                                   window)
    errs = {"fwd": max(k1_check(torch, tag, "o", o, ro, bound["o"]),
                       k1_check(torch, tag, "lse", lse, rlse, bound["lse"]))}
    del ro, rlse, bound
    bound = fl.kernel_error_bounds(*f[:3], o, lse, f[3], causal, None,
                                   window)
    rdq, rdelta = fl.plain_dq(*f[:3], o.float(), lse, f[3], causal, None,
                              window)
    errs["dq"] = max(k1_check(torch, tag, "dq", dq, rdq, bound["dq"]),
                     k1_check(torch, tag, "delta", delta, rdelta,
                              bound["delta"]))
    del rdq, rdelta
    rdk, rdv = fl.plain_dkv(*f[:3], f[3], lse, delta, causal, None, window)
    errs["dkv"] = max(k1_check(torch, tag, "dk", dk, rdk, bound["dk"]),
                      k1_check(torch, tag, "dv", dv, rdv, bound["dv"]))
    return errs


def k1_hop(torch, fl, seed=5):
    """(d) the ring hop: a causal sequence of 2 x 1024 tokens, B=4,
    h=12, d=64; the global (o, lse) of its second half from the plain
    forward over the whole sequence; `flash_bwd` of the second-half
    queries against each half of the keys (off-diagonal non-causal,
    diagonal causal) with that external (o, lse), against the plain hop
    formula (plain_dq / plain_dkv, as sequence.py:213-226 computes it).
    The two hops' dq must also sum to the whole sequence's dq rows."""
    b, ts, h, d = K1_HOP
    q, k, v, do = k1_inputs(torch, b, 2 * ts, h, d, seed)
    f = [x.float() for x in (q, k, v, do)]
    ro, rlse = fl.plain_fwd(*f[:3], True)
    o_g = ro[:, ts:].to(torch.bfloat16).contiguous()
    lse_g = rlse.reshape(b, h, 2 * ts)[..., ts:].reshape(b * h, ts) \
        .contiguous()
    q2, do2 = q[:, ts:].contiguous(), do[:, ts:].contiguous()
    errs, dq_sum, dq_bound = {}, 0.0, 0.0
    for half, causal in ((0, False), (1, True)):
        kh = k[:, half * ts:(half + 1) * ts].contiguous()
        vh = v[:, half * ts:(half + 1) * ts].contiguous()
        dq, dk, dv = fl.flash_bwd(q2, kh, vh, o_g, lse_g, do2, causal)
        torch.cuda.synchronize()
        g = [x.float() for x in (q2, kh, vh, do2)]
        rdq, rdelta = fl.plain_dq(*g[:3], o_g.float(), lse_g, g[3], causal)
        rdk, rdv = fl.plain_dkv(*g[:3], g[3], lse_g, rdelta, causal)
        bound = fl.kernel_error_bounds(*g[:3], o_g, lse_g, g[3], causal)
        tag = f"(d) hop {half}"
        errs[half] = max(k1_check(torch, tag, "dq", dq, rdq, bound["dq"]),
                         k1_check(torch, tag, "dk", dk, rdk, bound["dk"]),
                         k1_check(torch, tag, "dv", dv, rdv, bound["dv"]))
        dq_sum = dq_sum + dq.float()
        dq_bound = dq_bound + bound["dq"] + 2.0 ** -8 * rdq.abs()
    # the hops' shares add up to the whole sequence's gradient (the
    # plain backward over all 2048 tokens, second-half rows)
    full_dq, _ = fl.plain_dq(*f[:3], ro.to(torch.bfloat16).float(), rlse,
                             f[3], True)
    err = (dq_sum - full_dq[:, ts:]).abs()
    log(f"kernel-K1 (d) hop0 + hop1 dq vs the whole sequence's dq: "
        f"max_abs_err {float(err.max()):.3e}; max err / tolerance "
        f"{float((err / dq_bound).max()):.3f}")
    check(bool((err <= dq_bound).all()), "K1 hop: dq shares do not add up")
    return max(errs.values())


def phase_kernel_k1(torch, fl):
    """K1 against its plain versions at shapes (a)-(d); returns case
    (a)'s {kernel: max_abs_err} (the training shape)."""
    errs = {tag: k1_case(torch, fl, tag, *shape)
            for tag, shape in K1_SHAPES.items()}
    torch.cuda.empty_cache()
    k1_hop(torch, fl)
    torch.cuda.empty_cache()
    return errs["a"]


def phase_kernel_r1(torch, st):
    """R1 bitwise against its plain version (torch.neg) on the same
    inputs — the suite's shape, ragged rows, the plan's edge lengths,
    every bf16 bit pattern and the specials — and a second launch
    bitwise equal to the first; returns the max |kernel - plain| over the
    finite values (0 when the bits agree)."""
    g = torch.Generator(device=DEVICE).manual_seed(9)
    specials = torch.tensor(R1_SPECIALS, dtype=torch.int32).to(torch.int16)
    cases = {
        f"suite {list(R1_SHAPE)}": torch.randn(R1_SHAPE, generator=g,
                                               device=DEVICE),
        "ragged rows [1000, 1024]": torch.randn(1000, 1024, generator=g,
                                                device=DEVICE),
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, n in st.r1_edge_lengths(sms).items():
        cases[f"{name} ({n})"] = torch.randn(n, generator=g, device=DEVICE)
    cases = {k: v.to(torch.bfloat16) for k, v in cases.items()}
    # the specials repeated to 8 * 37 + 5 elements: vectors and the tail
    cases["specials x301"] = specials.repeat(22)[:301].view(
        torch.bfloat16).to(DEVICE)
    cases["every bf16 bit pattern (65536)"] = torch.arange(
        65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).to(
            DEVICE)
    err = 0.0
    for name, x in cases.items():
        got = st.stream_neg(x)
        ref = st.plain_neg(x)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int16), ref.view(torch.int16))
        finite = torch.isfinite(ref)
        e = float((got.float() - ref.float())[finite].abs().max())
        err = max(err, e)
        log(f"kernel-R1 {name}: bitwise equal to torch.neg: {same}; "
            f"max_abs_err {e:.3e}")
        check(same, f"R1 {name}: bits differ from torch.neg")
    x = cases[f"suite {list(R1_SHAPE)}"]
    first, second = st.stream_neg(x), st.stream_neg(x)
    torch.cuda.synchronize()
    check(torch.equal(first.view(torch.int16), second.view(torch.int16)),
          "R1: a second launch differs from the first")
    log(f"kernel-R1 second launch bitwise equal to the first; plan "
        f"{st.r1_plan(x.numel(), sms)}")

    def bits(t):
        return [hex(v & 0xFFFF) for v in t.view(torch.int16).tolist()]

    nan = cases["specials x301"][4:9].clone()    # 16-byte aligned
    log(f"kernel-R1 NaNs {bits(nan)}: kernel {bits(st.stream_neg(nan))}, "
        f"torch.neg {bits(torch.neg(nan))}")
    return err


def phase_resnet(torch):
    """bench.py's ResNet-50 S-SGD run through `measure_rate` under a
    one-rank NCCL group; returns its meta with images/s."""
    import torch.distributed as dist

    from kungfu_tpu_torch.benchmarks.throughput import measure_rate

    rate, meta = measure_rate("resnet50", 1)
    losses = meta["losses"]
    check(meta["backend"] == "nccl" and meta["chips"] == 1
          and meta["per_chip_batch"] == 128 and meta["image_size"] == 224,
          f"resnet: not bench.py's configuration: {meta}")
    check(all(x == x and abs(x) < 1e9 for x in losses),
          f"resnet: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"resnet: the loss did not fall "
          f"({losses[0]} -> {losses[-1]})")
    check(meta["bn_stats_finite"] and meta["bn_stats_max_change"] > 0,
          "resnet: BatchNorm running statistics non-finite or unmoved")
    check(meta["grad_all_reduces_per_step"] == RESNET_LEAVES,
          f"resnet: sync_sgd issued {meta['grad_all_reduces_per_step']} "
          f"all-reduces a step, expected {RESNET_LEAVES}")
    check(not dist.is_initialized(), "resnet: the process group outlived "
          "the run")
    meta["images_per_sec"] = rate
    log(f"resnet ResNet-50 S-SGD (NCCL, one rank): {rate:.1f} images/s, "
        f"{meta['step_time_ms']:.2f} ms/step, peak memory "
        f"{meta['peak_mem_gb']:.2f} GB, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {len(losses)} steps, BN stats moved "
        f"{meta['bn_stats_max_change']:.3e}")
    log("resnet " + json.dumps(meta))
    return meta


def phase_roofline(torch, st):
    """The port's roofline main path: R1's launches zeroed just before,
    read just after."""
    from kungfu_tpu_torch.benchmarks.roofline import roofline_report

    torch.cuda.synchronize()
    st.reset_launches()
    rep = roofline_report()
    torch.cuda.synchronize()
    launches = dict(st.LAUNCHES)
    check(launches["neg"] > 0 and launches["neg"] ==
          rep["stream_kernel_launches"] and launches["plain"] == 0,
          f"roofline: R1 launches {launches}")
    for name, gbs in rep["achieved_by_pattern_gb_per_s"].items():
        log(f"roofline {name:13s} {gbs:9.1f} GB/s = "
            f"{gbs / (PEAK_BYTES_S / 1e9):.3f} of {PEAK_BYTES_S / 1e12:.2f} "
            f"TB/s")
    log(f"roofline ResNet-50 step {rep['resnet50_step_ms']:.2f} ms; R1 "
        f"launches {launches['neg']}")
    log("roofline " + json.dumps(rep))
    return launches["neg"]


def phase_timing_r1(torch, st):
    """R1 per launch at the suite's shape (0.5 GiB in, 0.5 GiB out: far
    beyond L2), beside its byte bound and torch.neg — the plain version
    and the library call are the same call here — each over 50 launches
    by device time (`time_device`: ``ms``, ``plain_ms``) and by events
    (`time_cuda`: ``event_ms``, ``plain_event_ms``); ``ratio`` is R1 over
    torch.neg by device time."""
    x = torch.randn(R1_SHAPE, device=DEVICE).to(torch.bfloat16)
    nbytes = 2 * x.numel() * x.element_size()
    r = {"bound_ms": 1e3 * nbytes / PEAK_BYTES_S}
    r["event_ms"] = time_cuda(torch, lambda i: st.stream_neg(x), 50)
    r["plain_event_ms"] = time_cuda(torch, lambda i: st.plain_neg(x), 50)
    r["ms"] = time_device(torch, lambda i: st.stream_neg(x), 50)
    r["plain_ms"] = time_device(torch, lambda i: st.plain_neg(x), 50)
    r["ratio"] = r["ms"] / r["plain_ms"]
    log(f"timing R1 neg {r['ms']:.4f} ms/launch by device time "
        f"({r['event_ms']:.4f} by events); bound {r['bound_ms']:.4f} ms "
        f"(bytes: {nbytes} B); plain = library = torch.neg "
        f"{r['plain_ms']:.4f} ms ({r['plain_event_ms']:.4f}); R1 / "
        f"torch.neg {r['ratio']:.4f}; {1e-6 * nbytes / r['ms']:.1f} GB/s "
        f"achieved, torch.neg {1e-6 * nbytes / r['plain_ms']:.1f} GB/s")
    return r


def phase_train(torch, fc, fl, variant, attention="local"):
    """GPT-2-small training through the normal entry point; returns the
    benchmark's meta with the K2 and K1 launch counts of this run (K1's
    without the launches of the flash efficiency probe that
    `measure_lm_rate` runs after the training loop)."""
    from kungfu_tpu_torch.benchmarks.lm import measure_lm_rate

    tag = f"{variant}/{attention}"
    torch.cuda.synchronize()
    fc.reset_launches()                     # counts of THIS run only
    fl.reset_launches()
    rate, meta = measure_lm_rate("small", 8, 1024, attention=attention,
                                 ce_variant=variant, iters=TRAIN_ITERS,
                                 warmup=TRAIN_WARMUP)
    torch.cuda.synchronize()
    launches = dict(fc.LAUNCHES)
    probe = meta.get("flash_kernel", {}).get("launches", {})
    k1 = {n: c - probe.get(n, 0) for n, c in fl.LAUNCHES.items()}
    steps = TRAIN_WARMUP + TRAIN_ITERS
    losses = meta["losses"]
    check(len(losses) == steps and all(x == x and abs(x) < 1e9
                                       for x in losses),
          f"train {tag}: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"train {tag}: the loss did not "
          f"fall ({losses[0]} -> {losses[-1]})")
    want = ({"fwd": steps, "residual_d": steps, "dw": 0, "dx": 0}
            if variant == "residual" else
            {"fwd": steps, "residual_d": 0, "dw": steps, "dx": steps})
    got = {k: launches[k] for k in want}
    check(got == want and launches["plain"] == 0,
          f"train {tag}: K2 launches {launches}, expected {want} and "
          f"no plain call")
    n = LAYERS * steps if attention == "flash" else 0
    want1 = {"fwd": n, "dq": n, "dkv": n, "plain": 0}
    check(k1 == want1 and fl.LAUNCHES["plain"] == 0,
          f"train {tag}: K1 launches {k1} (probe {probe}), expected {want1}")
    meta.update(tokens_per_sec=rate, launches=launches, k1_launches=k1)
    log(f"train {tag}: {meta['step_time_ms']:.2f} ms/step, "
        f"{rate:.1f} tok/s, MFU {meta['mfu']} (against 989e12 bf16), "
        f"peak memory {meta['peak_mem_gb']:.2f} GB, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; K2 launches {launches}; "
        f"K1 launches {k1}")
    log("train " + json.dumps(meta))
    return meta


#: the elastic phase: (a) grow 1 -> 2, shrink to 1 with an eviction;
#: (b) two workers, rank 1 killed after step 3, the survivor recovers
ELASTIC_GROW = ("3:1,3:2,3:1", 9)
ELASTIC_RECOVERY = (1, 3, 8, 2)     # crash rank, crash step, steps, np
ELASTIC_KERNELS = {"flash": ("fwd", "dq", "dkv"),
                   "fused_ce": ("fwd", "residual_d")}


def _kv(line: str) -> dict:
    """The ``key=value`` fields of a worker's marker line."""
    out = {}
    for tok in line.split():
        k, sep, v = tok.partition("=")
        if sep:
            out[k] = v
    return out


def _marker_lines(logs: str, marker: str):
    return [_kv(l) for l in logs.splitlines() if l.startswith(marker + " ")]


def elastic_report(tag: str, logs: str, card: str, device: str) -> dict:
    """Check one elastic run's worker logs and print its numbers: each
    worker's K1/K2 launches (kernels positive and plain versions never on
    the card; plain only on the CPU), every digest agreed, and per
    cluster size the median step wall, compute, wire (the libkf gradient
    all-reduce) and staging ms of rank 0, the resyncs' ms and bytes, the
    KF_MTTR phases and each worker's peak memory."""
    launches = [l for l in logs.splitlines() if l.startswith("KF_LAUNCHES")]
    check(launches, f"elastic {tag}: no worker printed its launches")
    totals = {f"{m}.{k}": 0 for m, ks in ELASTIC_KERNELS.items()
              for k in ks}
    for line in launches:
        kv = {}
        for tok in line.split()[3:]:
            name, _, js = tok.partition("=")
            kv[name] = json.loads(js)
        for mod, names in ELASTIC_KERNELS.items():
            counts = kv[mod]
            if device == "cuda":
                check(all(counts[n] > 0 for n in names)
                      and counts["plain"] == 0,
                      f"elastic {tag}: {mod} launches {counts} in {line}")
            else:
                check(counts["plain"] > 0, f"elastic {tag}: {line}")
            for n in names:
                totals[f"{mod}.{n}"] += counts[n]
    digests = _marker_lines(logs, "KF_DIGEST")
    check(digests and all(d["agreed"] == "True" for d in digests),
          f"elastic {tag}: digests {digests}")
    steps = [d for d in _marker_lines(logs, "KF_STEP") if d["rank"] == "0"]
    by_size = {}
    for d in steps:
        by_size.setdefault(int(d["size"]), []).append(d)
    for size, rows in sorted(by_size.items()):
        med = {k: sorted(float(r[k]) for r in rows)[len(rows) // 2]
               for k in ("wall_ms", "compute_ms", "wire_ms", "stage_ms")}
        log(f"elastic {tag} size {size}: rank-0 step median wall "
            f"{med['wall_ms']:.2f} ms, compute {med['compute_ms']:.2f}, "
            f"libkf all-reduce (wire) {med['wire_ms']:.2f}, staging "
            f"{med['stage_ms']:.2f} over steps "
            f"{[int(r['step']) for r in rows]}; walls "
            f"{[float(r['wall_ms']) for r in rows]} ({card})")
    for d in _marker_lines(logs, "KF_RESYNC"):
        log(f"elastic {tag} resync: rank {d['rank']} size {d['size']} step "
            f"{d['step']} {float(d['ms']):.1f} ms, {int(d['bytes'])} bytes "
            f"({card})")
    for line in logs.splitlines():
        if line.startswith("KF_MTTR"):
            log(f"elastic {tag} {line} ({card})")
        elif line.startswith(("KF_JOINER_CONTINUITY", "KF_SURVIVOR_CONTI",
                              "KF_DIGEST", "evicted at step", "resized:",
                              "KF_RECOVERY_")):
            log(f"elastic {tag} {line}")
    for d in _marker_lines(logs, "KF_PEAK_MEM"):
        log(f"elastic {tag} peak memory of worker {d['peer']} (rank "
            f"{d['rank']} at exit): {d['gb']} GB ({card})")
    log(f"elastic {tag}: {len(digests)} digests agreed; launches "
        f"{json.dumps(totals)}")
    return totals


def phase_elastic(torch, card: str, device: str = DEVICE) -> dict:
    """The elastic training worker path through the port's harness:
    config server, ``kfrun -w``, GPT-2-small continuity workers sharing
    the card. (a) grow 1 -> 2 and shrink to 1 with an eviction; (b) two
    workers, one killed, the survivor recovers. Returns the workers'
    K1/K2 launches summed over both runs."""
    from kungfu_tpu_torch.elastic.harness import (claim_port_span,
                                                  run_loss_continuity,
                                                  run_survivor_recovery)

    flags = ["--model", "gpt", "--device", device]
    schedule, steps = ELASTIC_GROW
    t0 = time.perf_counter()
    with claim_port_span() as span:
        logs = run_loss_continuity(schedule=schedule, total_steps=steps,
                                   start_np=1, slots=2, port_range=span,
                                   timeout=420, worker_flags=flags)
    check("evicted at step" in logs, "elastic grow: no eviction")
    check(f"KF_CONTINUITY_DONE rank=0 size=1 step={steps}" in logs,
          "elastic grow: the survivor did not finish at size 1")
    check(len(_marker_lines(logs, "KF_DIGEST")) >= 3,
          "elastic grow: a resync without its digest check")
    log(f"elastic grow 1 -> 2 -> 1 ({schedule}, {steps} steps): "
        f"{time.perf_counter() - t0:.1f} s")
    totals = elastic_report("grow", logs, card, device)
    crash_rank, crash_step, steps, start_np = ELASTIC_RECOVERY
    t0 = time.perf_counter()
    with claim_port_span() as span:
        logs = run_survivor_recovery(crash_rank=crash_rank,
                                     crash_step=crash_step,
                                     total_steps=steps, start_np=start_np,
                                     slots=start_np, port_range=span,
                                     timeout=420, worker_flags=flags)
    check("KF_CONTINUITY_DONE rank=0" in logs,
          "elastic recovery: the survivor did not finish")
    log(f"elastic recovery (rank {crash_rank} killed after step "
        f"{crash_step}, {steps} steps, np {start_np}): "
        f"{time.perf_counter() - t0:.1f} s")
    for k, v in elastic_report("recovery", logs, card, device).items():
        totals[k] += v
    return totals


def k2_bound(kernel, n_pad, h, v_pad):
    """(bound_ms, bound_by, flops, bytes) of one K2 launch on these
    padded operands: each input read once, each output written once;
    flops are the logits products (2 n h v) plus dw's or dx's own
    product, against the bf16 tensor-core peak; residual_d's
    elementwise work (~6 f32 operations an element) against the f32
    peak."""
    nv = n_pad * v_pad
    row = 4 * n_pad                                  # one f32/int32 a row
    xw = 2 * n_pad * h + 2 * h * v_pad + 4 * v_pad + row   # x, W, b, t
    if kernel == "fwd":
        nbytes, flops, peak = xw + 2 * row + 2 * nv, 2 * n_pad * h * v_pad, \
            PEAK_BF16_FLOPS
    elif kernel == "residual_d":
        nbytes, flops, peak = 2 * 2 * nv + 2 * row + 4 * v_pad + 4, 6 * nv, \
            PEAK_F32_FLOPS
    elif kernel == "dw":
        nbytes, flops, peak = xw + row + 4 + 2 * h * v_pad + 4 * v_pad, \
            4 * n_pad * h * v_pad, PEAK_BF16_FLOPS
    else:
        nbytes, flops, peak = xw + row + 4 + 2 * n_pad * h, \
            4 * n_pad * h * v_pad, PEAK_BF16_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes)


def phase_timing_k2(torch, fc):
    """Each K2 kernel per launch at the training shape beside its bound,
    its plain version and the cuBLAS products the same work contains
    (timed only; the port never calls them in place of a kernel)."""
    x, w, b, t, scale = k2_inputs(torch, fc)
    n_pad, v_pad = x.shape[0], w.shape[1]
    _, lse, _ = fc.plain_fwd(x, w, b, t, False)
    logits, _, _ = fc.fused_ce_fwd(x, w, b, t, True)
    out = {}
    runs = {
        "fwd": (lambda i: fc.fused_ce_fwd(x, w, b, t, True),
                lambda i: fc.plain_fwd(x, w, b, t, True),
                [lambda i: x @ w]),
        # in place over the same buffer each launch: the bytes and the
        # work are the same whatever the values
        "residual_d": (lambda i: fc.fused_ce_residual_d(scale, logits, lse,
                                                        t),
                       lambda i: fc.plain_residual_d(scale, logits, lse, t),
                       None),
        "dw": (lambda i: fc.fused_ce_dw(scale, x, w, b, t, lse),
               lambda i: fc.plain_dw(scale, x, w, b, t, lse),
               [lambda i: x @ w, lambda i: x.t() @ logits]),
        "dx": (lambda i: fc.fused_ce_dx(scale, x, w, b, t, lse),
               lambda i: fc.plain_dx(scale, x, w, b, t, lse),
               [lambda i: x @ w, lambda i: logits @ w.t()]),
    }
    fwd_nores = time_cuda(torch, lambda i: fc.fused_ce_fwd(x, w, b, t,
                                                           False), 5)
    for name, (kern, plain, lib) in runs.items():
        ms = time_cuda(torch, kern, 5)
        plain_ms = time_cuda(torch, plain, 2)
        lib_ms = (sum(time_cuda(torch, f, 5) for f in lib)
                  if lib is not None else None)
        bound_ms, bound_by, flops, nbytes = k2_bound(name, n_pad, K2_H,
                                                     v_pad)
        out[name] = (ms, plain_ms, lib_ms, bound_ms, bound_by)
        log(f"timing K2 {name:10s} {ms:.4f} ms/launch; bound "
            f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, {flops} flop); "
            f"plain {plain_ms:.4f} ms; library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
            f"{1e-12 * flops / (ms * 1e-3):.1f} TFLOP/s, "
            f"{1e-9 * nbytes / (ms * 1e-3):.1f} GB/s achieved")
    log(f"timing K2 fwd without the residual (recompute forward) "
        f"{fwd_nores:.4f} ms/launch")
    log("timing K2 library: fwd = x @ W (bf16 cuBLAS); dw = x @ W + x^T @ "
        "d; dx = x @ W + d @ W^T; residual_d has no single PyTorch call "
        "for softmax - onehot written over its input with column sums: "
        "null")
    del logits
    torch.cuda.empty_cache()
    return out


def k1_bound(kernel, b, t, h, d, causal, window):
    """(bound_ms, bound_by, flops, bytes) of one K1 launch: each input
    read once and each output written once (bf16 [B, T, h, d] tensors,
    f32 [B*h, T] lse and delta): fwd reads q, k, v and writes o and lse;
    dq reads q, k, v, o, dO and lse and writes dq and delta; dkv reads
    q, k, v, dO, lse and delta and writes dk and dv. Operations are the
    products on the visible pairs (`flash_attention_flops`' count, 2 d
    FLOPs a pair a product): fwd q.k^T and p.v; dq q.k^T, dO.v^T and
    ds.k; dkv those two score products, p^T.dO and ds^T.q — against the
    bf16 tensor-core peak."""
    from kungfu_tpu_torch.ops.flash import flash_attention_flops

    seq = 2 * b * t * h * d                     # one bf16 [B, T, h, d]
    row = 4 * b * h * t                         # one f32 [B*h, T]
    pair_product = flash_attention_flops(b, t, h, d, causal, window) // 2
    nbytes, flops = {
        "fwd": (4 * seq + row, 2 * pair_product),
        "dq": (6 * seq + 2 * row, 3 * pair_product),
        "dkv": (6 * seq + 2 * row, 4 * pair_product)}[kernel]
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes)


def phase_timing_k1(torch, fl):
    """Each K1 kernel per launch at shapes (a) and (b), cycling over four
    input sets (4 x 4 x 12.6 MB at (a): L2's 50 MB holds none of a
    launch's inputs from its previous visit), beside its bound, its plain
    version and the library yardstick scaled_dot_product_attention: its
    forward, and its backward alone (the graph is built outside the
    profiled window and kept with retain_graph), which computes dq, dk
    and dv together and so stands beside dq + dkv. Every time is device
    time per call (`time_device`). SDPA's backend is named as its
    dispatch picks it (and as the backward's autograd node names it),
    with every backend's time when forced. SDPA is timed only; the port
    never calls it. Uses only the wrappers and plain versions of
    `ops.flash`, so `benchmarks/kernel_ab.py` can time an older
    checkout's K1 with it. Returns {shape: {kernel: (ms, plain_ms,
    bound_ms, bound_by), "sdpa": {"fwd": ms, "bwd": ms, "bwd_node":
    str, "fwd_backend": {...}, "bwd_backend": {...}}}}."""
    import torch.nn.functional as F

    out = {}
    for tag in ("a", "b"):
        b, t, h, d, causal, window = K1_SHAPES[tag]
        sets = []
        for seed in range(4):
            q, k, v, do = k1_inputs(torch, b, t, h, d, 10 + seed)
            o, lse = fl.flash_fwd(q, k, v, causal, None, window)
            _, delta = fl.flash_dq(q, k, v, o, lse, do, causal, None, window)
            sets.append((q, k, v, do, o, lse, delta))
        runs = {
            "fwd": (lambda x: fl.flash_fwd(x[0], x[1], x[2], causal, None,
                                           window),
                    lambda x: fl.plain_fwd(x[0], x[1], x[2], causal, None,
                                           window)),
            "dq": (lambda x: fl.flash_dq(x[0], x[1], x[2], x[4], x[5], x[3],
                                         causal, None, window),
                   lambda x: fl.plain_dq(x[0], x[1], x[2], x[4], x[5], x[3],
                                         causal, None, window)),
            "dkv": (lambda x: fl.flash_dkv(x[0], x[1], x[2], x[3], x[5],
                                           x[6], causal, None, window),
                    lambda x: fl.plain_dkv(x[0], x[1], x[2], x[3], x[5],
                                           x[6], causal, None, window)),
        }
        res = {}
        for name, (kern, plain) in runs.items():
            ms = time_device(torch, lambda i: kern(sets[i % 4]), 40)
            plain_ms = time_device(torch, lambda i: plain(sets[0]), 2)
            bound_ms, bound_by, flops, nbytes = k1_bound(name, b, t, h, d,
                                                         causal, window)
            res[name] = (ms, plain_ms, bound_ms, bound_by)
            log(f"timing K1 ({tag}) {name:4s} {ms:.4f} ms/launch on the "
                f"device; bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, "
                f"{flops} flop); plain {plain_ms:.4f} ms; "
                f"{1e-12 * flops / (ms * 1e-3):.1f} TFLOP/s, "
                f"{1e-9 * nbytes / (ms * 1e-3):.1f} GB/s achieved")
        # SDPA on contiguous [B, h, T, d] copies of the same values (its
        # own layout); the window as a boolean band mask (is_causal
        # cannot express it)
        mask = None
        if window is not None:
            pos = torch.arange(t, device=DEVICE)
            mask = (pos[:, None] >= pos[None, :]) & \
                (pos[:, None] - pos[None, :] <= window)
        lib = [[x.transpose(1, 2).contiguous().requires_grad_()
                for x in st[:4]] for st in sets]
        is_causal = causal and mask is None

        def sdpa(x):
            return F.scaled_dot_product_attention(
                x[0], x[1], x[2], attn_mask=mask, is_causal=is_causal)

        def sdpa_fwd(i):
            with torch.no_grad():
                return sdpa(lib[i % 4])

        def sdpa_bwd():
            """The backward alone: the four graphs are built here, under
            whatever backend the caller forces, outside the window."""
            outs = [sdpa(x) for x in lib]

            def bwd(i):
                x = lib[i % 4]
                return torch.autograd.grad(outs[i % 4], x[:3], x[3],
                                           retain_graph=True)
            bwd.node = outs[0].grad_fn.name()
            return bwd

        sdpa_fwd.inputs = tuple(x.detach() for x in lib[0][:3]) + (
            mask, is_causal)
        lib_fwd = time_device(torch, sdpa_fwd, 40)
        bwd = sdpa_bwd()
        lib_bwd, node = time_device(torch, bwd, 40), bwd.node
        del bwd
        res["sdpa"] = {"fwd": lib_fwd, "bwd": lib_bwd, "bwd_node": node}
        for key, fn, make, inputs in (
                ("fwd_backend", sdpa_fwd, None, None),
                ("bwd_backend", None, sdpa_bwd,
                 tuple(lib[0][:3]) + (mask, is_causal))):
            picked, forced = sdpa_backends(torch, fn, make, inputs)
            res["sdpa"][key] = {"picked": picked, "forced": forced}
        pair = res["dq"][0] + res["dkv"][0]
        log(f"timing K1 ({tag}) library sdpa forward {lib_fwd:.4f} ms, "
            f"backward alone {lib_bwd:.4f} ms ({res['sdpa']['bwd_node']}) "
            f"against dq + dkv {pair:.4f} ms ({pair / lib_bwd:.2f}x); mask "
            f"{'band' if mask is not None else 'is_causal'}; backends "
            f"{json.dumps({k: v for k, v in res['sdpa'].items() if 'backend' in k})}")
        out[tag] = res
        del sets, lib
        torch.cuda.empty_cache()
    return out


def serve_requests(vocab, seed=7):
    """12 requests: prompts of 32..512 tokens, 4 of them sharing a
    64-token prefix, 64 new tokens each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(0, vocab, 64)]
    reqs = []
    for i in range(12):
        n = int(rng.integers(32, 513))
        body = [int(t) for t in rng.integers(0, vocab, n)]
        if i % 3 == 0:                      # requests 0, 3, 6, 9
            body = prefix + body[:max(n - 64, 1)]
        reqs.append((i, body, 64))
    return reqs


def serve(engine, reqs, max_iters=20000):
    """Admit as slots and blocks allow, step until every request is
    done; a preempted request is re-admitted with prompt + generated.
    Returns {request: tokens}."""
    queue = deque(reqs)
    prompts = {r: p for r, p, _ in reqs}
    budget = {r: m for r, _, m in reqs}
    out = {r: [] for r, _, _ in reqs}
    done = set()
    for _ in range(max_iters):
        while queue and engine.can_admit(len(queue[0][1])):
            r, p, m = queue.popleft()
            tok, fin = engine.admit(r, p, m)
            if tok is not None:
                out[r].append(tok)
            if fin:
                done.add(r)
        emitted, preempted = engine.step()
        for r, (tok, fin) in emitted.items():
            out[r].append(tok)
            if fin:
                done.add(r)
        for r in preempted:
            queue.append((r, prompts[r] + out[r], budget[r] - len(out[r])))
        if not queue and not engine.live():
            break
    check(done == set(out), f"requests not finished: "
          f"{sorted(set(out) - done)}")
    return out


def phase_serve(torch, pa, model, kernel):
    from kungfu_tpu_torch.serve import DecodeEngine

    eng = DecodeEngine(model, max_batch=BATCH, block_tokens=BT,
                       max_len=MAX_LEN, kernel=kernel, share_prefix=True,
                       prefill_chunk=256)
    eng.warm()
    reqs = serve_requests(model.config.vocab_size)
    torch.cuda.synchronize()
    pa.reset_launches()                     # counts of THIS run only
    t0 = time.perf_counter()
    out = serve(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.LAUNCHES)
    scheme = eng.kernel
    check(scheme in ("resident", "stream"), f"engine resolved {scheme!r}")
    check(all(len(t) == 64 for t in out.values()), "a request came back "
          "with other than 64 tokens")
    check(all(0 <= x < model.config.vocab_size for t in out.values()
              for x in t), "token outside the vocabulary")
    check(launches[scheme] == model.config.num_layers * eng.decode_iters
          and eng.decode_iters > 0,
          f"{scheme} launched {launches[scheme]} times over "
          f"{eng.decode_iters} decode steps")
    check(launches["plain"] == 0, f"plain version ran {launches['plain']} "
          f"times on the card")
    other = "stream" if scheme == "resident" else "resident"
    check(launches[other] == 0, f"{other} launched in a {scheme} run")
    stats = {
        "kernel": kernel, "scheme": scheme, "launches": launches[scheme],
        "decode_steps": eng.decode_iters, "decode_tokens": eng.decode_tokens,
        "decode_ms_per_step": 1e3 * eng.decode_s / eng.decode_iters,
        "decode_tok_s": eng.decode_tokens / eng.decode_s,
        "prefill_s": eng.prefill_s, "prefill_chunks": eng.prefill_chunks,
        "wall_s": wall, "requests": len(out),
    }
    check(eng.pool.check_invariants() == [], "allocator invariants")
    check(eng.pool.blocks_in_use == 0, "blocks leaked after the run")
    log("serve " + json.dumps(stats))
    return out, stats


def phase_parity(torch):
    """f32, 2 layers at GPT-2-small width: kernel paths == functional
    oracle == dense-cache gpt_generate, token for token."""
    import numpy as np

    from kungfu_tpu_torch.models import gpt_generate
    from kungfu_tpu_torch.serve import DecodeEngine, build_lm
    from kungfu_tpu_torch.serve import paged

    model = build_lm("small", max_position=MAX_LEN, dtype=torch.float32,
                     num_layers=2, seed=3)
    rng = np.random.default_rng(11)
    vocab = model.config.vocab_size
    reqs = [(i, [int(t) for t in rng.integers(0, vocab, n)], 32)
            for i, n in enumerate((17, 40, 200, 300))]
    runs = {}
    for kernel in ("functional", "auto", "stream"):
        eng = DecodeEngine(model, max_batch=BATCH, block_tokens=BT,
                           max_len=MAX_LEN, kernel=kernel,
                           share_prefix=True, prefill_chunk=256)
        runs[kernel] = serve(eng, reqs)
    dense = {r: gpt_generate(model, torch.tensor([p], device=DEVICE),
                             m)[0, len(p):].tolist() for r, p, m in reqs}
    for kernel in ("auto", "stream"):
        check(runs[kernel] == runs["functional"],
              f"f32 tokens: kernel={kernel} differs from functional")
    check(runs["functional"] == dense,
          "f32 tokens: engine differs from gpt_generate")
    # one decode step's logits, kernel vs functional, on the same state
    eng = DecodeEngine(model, max_batch=BATCH, block_tokens=BT,
                       max_len=MAX_LEN, kernel="auto")
    for r, p, _ in reqs:
        eng.admit(r, p, 8)
    order = eng.live()
    pad = BATCH - len(order)
    tables = torch.as_tensor(eng.pool.batch_tables(order, eng.max_blocks,
                                                   pad_rows=pad),
                             device=DEVICE)
    lengths = torch.as_tensor(eng.pool.batch_lengths(order, pad_rows=pad),
                              device=DEVICE)
    tokens = torch.zeros(BATCH, dtype=torch.int32, device=DEVICE)
    logit = {}
    for kernel in ("functional", "resident", "stream"):
        pk, pv = eng.pool_k.clone(), eng.pool_v.clone()
        logit[kernel] = paged.decode_step(model, pk, pv, tables, lengths,
                                          tokens, kernel=kernel)
    for kernel in ("resident", "stream"):
        err = float((logit[kernel] - logit["functional"]).abs().max())
        log(f"parity f32 decode_step logits {kernel} vs functional "
            f"max_abs_err {err:.3e}")
        check(err < 1e-3, f"f32 logits {kernel}: {err}")
    log(f"parity f32 tokens equal: auto ({eng.kernel}), stream, "
        f"functional, gpt_generate; {len(reqs)} requests x 32 tokens")


def time_cuda(torch, fn, iters):
    for _ in range(3):
        fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_device(torch, fn, iters):
    """Device time per call of `fn`: the union of the intervals of the
    kernels its `iters` calls launch (CUPTI through torch.profiler),
    over `iters`. Unlike `time_cuda` it leaves out the card's idle gaps
    while the host prepares the next call, which dominate a kernel of a
    few microseconds launched from Python."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(0)
    torch.cuda.synchronize()
    # on the H100 a session has come back without device events where the
    # same calls, in the same order of phases, recorded them: such a
    # session runs again, at most three times in all
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    check(spans, "the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / iters / 1e3


def sdpa_backends(torch, fn, make=None, inputs=None):
    """The backend SDPA's dispatch picks for `inputs` (default
    `fn.inputs`: q, k, v, mask and, optionally, is_causal) and each
    backend's ms per call when forced (None where it refuses them):
    ``(picked, {backend: ms})``. With `make`, the function timed under
    each forced backend is ``make()``, called inside the forcing (a
    backward's graphs are built there, so the forced backend is the one
    the graph records)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, mask, *rest = fn.inputs if inputs is None else inputs
    names = {int(b.value): n for n, b in SDPBackend.__members__.items()}
    try:
        picked = names.get(int(torch._fused_sdp_choice(
            q, k, v, mask, 0.0, bool(rest and rest[0]))), "unknown")
    except (AttributeError, RuntimeError, TypeError):
        picked = "unknown"
    forced = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                forced[name] = time_device(
                    torch, make() if make is not None else fn, 4 * LAYERS)
        except RuntimeError:
            forced[name] = None
    return picked, forced


#: K3's timing shapes (8 rows each): full 1023-token rows (decode at
#: max_len) and the serve phase's mixed lengths (prompts of 32..512
#: tokens plus up to 64 new ones: 32..576)
K3_SHAPES = {"full": [MAX_LEN - 1] * BATCH,
             "mixed": [32, 109, 187, 265, 343, 420, 498, 576]}


def phase_timing(torch, pa):
    """K3 per launch at each of `K3_SHAPES`, cycling over the 12
    layers' pools (~300 MB, so L2 holds none of a launch's K/V from the
    previous visit), beside the byte bound of the blocks this run's
    lengths make visible, the plain version and the library yardstick:
    scaled_dot_product_attention on K/V gathered beforehand (up to the
    longest row), with the boolean mask and, at full rows, where the
    mask is all true, without it; each with the backend SDPA's dispatch
    picks and every backend's time when forced. Every time is device
    time per call (`time_device`); the kernels' back-to-back times with
    the host's gaps (`time_cuda`) are kept as "<scheme>_wall". Uses only
    `paged_attention`, `paged_attention_reference` and
    `paged_traffic_bytes`, so `benchmarks/kernel_ab.py` can time an
    older checkout's K3 with it. Returns {shape: {"resident": ms,
    "stream": ms, "resident_wall": ms, "stream_wall": ms, "plain": ms,
    "sdpa_mask": ms, "sdpa_nomask": ms or None, "sdpa_backend": {...},
    "bound_ms": ms, "bound_by": str}}."""
    import torch.nn.functional as F

    dtype = torch.bfloat16
    kp, vp, nbp1 = pools(torch, dtype)
    g = torch.Generator(device=DEVICE).manual_seed(4)
    q = torch.randn(BATCH, HEADS, HEAD_DIM, generator=g,
                    device=DEVICE).to(dtype)
    isz = q.element_size()
    out = {}
    for shape, lengths in K3_SHAPES.items():
        tables, lens = tables_for(torch, lengths)
        nbytes = (pa.paged_traffic_bytes(lengths, BT, HEADS, HEAD_DIM, isz)
                  + 2 * q.numel() * isz + tables.numel() * 4
                  + lens.numel() * 4)
        flops = 4 * sum(n + 1 for n in lengths) * HEADS * HEAD_DIM
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
        res = {"bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        for scheme in ("resident", "stream"):
            def k3(i, s=scheme):
                return pa.paged_attention(
                    q, kp, vp, tables, lens, block_base=(i % LAYERS) * nbp1,
                    scheme=s)
            res[scheme] = time_device(torch, k3, 20 * LAYERS)
            res[f"{scheme}_wall"] = time_cuda(torch, k3, 20 * LAYERS)
        res["plain"] = time_device(
            torch, lambda i: pa.paged_attention_reference(
                q, kp, vp, tables, lens, block_base=(i % LAYERS) * nbp1),
            2 * LAYERS)
        # the library yardstick: SDPA over K/V gathered beforehand
        nblk = max(lengths) // BT + 1
        t = nblk * BT
        idx = tables.long()[:, :nblk]
        kk = [kp[idx + l * nbp1].reshape(BATCH, t, HEADS, HEAD_DIM)
              .transpose(1, 2).contiguous() for l in range(LAYERS)]
        vv = [vp[idx + l * nbp1].reshape(BATCH, t, HEADS, HEAD_DIM)
              .transpose(1, 2).contiguous() for l in range(LAYERS)]
        mask = (torch.arange(t, device=DEVICE)[None, :]
                <= lens.long()[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        variants = {"sdpa_mask": mask}
        if bool(mask.all()):
            variants["sdpa_nomask"] = None
        res["sdpa_nomask"] = None
        res["sdpa_backend"] = {}
        for name, m in variants.items():
            def sdpa(i, m=m):
                return F.scaled_dot_product_attention(
                    q4, kk[i % LAYERS], vv[i % LAYERS], attn_mask=m)
            sdpa.inputs = (q4, kk[0], vv[0], m)
            res[name] = time_device(torch, sdpa, 20 * LAYERS)
            picked, forced = sdpa_backends(torch, sdpa)
            res["sdpa_backend"][name] = {"picked": picked, "forced": forced}
        for scheme in ("resident", "stream"):
            log(f"timing K3 ({shape}) {scheme:8s} {res[scheme]:.4f} ms/launch"
                f" on the device ({res[scheme + '_wall']:.4f} back to back "
                f"from the host); bound {res['bound_ms']:.4f} ms "
                f"({res['bound_by']}: {nbytes} B, {flops} flop); plain "
                f"{res['plain']:.4f} ms; {1e-6 * nbytes / res[scheme]:.1f} "
                f"GB/s achieved")
        for name in variants:
            log(f"timing K3 ({shape}) library {name} {res[name]:.4f} ms on "
                f"{t} gathered positions; backends "
                f"{json.dumps(res['sdpa_backend'][name])}")
        out[shape] = res
        del kk, vv
    del kp, vp
    torch.cuda.empty_cache()
    return out


def build_all(_build, names):
    """One nvcc per library, all started together, beside libkf's g++
    build (one compiler per source, `native.library`); prints the
    time and the compiler's register, spill and warning lines."""
    from kungfu_tpu_torch.native import library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        libkf = pool.submit(library)
        texts = dict(zip(names, pool.map(_build.build, names)))
        libkf_path = libkf.result()
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(names)} and "
        f"libkf ({libkf_path.name}), in parallel)")
    for name, text in texts.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "error", "warning")):
                log(f"  {name}: {line.strip()}")
        _build.load(name)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kungfu_tpu_torch.ops import _build
    from kungfu_tpu_torch.ops import flash as fl
    from kungfu_tpu_torch.ops import fused_ce as fc
    from kungfu_tpu_torch.ops import paged_attn as pa
    from kungfu_tpu_torch.ops import stream as st
    from kungfu_tpu_torch.serve import build_lm

    card = card_line()
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions'
    torch.backends.cudnn.allow_tf32 = False         # f32 products exact
    build_all(_build, ["paged_attn", "fused_ce", "flash", "stream"])

    errs = phase_kernel(torch, pa)
    k2_errs = phase_kernel_k2(torch, fc)
    k1_errs = phase_kernel_k1(torch, fl)
    r1_err = phase_kernel_r1(torch, st)
    log(f"[{time.perf_counter() - T_START:.0f} s] kernel phases done")
    model = build_lm("small", max_position=MAX_LEN, seed=0)
    log(f"model: GPT-2-small {model.config}")
    served = {}
    for kernel in ("auto", "stream"):
        out, stats = phase_serve(torch, pa, model, kernel)
        served[stats["scheme"]] = (out, stats)
    agree = sum(a == b for r in served["resident"][0]
                for a, b in zip(served["resident"][0][r],
                                served["stream"][0][r]))
    total = sum(len(t) for t in served["resident"][0].values())
    log(f"serve bf16 resident vs stream token agreement {agree}/{total}")
    del model
    torch.cuda.empty_cache()
    phase_parity(torch)
    trained = {}
    for variant, attention in (("residual", "local"),
                               ("recompute", "local"),
                               ("residual", "flash")):
        trained[f"{variant}/{attention}"] = phase_train(
            torch, fc, fl, variant, attention)
        torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - T_START:.0f} s] train phases done")
    resnet = phase_resnet(torch)
    torch.cuda.empty_cache()
    r1_launches = phase_roofline(torch, st)
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - T_START:.0f} s] resnet and roofline done")
    elastic = phase_elastic(torch, card)
    log(f"[{time.perf_counter() - T_START:.0f} s] elastic done")
    local, flash = trained["residual/local"], trained["residual/flash"]
    log(f"train local vs flash (residual CE, this call): "
        f"{local['step_time_ms']:.2f} vs {flash['step_time_ms']:.2f} "
        f"ms/step, {local['tokens_per_sec']:.1f} vs "
        f"{flash['tokens_per_sec']:.1f} tok/s, MFU {local['mfu']} vs "
        f"{flash['mfu']}, peak memory {local['peak_mem_gb']:.2f} vs "
        f"{flash['peak_mem_gb']:.2f} GB; flash kernel efficiency "
        f"{json.dumps(flash['flash_kernel'])}")
    k3_times = phase_timing(torch, pa)
    k2_times = phase_timing_k2(torch, fc)
    k1_times = phase_timing_k1(torch, fl)
    r1_times = phase_timing_r1(torch, st)
    log(f"[{time.perf_counter() - T_START:.0f} s] timing done")

    kernels = []
    # full rows; library: SDPA without the mask (all true at full rows:
    # the same function), the masked call and the mixed shape in the log
    full = k3_times["full"]
    for scheme in ("resident", "stream"):
        kernels.append({
            "name": f"paged_attn.{scheme}", "route": "cuda",
            "source": "kungfu_tpu_torch/csrc/paged_attn.cu",
            "replaces": REPLACES[scheme],
            "launches": served[scheme][1]["launches"],
            "max_abs_err": errs[(scheme, "bfloat16")],
            "ms": full[scheme], "plain_ms": full["plain"],
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
            "library_ms": full["sdpa_nomask"],
        })
    for name in ("fwd", "residual_d", "dw", "dx"):
        ms, plain_ms, lib_ms, bound_ms, bound_by = k2_times[name]
        kernels.append({
            "name": f"fused_ce.{name}", "route": "cuda",
            "source": "kungfu_tpu_torch/csrc/fused_ce.cu",
            "replaces": K2_REPLACES[name],
            "launches": sum(m["launches"][name] for m in trained.values()),
            "elastic_launches": elastic.get(f"fused_ce.{name}", 0),
            "max_abs_err": k2_errs[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    sdpa = k1_times["a"]["sdpa"]
    for name in ("fwd", "dq", "dkv"):
        # shape (a), the training shape. library_ms: SDPA's forward for
        # fwd; for dq and dkv SDPA's backward, the one PyTorch call that
        # computes their function: it returns dq, dk and dv together, so
        # its time stands on both rows as the time of the pair
        ms, plain_ms, bound_ms, bound_by = k1_times["a"][name]
        row = {
            "name": f"flash.{name}", "route": "cuda",
            "source": "kungfu_tpu_torch/csrc/flash.cu",
            "replaces": K1_REPLACES[name],
            "launches": trained["residual/flash"]["k1_launches"][name],
            "elastic_launches": elastic[f"flash.{name}"],
            "max_abs_err": k1_errs[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sdpa["fwd"] if name == "fwd" else sdpa["bwd"],
            "library_call": "scaled_dot_product_attention " + (
                f"forward ({sdpa['fwd_backend']['picked']})" if name == "fwd"
                else f"backward ({sdpa['bwd_node']})"),
        }
        if name != "fwd":
            row["library_ms_is_pair"] = "flash.dq + flash.dkv"
        kernels.append(row)
    # torch.neg is R1's plain version and the one library call computing
    # the same function: plain_ms and library_ms are the same timing
    # (device time, as ms)
    kernels.append({
        "name": "stream.neg", "route": "cuda",
        "source": "kungfu_tpu_torch/csrc/stream.cu",
        "replaces": R1_REPLACES, "launches": r1_launches,
        "max_abs_err": r1_err, "ms": r1_times["ms"],
        "plain_ms": r1_times["plain_ms"],
        "bound_ms": r1_times["bound_ms"], "bound_by": "bytes",
        "library_ms": r1_times["plain_ms"],
    })
    log(f"resnet50 S-SGD: {resnet['images_per_sec']:.1f} images/s, "
        f"{resnet['step_time_ms']:.2f} ms/step (NCCL, one card)")
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was not launched on its path: {kernels}")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                         # noqa: BLE001 — report, fail
        traceback.print_exc()
        sys.exit(1)
