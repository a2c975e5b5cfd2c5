#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`kungfu_tpu_torch`) on one card.

    python3 chip_smoke.py

Builds every CUDA kernel of the serving path from the sources in this
checkout (nvcc, sm_90a), then runs, failing on the first phase that
fails:

1. kernel — K3 (`paged_attn.resident`, `paged_attn.stream`) against its
   plain PyTorch version at the serving shapes (B=8, h=12, d=64, bt=16,
   max_blocks=64, a 12-layer pool viewed through block_base) in bf16
   and f32;
2. serve — GPT-2-small at full width (bf16, random weights from a
   seed) behind `DecodeEngine` (max_batch 8, bt 16, max_len 1024,
   prefix sharing, 256-token prefill chunks) answering 12 requests;
   driven once with the default kernel ("auto", the plan's resident
   scheme) and once with kernel="stream", the launch counts zeroed just
   before each run and read just after;
3. parity — a 2-layer f32 model at GPT-2-small width: the engine's
   kernel paths give the same tokens as its functional oracle and as
   dense-cache `gpt_generate`;
4. timing — each K3 scheme per launch at B=8 full 1023-token rows,
   cycling through the 12 layers' pools, beside its bound, the plain
   version and one library call (scaled_dot_product_attention on
   pre-gathered K/V, timed here only — the port never calls it).

Prints the card's name and power limit, the measurements, a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero without that line when there is no CUDA card or the
package is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from collections import deque

HERE = os.path.dirname(os.path.abspath(__file__))

#: the H100 SXM's published peaks (NVIDIA data sheet): HBM3 bytes/s and
#: f32 FLOP/s outside the tensor cores (K3's arithmetic is f32 FMA)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

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
        for scheme in ("resident", "stream"):
            smem = pa.smem_bytes(scheme, MAX_BLOCKS, BT, HEAD_DIM,
                                 q.element_size())
            got = pa.paged_attention(q, kp, vp, tables, lens,
                                     block_base=base, scheme=scheme)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  f"{scheme} {name}: non-finite output")
            err = (got.float() - ref.float()).abs()
            atol, rtol = TOL[name]
            bad = err > atol + rtol * ref.float().abs()
            errs[(scheme, name)] = float(err.max())
            log(f"kernel {scheme:8s} {name:8s} max_abs_err "
                f"{errs[(scheme, name)]:.3e} (tolerance {atol:g} + "
                f"{rtol:g}*|ref|) smem {smem} B")
            check(not bool(bad.any()), f"{scheme} {name}: "
                  f"{int(bad.sum())} elements outside tolerance")
        del kp, vp
    return errs


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


def phase_timing(torch, pa):
    """K3 per launch at B=8 full rows (decode at max_len), cycling over
    the 12 layers' pools (~300 MB, so L2 holds none of a launch's
    K/V from the previous visit)."""
    import torch.nn.functional as F

    dtype = torch.bfloat16
    lengths = [MAX_LEN - 1] * BATCH
    tables, lens = tables_for(torch, lengths)
    kp, vp, nbp1 = pools(torch, dtype)
    g = torch.Generator(device=DEVICE).manual_seed(4)
    q = torch.randn(BATCH, HEADS, HEAD_DIM, generator=g,
                    device=DEVICE).to(dtype)
    isz = q.element_size()
    nbytes = (pa.paged_traffic_bytes(lengths, BT, HEADS, HEAD_DIM, isz)
              + 2 * q.numel() * isz + tables.numel() * 4 + lens.numel() * 4)
    visible = sum(n + 1 for n in lengths)
    flops = 4 * visible * HEADS * HEAD_DIM
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    res = {}
    for scheme in ("resident", "stream"):
        res[scheme] = time_cuda(torch, lambda i, s=scheme: pa.paged_attention(
            q, kp, vp, tables, lens, block_base=(i % LAYERS) * nbp1,
            scheme=s), 20 * LAYERS)
    plain_ms = time_cuda(torch, lambda i: pa.paged_attention_reference(
        q, kp, vp, tables, lens, block_base=(i % LAYERS) * nbp1),
        2 * LAYERS)
    # the library yardstick: SDPA over K/V gathered beforehand
    idx = tables.long()
    kk = [kp[idx + l * nbp1].reshape(BATCH, MAX_LEN, HEADS, HEAD_DIM)
          .transpose(1, 2).contiguous() for l in range(LAYERS)]
    vv = [vp[idx + l * nbp1].reshape(BATCH, MAX_LEN, HEADS, HEAD_DIM)
          .transpose(1, 2).contiguous() for l in range(LAYERS)]
    mask = (torch.arange(MAX_LEN, device=DEVICE)[None, :]
            <= lens.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = time_cuda(torch, lambda i: F.scaled_dot_product_attention(
        q4, kk[i % LAYERS], vv[i % LAYERS], attn_mask=mask), 20 * LAYERS)
    for scheme, ms in res.items():
        log(f"timing {scheme:8s} {ms:.4f} ms/launch; bound {bound_ms:.4f} ms "
            f"({bound_by}: {nbytes} B, {flops} flop); plain {plain_ms:.4f} "
            f"ms; library sdpa {lib_ms:.4f} ms; {1e-6 * nbytes / ms:.1f} "
            f"GB/s achieved")
    return res, plain_ms, lib_ms, bound_ms, bound_by


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kungfu_tpu_torch.ops import _build
    from kungfu_tpu_torch.ops import paged_attn as pa
    from kungfu_tpu_torch.serve import build_lm

    card = card_line()
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    text = _build.build("paged_attn")
    log(f"build: {time.perf_counter() - t0:.1f} s (paged_attn)")
    for line in text.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            log(f"  paged_attn: {line.strip()}")
    _build.load("paged_attn")

    errs = phase_kernel(torch, pa)
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
    times, plain_ms, lib_ms, bound_ms, bound_by = phase_timing(torch, pa)

    kernels = []
    for scheme in ("resident", "stream"):
        kernels.append({
            "name": f"paged_attn.{scheme}", "route": "cuda",
            "source": "kungfu_tpu_torch/csrc/paged_attn.cu",
            "replaces": REPLACES[scheme],
            "launches": served[scheme][1]["launches"],
            "max_abs_err": errs[(scheme, "bfloat16")],
            "ms": times[scheme], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
        })
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
