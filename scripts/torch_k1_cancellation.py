#!/usr/bin/env python3
"""How far K1's dq sits from the exact result where dp - delta cancels.

A row whose output o is exactly one value row (causal row 0 sees only
key 0, so o = v0) has dp - delta = dO.v0 - dO.o = 0 in exact arithmetic.
Two f32 sums of d products in different orders leave a residue there
that grows with d, and `ops.flash.kernel_error_bounds` allows dq only
2**-7 * 1e-3 * p * scale * |k| for it. This script reports, as the
largest ratio of |error| to that bound (2**-8 |exact| added, as the card
tests do) over every element and over row tile 0, at the card test's
inputs (B 2, T 200, h 3, causal, seed d, `tests/test_torch_cuda.py::
_k1_inputs`):

- ``f32``: the plain dq with dp and delta summed in f32, as the plain
  version did before it formed them in f64 (`ops.flash._score_grad`);
- ``plain``: `ops.flash.plain_dq` as it stands;
- ``kernel`` (on the card only): the `k1_dq` launch.

Each against the exact dq (the same formula in f64), from the same
(o, lse): the plain forward's on the CPU, the kernel's on the card.

    python3 scripts/torch_k1_cancellation.py [--device cpu|cuda]
        [--dims 64,128,200,256]

Prints one JSON line a head dim.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from kungfu_tpu_torch.ops import flash as fl  # noqa: E402


def exact_dq(q, k, v, o, lse, do, causal, dtype):
    """dq by the plain formula with every operand and sum in `dtype`;
    f32 is the plain version as it was before dp - delta went to f64."""
    b, t, h, d = q.shape
    q, k, v, o, do = (x.to(dtype) for x in (q, k, v, o, do))
    scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(s - lse.to(dtype).reshape(b, h, t, 1))
    keep = fl._visible(t, t, causal, None, q.device)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    return scale * torch.einsum("bhqk,bkhd->bqhd", p * (dp - delta), k)


def ratios(got, exact, bound):
    r = (got.double() - exact).abs() / (bound.double()
                                        + 2.0 ** -8 * exact.abs())
    return round(float(r.max()), 3), round(float(r[:, :64].max()), 3)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--dims", default="64,128,200,256")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_k1_cancellation: no CUDA device", file=sys.stderr)
        return 2
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    b, t, h, causal = 2, 200, 3, True
    for d in (int(x) for x in args.dims.split(",")):
        g = torch.Generator().manual_seed(d)
        q, k, v, do = [torch.randn(b, t, h, d, generator=g)
                       .to(args.device, torch.bfloat16) for _ in range(4)]
        f = [x.float() for x in (q, k, v, do)]
        if args.device == "cuda":
            o, lse = fl.flash_fwd(q, k, v, causal)
        else:
            ro, lse = fl.plain_fwd(*f[:3], causal)
            o = ro.to(torch.bfloat16)
        exact = exact_dq(*f[:3], o.float(), lse, f[3], causal, torch.float64)
        bound = fl.kernel_error_bounds(*f[:3], o, lse, f[3], causal)["dq"]
        row = {"device": args.device, "d": d, "shape": [b, t, h, d],
               "causal": causal, "ratio_all_and_row_tile_0": {
                   "f32": ratios(exact_dq(*f[:3], o.float(), lse, f[3],
                                          causal, torch.float32),
                                 exact, bound),
                   "plain": ratios(fl.plain_dq(*f[:3], o.float(), lse, f[3],
                                               causal)[0], exact, bound)}}
        if args.device == "cuda":
            dq, _ = fl.flash_dq(q, k, v, o, lse, do, causal)
            torch.cuda.synchronize()
            row["ratio_all_and_row_tile_0"]["kernel"] = ratios(dq, exact,
                                                               bound)
            row["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
