#!/usr/bin/env python3
"""Why K1's f32 kernels (`k1f_fwd`, `k1f_dq`, `k1f_dkv`, split TF32 on
the tensor cores) form their second products the way they do, measured
on the card against variants built from edited copies of
`csrc/flash.cu`. The forward's P V:

- ``kernel``: `flash.cu` as it stands — each key tile's P V in two
  halves of 32 columns (m64n32k8), each into a fresh accumulator folded
  into O with f32 FMAs (O = alpha O + P V);
- ``across_tiles``: O itself is the tensor cores' accumulator (scaled by
  alpha, then P V summed into it, FlashAttention's usual form), so every
  tile's 24 tensor-core steps add into one running sum;
- ``one_accumulator``: P V into one fresh 64-column accumulator
  (m64n64k8) folded into O, which keeps 32 more registers live.

The backward's dQ += dS K, dV += P^T dO and dK += dS^T Q:

- ``kernel``: each 32-row stage's product in two halves of 32 columns
  into fresh accumulators (`fold_issue`), added into dQ, dK or dV in f32
  (`fold_add`);
- ``across_stages``: dQ, dK and dV themselves are the tensor cores'
  accumulators, so every stage's 12 tensor-core steps add into one
  running sum.

For each: ptxas's registers and spills, and at each shape the largest
error against the plain versions on the same f32 inputs (|o - plain|
and |lse - plain| against `ops.flash.plain_fwd`; dq, delta, dk and dv
against `plain_dq` and `plain_dkv` on the plain forward's (o, lse)), the
largest |x - plain| / (1e-5 + 1e-5 |plain|) (above 1 is outside the card
tests' f32 tolerance), and the ms per launch by CUDA events (20 launches
after one).

    python3 scripts/torch_k1f_accumulate.py

Needs one CUDA card and nvcc; builds into build/k1f_variants/. Prints the
card's name and power limit and one JSON line a variant and shape.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from kungfu_tpu_torch.ops import _build, flash as fl  # noqa: E402

#: (B, T, H, d, causal): the flash benchmark's f32 shape, and T 4096,
#: where a running sum over tiles has four times the steps
SHAPES = ((8, 1024, 12, 64, True), (2, 4096, 12, 64, True),
          (2, 4096, 12, 64, False))

_PV_INTO = "        float pv[16];\n"
_FIRST = ("wgmma_n32_tf32_ra(pv, pb[j], vh + (j / 4) * (kBox >> 4) + "
          "2 * (j % 4),\n                            j);")
_FOLD = ("#pragma unroll\n        for (int i = 0; i < 16; ++i)\n"
         "          acc[16 * nh + i] = fmaf(acc[16 * nh + i], "
         "alpha[(i >> 1) & 1], pv[i]);\n")
_N64 = r'''
__device__ __forceinline__ void wgmma_n64_tf32_ra(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
'''
_ONE = r'''      float pv[32];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wgmma_n64_tf32_ra(pv, pb[j], dvh + (j / 4) * (kBox >> 4) + 2 * (j % 4), j);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wgmma_n64_tf32_ra(pv, pa[j], dvl + (j / 4) * (kBox >> 4) + 2 * (j % 4), 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wgmma_n64_tf32_ra(pv, pa[j], dvh + (j / 4) * (kBox >> 4) + 2 * (j % 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(pv);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
'''


def _cut(src, a, b):
    if a not in src:
        raise RuntimeError(f"{a!r} is not in flash.cu any more")
    return src.replace(a, b)


def across_tiles(src):
    """P V summed into O's own registers, scaled by alpha first."""
    src = _cut(src, _PV_INTO, "        float (&pv)[16] = *reinterpret_cast<"
               "float (*)[16]>(acc + 16 * nh);\n#pragma unroll\n        for "
               "(int i = 0; i < 16; ++i) pv[i] *= alpha[(i >> 1) & 1];\n")
    src = _cut(src, _FIRST, _FIRST.replace("j);", "1);"))
    return _cut(src, _FOLD, "")


_FOLD_DQ = "      float pv[2][16];\n      wgmma_fence();\n"
_FOLD_DKV = "      float pv[2][16], pk[2][16];\n"
_FOLD_FIRST = "wgmma_n32_tf32_ra(pv[nh], al[j], h + 2 * j, j);"
_FOLD_ADD = ("#pragma unroll\n  for (int nh = 0; nh < 2; ++nh)\n#pragma unroll\n"
             "    for (int i = 0; i < 16; ++i) acc[16 * nh + i] += pv[nh][i];\n")


def _alias(name, acc):
    return (f"      float (&{name})[2][16] = *reinterpret_cast<float (*)[2]"
            f"[16]>({acc});\n")


def across_stages(src):
    """dQ, dK and dV as the tensor cores' running sums over the stages:
    the products go into them (no fresh accumulator, no f32 add)."""
    src = _cut(src, _FOLD_DQ, _alias("pv", "acc") + "      wgmma_fence();\n")
    src = _cut(src, _FOLD_DKV, _alias("pv", "gv") + _alias("pk", "gk"))
    src = _cut(src, _FOLD_FIRST, _FOLD_FIRST.replace("j);", "1);"))
    return _cut(src, _FOLD_ADD, "")


def one_accumulator(src):
    """P V into one 64-column accumulator, then the fold."""
    src = _cut(src, "// byte offset of f32 element (r, c) in a [rows, 32] box",
               _N64 + "\n// byte offset of f32 element (r, c) in a [rows, 32] "
               "box")
    a = src.index("#pragma unroll\n      for (int nh = 0; nh < 2; ++nh) {")
    b = src.index("      if (lane == 0) mbar_arrive(&empty[st]);", a)
    return src[:a] + _ONE + src[b:]


VARIANTS = {"kernel": lambda s: s, "across_tiles": across_tiles,
            "one_accumulator": one_accumulator,
            "across_stages": across_stages}
#: the variants of the forward's P V and of the backward's fold
FWD_VARIANTS = ("kernel", "across_tiles", "one_accumulator")
BWD_VARIANTS = ("kernel", "across_stages")
_KERNELS = ("k1f_fwd_kernel", "k1f_dq_kernel", "k1f_dkv_kernel")


def build(name):
    """({kernel: ptxas line} of the three tf32 kernels, library path) of
    variant `name`."""
    out_dir = os.path.join(ROOT, "build", "k1f_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"flash_{name}.cu")
    with open(os.path.join(_build.CSRC, "flash.cu")) as f:
        text = VARIANTS[name](f.read())
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", lib, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}")
    lines = proc.stdout.splitlines()
    ptxas = {}
    for kernel in _KERNELS:
        i = next(i for i, ln in enumerate(lines)
                 if "Function properties" in ln and kernel in ln)
        ptxas[kernel] = " | ".join(ln.strip() for ln in lines[i + 1:i + 3])
    return ptxas, lib


def load(path):
    lib = ctypes.CDLL(path)
    for fn, (restype, argtypes) in _build.KERNELS["flash"][1].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def ms_per_launch(fn, n=20):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _errs(pairs):
    """For each (name, x, ref) of `pairs`: max |x - ref| and the largest
    |x - ref| / (1e-5 + 1e-5 |ref|)."""
    out = {}
    for n, x, r in pairs:
        err = (x - r).abs()
        out[f"{n}_max_abs_err"] = float(err.max())
        out[f"{n}_err_over_tol"] = float((err / (1e-5 + 1e-5 * r.abs()))
                                         .max())
    return out


def run_bwd(lib, name, b, t, h, d, causal, q, k, v, do, o, lse):
    """One variant's dq and dkv at one shape: their errors against the
    plain versions on the same (o, lse) and their ms per launch. The
    kernels read o in place: it must be contiguous (the plain forward's
    einsum may return a permuted view)."""
    o = o.contiguous()
    rdq, rdelta = fl.plain_dq(q, k, v, o, lse, do, causal)
    rdk, rdv = fl.plain_dkv(q, k, v, do, lse, rdelta, causal)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty_like(rdelta)
    stream = _build.stream(q.device)
    common = (b, t, h, d, d ** -0.5, int(causal), -1, fl.TF32_STAGES)

    def run_dq():
        err = lib.k1f_dq(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         dq.data_ptr(), delta.data_ptr(), *common,
                         fl.tf32_smem(kernel="dq"), stream)
        if err:
            raise RuntimeError(f"{name}: k1f_dq returned {err}")

    def run_dkv():
        err = lib.k1f_dkv(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(), *common,
                          fl.tf32_smem(kernel="dkv"), stream)
        if err:
            raise RuntimeError(f"{name}: k1f_dkv returned {err}")

    dq_ms, dkv_ms = ms_per_launch(run_dq), ms_per_launch(run_dkv)
    errs = _errs((("dq", dq, rdq), ("delta", delta, rdelta),
                  ("dk", dk, rdk), ("dv", dv, rdv)))
    return {**errs, "dq_ms": dq_ms, "dkv_ms": dkv_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1f_accumulate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip())
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = dict(zip(VARIANTS, ex.map(build, VARIANTS)))
    libs = {n: load(path) for n, (_, path) in built.items()}
    for b, t, h, d, causal in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(t + d)
        q, k, v = (torch.randn(b, t, h, d, generator=g, device="cuda")
                   for _ in range(3))
        ro, rlse = fl.plain_fwd(q, k, v, causal)
        for name in FWD_VARIANTS:
            lib = libs[name]
            o, lse = torch.empty_like(q), torch.empty_like(rlse)
            stream = _build.stream(q.device)

            def run():
                err = lib.k1f_fwd(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), lse.data_ptr(), b, t, h, d,
                                  d ** -0.5, int(causal), -1,
                                  fl.TF32_STAGES, fl.tf32_smem(), stream)
                if err:
                    raise RuntimeError(f"{name}: k1f_fwd returned {err}")

            ms = ms_per_launch(run)
            print(json.dumps({
                "variant": name, "kernel": "k1f_fwd",
                "shape": [b, t, h, d, causal],
                "ptxas": built[name][0]["k1f_fwd_kernel"],
                "o_max_abs_err": float((o - ro).abs().max()),
                "lse_max_abs_err": float((lse - rlse).abs().max()),
                "o_err_over_tol": float(((o - ro).abs()
                                         / (1e-5 + 1e-5 * ro.abs())).max()),
                "ms": ms}), flush=True)
        do = torch.randn(b, t, h, d, generator=g, device="cuda")
        for name in BWD_VARIANTS:
            print(json.dumps({
                "variant": name, "kernel": "k1f_dq, k1f_dkv",
                "shape": [b, t, h, d, causal],
                "ptxas": {n: built[name][0][n] for n in _KERNELS[1:]},
                **run_bwd(libs[name], name, b, t, h, d, causal, q, k, v,
                          do, ro, rlse)}), flush=True)
            torch.cuda.empty_cache()
        del q, k, v, do, ro, rlse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
