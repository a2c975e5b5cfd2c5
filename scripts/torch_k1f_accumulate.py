#!/usr/bin/env python3
"""Why K1's f32 forward (`k1f_fwd`, split TF32 on the tensor cores) forms
P V the way it does, measured on the card against two variants built
from edited copies of `csrc/flash.cu`:

- ``kernel``: `flash.cu` as it stands — each key tile's P V in two
  halves of 32 columns (m64n32k8), each into a fresh accumulator folded
  into O with f32 FMAs (O = alpha O + P V);
- ``across_tiles``: O itself is the tensor cores' accumulator (scaled by
  alpha, then P V summed into it, FlashAttention's usual form), so every
  tile's 24 tensor-core steps add into one running sum;
- ``one_accumulator``: P V into one fresh 64-column accumulator
  (m64n64k8) folded into O, which keeps 32 more registers live.

For each: ptxas's registers and spills, and at each shape the largest
|o - plain| and |lse - plain| against `ops.flash.plain_fwd` on the same
f32 inputs, the largest |o - plain| / (1e-5 + 1e-5 |plain|) (above 1 is
outside the card tests' f32 tolerance), and the ms per launch by CUDA
events (20 launches after one).

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


def one_accumulator(src):
    """P V into one 64-column accumulator, then the fold."""
    src = _cut(src, "// byte offset of f32 element (r, c) in a [rows, 32] box",
               _N64 + "\n// byte offset of f32 element (r, c) in a [rows, 32] "
               "box")
    a = src.index("#pragma unroll\n      for (int nh = 0; nh < 2; ++nh) {")
    b = src.index("      if (lane == 0) mbar_arrive(&empty[st]);", a)
    return src[:a] + _ONE + src[b:]


VARIANTS = {"kernel": lambda s: s, "across_tiles": across_tiles,
            "one_accumulator": one_accumulator}


def build(name):
    """(ptxas line of k1f_fwd_kernel, library path) of variant `name`."""
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
    i = next(i for i, ln in enumerate(lines)
             if "Function properties" in ln and "k1f_fwd_kernel" in ln)
    return " | ".join(ln.strip() for ln in lines[i + 1:i + 3]), lib


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
        for name, lib in libs.items():
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
                "variant": name, "shape": [b, t, h, d, causal],
                "ptxas": built[name][0],
                "o_max_abs_err": float((o - ro).abs().max()),
                "lse_max_abs_err": float((lse - rlse).abs().max()),
                "o_err_over_tol": float(((o - ro).abs()
                                         / (1e-5 + 1e-5 * ro.abs())).max()),
                "ms": ms}), flush=True)
        del q, k, v, ro, rlse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
