"""Where K2d's, K1's, K3's and R1's time goes: each kernel timed beside
copies of its own source with one part taken out or replaced.

    python3 -m kungfu_tpu_torch.benchmarks.kernel_split
        [--kernels k2,k1,k1_dq,k1_dkv,k3,r1,r1_walk]

Builds, from `csrc/fused_ce.cu`, `csrc/flash.cu`, `csrc/paged_attn.cu`
and `csrc/stream.cu` as they stand, the variants below into
``build/kernel_split/`` (one nvcc each, in parallel), and times each
variant's launch at the shapes of `chip_smoke.py` (K2d: n_pad 8192, h
768, v_pad 50304; K1: shapes (a) and (b), device time per launch; K3:
both schemes at `K3_SHAPES`, as device time per launch, since a K3
launch is shorter than the host's time to issue it; R1: the suite's
[262144, 1024] bf16, device time per launch). The K2, K1 and K3
variants and R1's copy-only one compute wrong results on purpose; they
are only timed. Prints the card's name and power limit and one JSON
line.

- ``k2_dx``: the kernel; ``products_only``: the cluster exchange (the
  barrier waits and their arming, the sums, d and the copies) removed —
  what the two wgmma products and the ring cost alone.
- ``k1_fwd``: the kernel; ``no_products``: S = Q K^T and O += P V
  removed (the softmax, masks and pipeline stay); ``pipeline_only``:
  also the softmax — the TMA ring with consumers that only wait and
  release; ``no_copies``: also the K/V copies — launch, Q and epilogue.
- ``k1_dq``: the kernel; ``dq_no_products``: S, dP and dQ += dS K
  removed (the delta prologue, exponents, masks, dS and the pipeline
  stay); ``dq_pipeline_only``: also the per-tile arithmetic — the delta
  prologue, the TMA ring and the epilogue.
- ``k1_dkv``: the kernel; ``dkv_no_products``: S^T, dP^T, dV += P^T dO
  and dK += dS^T Q removed; ``dkv_pipeline_only``: also the per-tile
  arithmetic — the ring of (Q, dO, lse, delta) stages and the epilogue.
- ``k3``: the kernel; ``no_compute``: the score dot products and the
  weighted sum of V removed (copies, waits, softmax and exchange stay);
  ``no_loads``: no tile at all — launch, q, length and table reads, the
  cluster exchange and the combine; ``no_exchange``: also the cluster
  barriers and remote reads (CTA barriers and local reads instead);
  ``launch_only``: every CTA returns at once.
- ``r1``: the kernel (bulk copies through a shared ring, chunks taken
  from a counter) at each launch plan of `R1_PLANS`;
  ``static_interleaved`` and ``static_ranges``: each CTA's chunks fixed
  at the launch instead (every grid-th chunk, or one contiguous range);
  ``ticket_ahead``: each ticket taken a chunk earlier;
  ``ticket_groups_4``: 4 consecutive chunks a ticket; ``with_memset``:
  the counter zeroed by a memset before each launch; ``evict_first``:
  an L2 evict-first policy on the bulk loads and stores;
  ``copy_only``: the consumers' negation removed — the ring of bulk
  loads and stores alone. ``r1_walk``: R1 as a walk of
  16-byte vector loads and stores instead (see `_R1_WALKS`):
  ``grid_stride`` (R1's first version: grid-stride, evict-first hints),
  ``grid_stride_plain`` (plain loads and stores), ``contiguous_ranges``
  (a contiguous range a CTA) and ``contiguous_tiles`` (a 16 KB tile a
  CTA, as PyTorch's vectorised elementwise kernels); each bitwise
  torch.neg.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build, flash as fl, fused_ce as fc, paged_attn as pa
from ..ops import stream as st

OUT = _build.BUILD_DIR.parent / "kernel_split"


def _cut(src, a, b=""):
    """`src` with text `a` replaced by `b`; raises if `a` is missing (the
    kernel source changed under the variant)."""
    if a not in src:
        raise RuntimeError(f"kernel_split: {a!r} not in the source")
    return src.replace(a, b)


def _span(src, start, end, new=""):
    """`src` with the text from `start` up to (not including) `end`
    replaced by `new`."""
    i = src.index(start)
    return src[:i] + new + src[src.index(end, i):]


def _products_only(s):
    for a in ("      mbar_wait(pready, j & 1);\n",
              "      mbar_wait(dready, j & 1);\n",
              "if (j + 1 < nv) mbar_expect_tx(pready, p_bytes);",
              "if (threadIdx.x == 0) mbar_expect_tx(dready, d_bytes);"):
        s = _cut(s, a)
    s = _cut(s, "e < (e_hi - e_lo) * (kDxBV / 4);", "e < 0;")
    return _cut(s, '#include "hopper.cuh"\n',
                '#include "hopper.cuh"\n#define dsmem_copy(...) ((void)0)\n')


def _no_products(s):
    s = _cut(s, "wgmma_n64<0, 0>(sc, dq + off, dk + off, kk);",
             "if (kk == 0) sc[0] = 0.f;")
    return _cut(s, "pv_step<D>(acc, pa[kc], dv + 128 * kc);",
                "acc[kc] += __uint_as_float(pa[kc][0]);")


def _pipeline_only(s):
    return _span(s, "      const unsigned char* s = ring + st * 2 * kTileB;",
                 "      if (lane == 0) mbar_arrive(&empty[st]);")


def _k3_no_compute(s):
    s = _cut(s, "p0 + pos <= length ? score(k, pos) : kNegInf",
             "p0 + pos <= length ? 0.f : kNegInf")
    return _cut(s, "    if (g >= groups) return;\n    int rot = rot0;",
                "    return;\n    int rot = rot0;")


def _k3_no_loads(s):
    return _cut(s, "const int ntiles = (nblk + a.tile_blocks - 1) / "
                "a.tile_blocks;", "const int ntiles = 0;")


def _k3_no_exchange(s):
    s = _k3_no_loads(s).replace("cluster_sync();", "__syncthreads();")
    return _cut(s, '  asm volatile("ld.shared::cluster.f32 %0, [%1];"\n'
                '               : "=f"(v)\n'
                '               : "r"(dsmem_addr(p, rank)));', "  v = *p;")


def _k3_launch_only(s):
    return _cut(s, "  constexpr int VEC = 16 / sizeof(T);\n  extern",
                "  constexpr int VEC = 16 / sizeof(T);\n"
                "  if (gridDim.x > 0) return;\n  extern")


def _filled(name, n):
    """`name`[0 .. n) set to values the compiler cannot fold away."""
    return (f"for (int i = 0; i < {n}; ++i) {name}[i] = "
            f"__int_as_float(0x3c000000 + i + (int)(uintptr_t)s);")


def _bwd_no_products(s, kernel):
    """The dq (or dkv) kernel with its wgmma products replaced by fills
    of the accumulators and a sum of the A fragments, so the exponents,
    masks and packs stay live."""
    if kernel == "dq":
        s = _cut(s, "scores<D>(sc, dqd, sw128_desc(s, 16));", _filled("sc", 32))
        s = _cut(s, "scores<D>(dp, dod, sw128_desc(s + kTileB, 16));",
                 _filled("dp", 32))
        return _cut(s, "for (int kc = 0; kc < 4; ++kc) pv_step<D>(acc, da[kc], "
                    "dkn + 128 * kc);",
                    "for (int kc = 0; kc < 16; ++kc) acc[kc % (D / 2)] += "
                    "__uint_as_float(da[kc / 4][kc % 4]);")
    s = _cut(s, "scores<D>(sc, kd, sw128_desc(s, 16));", _filled("sc", 32))
    s = _cut(s, "scores<D>(dp, vd, sw128_desc(s + kTileB, 16));",
             _filled("dp", 32))
    s = _cut(s, "for (int kc = 0; kc < 4; ++kc) pv_step<D>(gv, pa[kc], don + "
             "128 * kc);", "for (int kc = 0; kc < 16; ++kc) gv[kc % (D / 2)] "
             "+= __uint_as_float(pa[kc / 4][kc % 4]);")
    return _cut(s, "for (int kc = 0; kc < 4; ++kc) pv_step<D>(gk, da[kc], qn + "
                "128 * kc);", "for (int kc = 0; kc < 16; ++kc) gk[kc % (D / 2)]"
                " += __uint_as_float(da[kc / 4][kc % 4]);")


def _bwd_pipeline_only(s, kernel):
    """The dq (or dkv) kernel whose consumers only wait for each stage
    and release it."""
    if kernel == "dq":
        return _span(s, "      const unsigned char* s = ring + st * 2 * "
                     "kTileB;\n      float sc[32], dp[32];", "      prev = st;",
                     "      if (lane == 0) mbar_arrive(&empty[st]);\n")
    return _span(s, "    const unsigned char* s = ring + st * 2 * kTileB;"
                 "\n    const float* lr",
                 "    if (lane == 0) mbar_arrive(&empty[st]);")


def _no_copies(s):
    return _span(_pipeline_only(s),
                 "        mbar_expect_tx(&full[st], 2 * kTileB);",
                 "        if (++st == stages) { st = 0; ph ^= 1; }",
                 "        mbar_arrive(&full[st]);\n")


_R1_TICKET = """    const auto ticket = [&] {
      return static_cast<long long>(atomicAdd(tickets, 1));
    };"""


def _r1_static_interleaved(s):
    """R1 with each CTA's share of chunks fixed at the launch: chunks b,
    b + grid, b + 2 grid, ... (all CTAs sweep the tensor together)."""
    return _cut(s, _R1_TICKET, """    long long taken = 0;
    const auto ticket = [&] {
      const long long c = blockIdx.x + gridDim.x * taken++;
      return c < chunks ? c : chunks;
    };""")


def _r1_static_ranges(s):
    """R1 with each CTA's share of chunks fixed at the launch: one
    contiguous range, balanced to a chunk."""
    return _cut(s, _R1_TICKET, """    long long taken = 0;
    const long long per = chunks / gridDim.x, extra = chunks % gridDim.x;
    const long long b = blockIdx.x;
    const long long first = b * per + (b < extra ? b : extra);
    const long long count = per + (b < extra);
    const auto ticket = [&] {
      return taken < count ? first + taken++ : chunks;
    };""")


def _r1_ticket_ahead(s):
    """R1 taking each ticket one chunk earlier: the counter's reply has
    two chunks' time to come back instead of one."""
    return _cut(s, _R1_TICKET, """    long long ahead = atomicAdd(tickets, 1);
    const auto ticket = [&] {
      const long long c = ahead;
      ahead = atomicAdd(tickets, 1);
      return c;
    };""")


_R1_HINTED = r"""
// bulk copies with an L2 evict-first policy
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void bulk_load_ef(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar)),
      "l"(evict_first())
      : "memory");
}

__device__ __forceinline__ void bulk_store_ef(void* dst, const void* src,
                                              uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src)), "r"(bytes), "l"(evict_first())
      : "memory");
}

constexpr int kConsumerWarps"""


def _r1_evict_first(s):
    """R1 with an L2 evict-first policy on its bulk loads and stores."""
    s = _cut(s, "constexpr int kConsumerWarps", _R1_HINTED)
    s = _cut(s, "        bulk_load(smem", "        bulk_load_ef(smem")
    return _cut(s, "      bulk_store(dst", "      bulk_store_ef(dst")


def _r1_ticket_groups(g):
    """R1 taking `g` consecutive chunks a ticket."""
    return lambda s: _cut(s, _R1_TICKET, """    long long group = 0, k = %d;
    const auto ticket = [&] {
      if (k == %d) {
        group = atomicAdd(tickets, 1);
        k = 0;
      }
      const long long c = group * %d + k++;
      return c < chunks ? c : chunks;
    };""" % (g, g, g))


def _r1_with_memset(s):
    """R1 with the counter set to zero by a memset before each launch."""
    return _cut(s, "  if (err != cudaSuccess) return static_cast<int>(err);\n"
                "  r1_neg<<<",
                "  if (err == cudaSuccess) err = cudaMemsetAsync(tickets, 0, "
                "8, st);\n  if (err != cudaSuccess) return "
                "static_cast<int>(err);\n  r1_neg<<<")


def _r1_copy_only(s):
    """R1 with its consumers' negation taken out: the bulk-copy ring
    alone (the consumers still wait, fence and release each stage)."""
    return _cut(s, "#pragma unroll 4\n    for (int j = threadIdx.x; j < vecs; "
                "j += kConsumers) v[j] = neg8(v[j]);\n", "    (void)v;\n")


#: R1 as a 16-byte vector walk of global memory, the launcher's plan
#: arguments ignored but the grid (one an SM): R1's first version, 8
#: CTAs of 256 threads an SM, four vectors in flight a thread 4.3 MB
#: apart (`kStreaming`: evict-first loads and stores); ``ranges``: the
#: same grid, each CTA owning one contiguous range of vectors, four
#: neighbouring 4 KB blocks of it a step; ``tiles``: as PyTorch's
#: vectorised elementwise kernels, one CTA per 16 KB tile, four vectors
#: a thread
_R1_WALKS = r"""
template <bool kStreaming>
__device__ __forceinline__ uint4 ld16(const uint4* p) {
  return kStreaming ? __ldcs(p) : *p;
}

template <bool kStreaming>
__device__ __forceinline__ void st16(uint4* p, uint4 v) {
  if (kStreaming) __stcs(p, v); else *p = v;
}

template <int kWalk, bool kStreaming>
__global__ void __launch_bounds__(256)
    r1_walk(const uint4* __restrict__ x, uint4* __restrict__ o,
            long long nvec) {
  long long i, stride, end;
  if (kWalk == 0) {         // grid stride
    i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
    stride = static_cast<long long>(gridDim.x) * 256;
    end = nvec;
  } else if (kWalk == 1) {  // one contiguous range a CTA
    const long long per = (nvec + gridDim.x - 1) / gridDim.x;
    i = blockIdx.x * per + threadIdx.x;
    stride = 256;
    end = min(nvec, (blockIdx.x + 1) * per);
  } else {                  // one 1024-vector tile a CTA
    i = static_cast<long long>(blockIdx.x) * 1024 + threadIdx.x;
    stride = 256;
    end = min(nvec, i - threadIdx.x + 1024);
  }
  for (; i + 3 * stride < end; i += 4 * stride) {
    const uint4 a = ld16<kStreaming>(x + i);
    const uint4 b = ld16<kStreaming>(x + i + stride);
    const uint4 c = ld16<kStreaming>(x + i + 2 * stride);
    const uint4 d = ld16<kStreaming>(x + i + 3 * stride);
    st16<kStreaming>(o + i, neg8(a));
    st16<kStreaming>(o + i + stride, neg8(b));
    st16<kStreaming>(o + i + 2 * stride, neg8(c));
    st16<kStreaming>(o + i + 3 * stride, neg8(d));
  }
  for (; i < end; i += stride)
    st16<kStreaming>(o + i, neg8(ld16<kStreaming>(x + i)));
}

}  // namespace

extern "C" int r1_neg_bf16(const void* x, void* o, long long n, int grid,
                           int, int, long long, long long, long long, void*,
                           void* stream) {
  if (n <= 0) return 0;
  const long long nvec = n / 8;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* ov = static_cast<uint4*>(o);
  KWALK
  if (n % 8)
    neg_tail_launch<<<1, 32, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                      static_cast<__nv_bfloat16*>(o),
                                      nvec * 8, n);
  return static_cast<int>(cudaGetLastError());
}
"""

_R1_TAIL = r"""
__global__ void neg_tail_launch(const __nv_bfloat16* __restrict__ x,
                                __nv_bfloat16* __restrict__ o,
                                long long begin, long long n) {
  neg_tail(x, o, begin, n, threadIdx.x, 32);
}
"""

_R1_LAUNCH = {
    "grid_stride": "r1_walk<0, true><<<grid * 8, 256, 0, st>>>(xv, ov, nvec);",
    "grid_stride_plain": "r1_walk<0, false><<<grid * 8, 256, 0, st>>>(xv, "
                         "ov, nvec);",
    "contiguous_ranges": "r1_walk<1, false><<<grid * 8, 256, 0, st>>>(xv, "
                         "ov, nvec);",
    "contiguous_tiles": "r1_walk<2, false><<<static_cast<int>((nvec + 1023) "
                        "/ 1024), 256, 0, st>>>(xv, ov, nvec);",
}


def _r1_walk(name):
    """R1's source with the bulk-copy kernel's launcher replaced by the
    walk `name` (the tail past the last vector by a one-warp launch)."""
    def edit(s):
        s = _cut(s, "}  // namespace\n", _R1_TAIL + "}  // namespace\n")
        i = s.index("}  // namespace\n")
        return s[:i] + _R1_WALKS.replace("KWALK", "if (nvec) " +
                                         _R1_LAUNCH[name])
    return edit


#: R1's launch plans timed beside the default one (`ops.stream.r1_plan`
#: keywords)
R1_PLANS = {"default": {},
            "32K x6, 1 an SM": {"chunk_bytes": 32768, "stages": 6,
                                "ctas_per_sm": 1},
            "16K x6, 2 an SM": {"chunk_bytes": 16384, "stages": 6,
                                "ctas_per_sm": 2},
            "16K x10, 1 an SM": {"chunk_bytes": 16384, "stages": 10,
                                 "ctas_per_sm": 1},
            "64K x3, 1 an SM": {"chunk_bytes": 65536, "stages": 3,
                                "ctas_per_sm": 1}}


#: --kernels name -> (library, C entry point, {variant: source edit})
VARIANTS = {
    "k2": ("fused_ce", "k2_dx", {"k2_dx": None,
                                 "products_only": _products_only}),
    "k1": ("flash", "k1_fwd", {"k1_fwd": None, "no_products": _no_products,
                               "pipeline_only": _pipeline_only,
                               "no_copies": _no_copies}),
    "k1_dq": ("flash", "k1_dq", {
        "k1_dq": None,
        "dq_no_products": lambda s: _bwd_no_products(s, "dq"),
        "dq_pipeline_only": lambda s: _bwd_pipeline_only(s, "dq")}),
    "k1_dkv": ("flash", "k1_dkv", {
        "k1_dkv": None,
        "dkv_no_products": lambda s: _bwd_no_products(s, "dkv"),
        "dkv_pipeline_only": lambda s: _bwd_pipeline_only(s, "dkv")}),
    "r1": ("stream", "r1_neg_bf16", {
        "r1_neg": None, "static_interleaved": _r1_static_interleaved,
        "static_ranges": _r1_static_ranges, "ticket_ahead": _r1_ticket_ahead,
        "ticket_groups_4": _r1_ticket_groups(4),
        "with_memset": _r1_with_memset, "evict_first": _r1_evict_first,
        "copy_only": _r1_copy_only}),
    "r1_walk": ("stream", "r1_neg_bf16",
                {k: _r1_walk(k) for k in _R1_LAUNCH}),
    "k3": ("paged_attn", "k3_paged_attention", {
        "k3": None, "no_compute": _k3_no_compute, "no_loads": _k3_no_loads,
        "no_exchange": _k3_no_exchange, "launch_only": _k3_launch_only}),
}


def _build_variant(lib, fn_name, name, edit):
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / _build.KERNELS[lib][0]).read_text()
    (d / _build.KERNELS[lib][0]).write_text(edit(src) if edit else src)
    for f in _build.sources(lib)[1:]:
        (d / f.name).write_text(f.read_text())
    so = d / f"lib{lib}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(d / _build.KERNELS[lib][0])],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"build of {name} failed:\n{proc.stdout}")
    fn = getattr(ctypes.CDLL(str(so)), fn_name)
    fn.restype, fn.argtypes = _build.KERNELS[lib][1][fn_name]
    return name, fn


def _time_k3(cs, fns, out):
    """Every K3 variant, both schemes, at `chip_smoke.K3_SHAPES` (bf16,
    the 12 layers' pools cycled), by device time per launch."""
    kp, vp, nbp1 = cs.pools(torch, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn(cs.BATCH, cs.HEADS, cs.HEAD_DIM, generator=g,
                    device="cuda").to(torch.bfloat16)
    o = torch.empty_like(q)
    plan = pa.paged_plan(cs.MAX_BLOCKS, cs.BT, cs.HEADS, cs.HEAD_DIM,
                         dtype=torch.bfloat16)
    for shape, lengths in cs.K3_SHAPES.items():
        tables, lens = cs.tables_for(torch, lengths)
        for scheme in ("resident", "stream"):
            for name in VARIANTS["k3"][2]:
                def go(i, fn=fns[name]):
                    err = fn(pa._SCHEME_ID[scheme], 1, q.data_ptr(),
                             kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
                             lens.data_ptr(), o.data_ptr(), cs.BATCH,
                             cs.HEADS, cs.HEAD_DIM, cs.BT, cs.MAX_BLOCKS,
                             plan["splits"], plan["split_blocks"],
                             plan["tile_blocks"], plan["ring"],
                             (i % cs.LAYERS) * nbp1, kp.shape[0],
                             cs.HEAD_DIM ** -0.5, plan[f"{scheme}_bytes"],
                             _build.stream(q.device))
                    if err:
                        raise RuntimeError(f"{name}: launch error {err}")
                out[f"{name} {scheme} ({shape})"] = cs.time_device(
                    torch, go, 20 * cs.LAYERS)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default="k2,k1,k1_dq,k1_dkv,k3,r1,r1_walk")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 2
    root = str(_build.BUILD_DIR.parents[1])
    sys.path.insert(0, root)
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    kernels = args.kernels.split(",")
    jobs = [(lib, entry, name, edit) for k in kernels
            for lib, entry, v in [VARIANTS[k]] for name, edit in v.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        fns = dict(pool.map(lambda j: _build_variant(*j), jobs))
    out = {}
    if "k3" in kernels:
        _time_k3(cs, fns, out)
    if "r1" in kernels or "r1_walk" in kernels:
        _time_r1(cs, fns, out, kernels)
    if "k2" in kernels:
        _time_k2(cs, fns, out)
    if "k1" in kernels:
        _time_k1(cs, fns, out)
    for k in ("k1_dq", "k1_dkv"):
        if k in kernels:
            _time_k1_bwd(cs, fns, out, k)
    for k, v in out.items():
        print(f"{k:32s} {v:.4f} ms/launch", flush=True)
    print(json.dumps({"card": card.stdout.strip(), "ms": out}))
    return 0


def _time_r1(cs, fns, out, kernels):
    """Every R1 variant at the suite's shape (0.5 GiB in and out), by
    device time per launch over 50 launches, the kernel as built at each
    of `R1_PLANS`, in order and then again in reverse order (the second
    time under ``... again``), beside torch.neg timed first and last;
    the output is zeroed before each variant and checked bitwise against
    torch.neg after it (but the copy-only one's)."""
    x = torch.randn(cs.R1_SHAPE, device="cuda").to(torch.bfloat16)
    o = torch.empty_like(x)
    tickets = torch.zeros(2, dtype=torch.int32, device="cuda")
    ref = torch.neg(x)
    sms = st._sms(x.device.index)
    out["torch.neg (first)"] = cs.time_device(torch, lambda i: torch.neg(x),
                                              50)
    runs = []
    for k in ("r1", "r1_walk"):
        if k in kernels:
            for name in VARIANTS[k][2]:
                # the walks launch 8 CTAs for each CTA of the plan's grid
                plans = (R1_PLANS if name == "r1_neg" else
                         {"": {"ctas_per_sm": 1} if k == "r1_walk" else {}})
                runs += [(name, tag, kw) for tag, kw in plans.items()]
    for rep, (name, tag, kw) in enumerate(runs + runs[::-1]):
        p = st.r1_plan(x.numel(), sms, **kw)
        o.zero_()

        def go(i, fn=fns[name], args=st.launch_args(x, o, p, tickets)):
            err = fn(*args)
            if err:
                raise RuntimeError(f"{name}: launch error {err}")
        label = (f"{name} ({tag})" if tag else name) + (
            " again" if rep >= len(runs) else "")
        out[label] = cs.time_device(torch, go, 50)
        if name != "copy_only":
            torch.cuda.synchronize()
            cs.check(torch.equal(o.view(torch.int16), ref.view(torch.int16)),
                     f"R1 variant {label}: bits differ from torch.neg")
    out["torch.neg (last)"] = cs.time_device(torch, lambda i: torch.neg(x),
                                             50)


def _time_k2(cs, fns, out):
    x, w, b, t, scale = cs.k2_inputs(torch, fc)
    _, lse, _ = fc.plain_fwd(x, w, b, t, False)
    n_pad, h = x.shape
    v_pad = w.shape[1]
    plan = fc.fused_ce_plan(n_pad, h, v_pad)
    dx = torch.empty((n_pad, h), dtype=torch.bfloat16, device="cuda")
    for name in VARIANTS["k2"][2]:
        def go(i, fn=fns[name]):
            err = fn(scale.data_ptr(), x.data_ptr(), w.data_ptr(),
                     b.data_ptr(), t.data_ptr(), lse.data_ptr(),
                     dx.data_ptr(), n_pad, h, v_pad, plan["dx_cluster"],
                     plan["dx_tiles_per_chunk"], plan["dx_stages"],
                     *fc._smem_args("dx", h), _build.stream(x.device))
            if err:
                raise RuntimeError(f"{name}: launch error {err}")
        out[name] = cs.time_cuda(torch, go, 5)


def _time_k1(cs, fns, out):
    for tag in ("a", "b"):
        bb, tt, hh, d, causal, window = cs.K1_SHAPES[tag]
        sets = [cs.k1_inputs(torch, bb, tt, hh, d, 10 + s)[:3]
                for s in range(4)]
        o = torch.empty_like(sets[0][0])
        lse = torch.empty((bb * hh, tt), device="cuda")
        for name in VARIANTS["k1"][2]:
            def go(i, fn=fns[name]):
                q, k, v = sets[i % 4]
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), lse.data_ptr(), bb, tt, hh, d,
                         d ** -0.5, int(causal),
                         -1 if window is None else window,
                         fl.FWD_STAGES[d], fl.fwd_smem(d),
                         _build.stream(q.device))
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")
            out[f"{name} ({tag})"] = cs.time_device(torch, go, 40)


def _time_k1_bwd(cs, fns, out, kernel):
    """Every variant of the dq (or dkv) kernel at shapes (a) and (b),
    four input sets cycled, by device time per launch; (o, lse, delta)
    from the kernels as built."""
    for tag in ("a", "b"):
        bb, tt, hh, d, causal, window = cs.K1_SHAPES[tag]
        sets = []
        for s in range(4):
            q, k, v, do = cs.k1_inputs(torch, bb, tt, hh, d, 10 + s)
            o, lse = fl.flash_fwd(q, k, v, causal, None, window)
            _, delta = fl.flash_dq(q, k, v, o, lse, do, causal, None, window)
            sets.append((q, k, v, do, o, lse, delta))
        outs = [torch.empty_like(sets[0][0]) for _ in range(2)]
        delta_out = torch.empty_like(sets[0][6])
        common = (bb, tt, hh, d, d ** -0.5, int(causal),
                  -1 if window is None else window, fl.BWD_STAGES[d])
        for name in VARIANTS[kernel][2]:
            def go(i, fn=fns[name]):
                q, k, v, do, o, lse, delta = (x.data_ptr() for x in sets[i % 4])
                if kernel == "k1_dq":
                    err = fn(q, k, v, o, do, lse, outs[0].data_ptr(),
                             delta_out.data_ptr(), *common, fl.dq_smem(d),
                             _build.stream(sets[0][0].device))
                else:
                    err = fn(q, k, v, do, lse, delta, outs[0].data_ptr(),
                             outs[1].data_ptr(), *common, fl.dkv_smem(d),
                             _build.stream(sets[0][0].device))
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")
            out[f"{name} ({tag})"] = cs.time_device(torch, go, 40)


if __name__ == "__main__":
    sys.exit(main())
