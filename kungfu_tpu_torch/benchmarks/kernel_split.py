"""Where K2d's, K1's and K3's time goes: each kernel timed beside copies
of its own source with one part taken out.

    python3 -m kungfu_tpu_torch.benchmarks.kernel_split
        [--kernels k2,k1,k1_dq,k1_dkv,k3]

Builds, from `csrc/fused_ce.cu`, `csrc/flash.cu` and `csrc/paged_attn.cu`
as they stand, the variants below into ``build/kernel_split/`` (one nvcc
each, in parallel), and times each variant's launch at the shapes of
`chip_smoke.py` (K2d: n_pad 8192, h 768, v_pad 50304; K1: shapes (a) and
(b), device time per launch; K3: both schemes at `K3_SHAPES`, as device
time per launch, since a K3 launch is shorter than the host's time to
issue it). The variants
compute wrong results on purpose; they are only timed. Prints the
card's name and power limit and one JSON line.

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
    return _span(s, "      const unsigned char* s = ring + st * 2 * kTileB;"
                 "\n      const float* lr",
                 "      if (lane == 0) mbar_arrive(&empty[st]);")


def _no_copies(s):
    return _span(_pipeline_only(s),
                 "        mbar_expect_tx(&full[st], 2 * kTileB);",
                 "        if (++st == stages) { st = 0; ph ^= 1; }",
                 "        mbar_arrive(&full[st]);\n")


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
    ap.add_argument("--kernels", default="k2,k1,k1_dq,k1_dkv,k3")
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
                         -1 if window is None else window, fl.FWD_STAGES,
                         fl.fwd_smem(d), _build.stream(q.device))
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
                  -1 if window is None else window, fl.BWD_STAGES)
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
