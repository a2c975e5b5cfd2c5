// K1: flash attention, hand-written for Hopper (sm_90a). Replaces the
// Pallas TPU kernels of kungfu_tpu/ops/flash.py:
//   k1_fwd  <- `_fwd_res_kernel` / `_fwd_res_kernel_nolse` (:437, :470,
//              resident scheme) and `_kernel` / `_kernel_nolse` (:375,
//              :424, stream scheme), both driven by `_flash_fwd_impl`
//   k1_dq   <- `_dq_res_kernel` (:477) and `_bwd_dq_kernel` (:801)
//   k1_dkv  <- `_dkv_res_kernel` (:510) and `_bwd_dkv_kernel` (:845),
//              both driven by `_flash_bwd_impl`
// On the TPU the resident and stream schemes exist only because of the
// 16 MB VMEM limit; on Hopper one kernel per direction replaces both.
//
// Function, over q, k, v, o, dO [B, T, H, D] in bf16 (read in place
// through their row stride H*D: head h at offset h*D, no transposes) and
// lse, delta [B*H, T] f32, with s = scale * q.k^T and a key visible to a
// query iff key < T and, when causal, q >= key and (window < 0 or
// q - key <= window):
//   fwd:  o = softmax(s) . v in the input dtype; lse = logsumexp(s)
//   dq:   delta = rowsum(dO * o) (f32, written for dkv);
//         p = exp(s - lse); dq = scale * (p * (dO.v^T - delta)) . k
//   dkv:  dv = p^T . dO; dk = scale * (p * (dO.v^T - delta))^T . q
// The backward takes lse (and o) from the caller, so a ring hop can hand
// in the GLOBAL (o, lse) and get its block's exact gradient share.
//
// Bound on the H100 at GPT-2-small training shape (B=8, T=1024, H=12,
// D=64, causal; 3.35 TB/s, 989 TFLOP/s bf16): fwd reads q, k, v and
// writes o and lse (50.7 MB; 12.9 GFLOP on the 524,800 visible pairs of
// each head) and is bytes-bound at 15.1 us; dq moves 76.3 MB (19.4
// GFLOP) and is bytes-bound at 22.8 us; dkv does four products per
// visible pair (25.8 GFLOP, 76.3 MB) and is bound by operations at
// 26.1 us (`chip_smoke.py::k1_bound`). Both sides of the balance are
// close, so the design keeps every [T, T] intermediate on chip (nothing
// of the scores or probabilities reaches device memory) and skips every
// fully masked tile.
//
// Design:
// - fwd (K1a/K1b): a TMA-fed wgmma kernel, FlashAttention-3's shape
//   simplified (kernel comment below). The parent design it replaces ran
//   4-warp CTAs on one 64-row query tile each, staged K and V with
//   synchronous 16-byte loads between two __syncthreads (no copy
//   overlapping a product) and multiplied with mma.sync, in launch
//   order; here a producer warp keeps K and V tiles in flight through an
//   mbarrier ring while three consumer warpgroups at D = 64, two at
//   D = 128 (a query tile each) run wgmma, P goes from the score
//   accumulators to the second product in registers, and the longest
//   causal spans launch first;
// - dq and dkv (the parent design, right and simple first; their TMA/
//   wgmma redesign is later work): FlashAttention-2 tiling, one CTA of 4
//   warps per (64-row tile, b*h); each warp owns 16 rows of that tile.
//   The other side streams through shared memory in 64-row tiles,
//   staged by 16-byte loads (rows padded by 16 bytes against bank
//   conflicts), with no overlap of loads and products; products are
//   bf16 mma.sync.m16n8k16 with f32 accumulation. The score
//   accumulator's register layout is the A operand's, so p and ds
//   become the next product's A fragments in registers without a trip
//   through shared memory;
// - fwd and dq loop only over the key tiles [lo, hi) of `_k_span`
//   (kungfu_tpu/ops/flash.py:260), dkv over the query tiles of
//   `_q_span` (:276): causal attention visits about half the tiles and a
//   sliding window O(window / 64) of them. Partial tiles and a ragged T
//   are masked element by element, so any T runs on the kernels;
// - fwd keeps the running max and sum in f32 registers (base-2
//   exponent, scale folded in) and writes o in bf16 and, when asked, lse;
// - dq computes delta for its rows first and writes it (the precompute
//   folded in, as flash.py:34-38 does on the TPU), then rebuilds p from
//   lse for each key tile;
// - dkv works in the transposed score space (keys on rows), so dk and dv
//   accumulate in f32 registers of the warp that owns the keys; it runs
//   after dq on the same stream. No atomics: the result is
//   deterministic.
//
// The PTX building blocks (mbarriers, TMA, wgmma) are in hopper.cuh,
// shared with fused_ce.cu.
//
// C interface (bound with ctypes): every function launches on the
// caller's stream, allocates nothing and returns cudaGetLastError(), or
// a negative code when a tensor map cannot be encoded (-1: the encoder
// was not found; -1000 - CUresult: it refused the operand). D must be 64
// or 128.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // dq, dkv: 4 warps x 16 rows
constexpr int kTile = 64;      // query rows and key rows of a tile
constexpr int kBox = kTile * 64 * 2;  // [64 rows, 64 of D] bf16: 8 KB
constexpr int kFwdStagesMax = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// shared-memory row stride of a staged [64, D] bf16 tile
template <int D>
__host__ __device__ constexpr int ld_of() { return D + 8; }

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * ld_of<D>() * 2;
}

// a fwd [64, D] tile in shared memory: D / 64 swizzled boxes of 8 KB
template <int D>
__host__ __device__ constexpr int fwd_tile_bytes() {
  return (D / 64) * kBox;
}

// fwd: query tiles a CTA, one consumer warpgroup each, beside a producer
// warpgroup. At D = 64 (32 accumulators for O and 32 for S a thread)
// three fit: setmaxnreg 160 for 3 x 128 consumer threads and 32 for the
// producers fill the 64K registers; at D = 128 (64 for O) two, at 232
// and 40
template <int D>
__host__ __device__ constexpr int fwd_q_tiles() { return D == 64 ? 3 : 2; }
template <int D>
__host__ __device__ constexpr int fwd_threads() {
  return (fwd_q_tiles<D>() + 1) * 128;
}

// D += A . B for one m16n8k16 bf16 product with f32 accumulators, in the
// register layouts of the PTX ISA: lane = 4 g + t holds A rows g and
// g + 8 at columns 2t, 2t+1 (regs 0, 1) and 2t+8, 2t+9 (regs 2, 3); B
// column g at rows 2t, 2t+1 (reg 0) and 2t+8, 2t+9 (reg 1); C/D rows g
// (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2t, 2t+1
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + 64) of one head's [T, D] slice (row stride ld elements)
// into shared memory, 16 bytes a thread; rows past T are zero
template <int D>
__device__ __forceinline__ void stage(bf16* s, const bf16* g, long long ld,
                                      int r0, int t) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i - r * kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t)
      val = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(s + r * ld_of<D>() + c) = val;
  }
}

// A fragment: rows [r0, r0 + 16), columns [k0, k0 + 16) of a row-major
// shared tile
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int ld,
                                       int r0, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = s + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B fragment (16 x 8) from a tile stored [n][k]: B[k][n] = s[n0 + n][k0 + k]
// (k^T in q.k^T, for example)
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* s, int ld,
                                          int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment (16 x 8) from a tile stored [k][n]: B[k][n] = s[k0 + k][n0 + n]
// (v in p.v, for example)
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* s, int ld,
                                          int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const unsigned short* p = reinterpret_cast<const unsigned short*>(
      s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2));
  b[0] = (uint32_t)p[0] | ((uint32_t)p[ld] << 16);
  b[1] = (uint32_t)p[8 * ld] | ((uint32_t)p[9 * ld] << 16);
}

// the A fragment of k-chunk kc (16 columns) from a 16 x 64 f32
// accumulator in the C layout, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*c)[4],
                                         int kc) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// acc[j] (+)= rows [r0, r0 + 16) of sa . (columns of sb), over D: the
// 16 x 64 scores of one warp against a 64-row tile stored [n][k]
template <int D>
__device__ __forceinline__ void scores(float (*acc)[4], const bf16* sa,
                                       int r0, const bf16* sb) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    load_a(a, sa, ld_of<D>(), r0, kc * 16);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[2];
      load_b_nk(b, sb, ld_of<D>(), j * 8, kc * 16);
      mma_16816(acc[j], a, b);
    }
  }
}

// out[n] += (bf16 of the 16 x 64 accumulator p) . sb, sb a 64 x D tile
// stored [k][n]
template <int D>
__device__ __forceinline__ void accumulate(float (*out)[4],
                                           const float (*p)[4],
                                           const bf16* sb) {
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) {
    uint32_t a[4];
    acc_to_a(a, p, kc);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b[2];
      load_b_kn(b, sb, ld_of<D>(), kc * 16, n * 8);
      mma_16816(out[n], a, b);
    }
  }
}

__device__ __forceinline__ bool visible(int q, int k, int t, int causal,
                                        int window) {
  if (q >= t || k >= t) return false;
  if (!causal) return true;
  return q >= k && (window < 0 || q - k <= window);
}

// rows r and r + 8 of a warp's 16 x D accumulator, times `mul`, as bf16
// into [T, D] rows of stride ld (rows past T are dropped)
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, long long ld, int row,
                                           int t, const float (*acc)[4],
                                           float mul0, float mul1) {
  const int c = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= t) continue;
    const float mul = half ? mul1 : mul0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(g + (size_t)r * ld + n * 8 + c) =
          pack_bf16(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

// `_k_span`: the key tiles [lo, hi) that query tile iq can see
__device__ __forceinline__ void k_span(int iq, int nk, int causal, int window,
                                       int* lo, int* hi) {
  *lo = 0;
  *hi = nk;
  if (!causal) return;
  *hi = min(((iq + 1) * kTile - 1) / kTile + 1, nk);
  if (window >= 0) *lo = max((iq * kTile - window) / kTile, 0);
}

// `_q_span`: the query tiles [lo, hi) that can see key tile jk
__device__ __forceinline__ void q_span(int jk, int nq, int causal, int window,
                                       int* lo, int* hi) {
  *lo = 0;
  *hi = nq;
  if (!causal) return;
  *lo = (jk * kTile) / kTile;
  if (window >= 0) *hi = min((jk * kTile + kTile - 1 + window) / kTile + 1, nq);
}

// O[64, D] += P[64, 16 keys] . V[16 keys, D]: P from registers, V the
// ring's [64, D] tile (N-major: the transpose bit) at descriptor dv
template <int D>
__device__ __forceinline__ void pv_step(float (&o)[D / 2],
                                        const uint32_t (&a)[4], uint64_t dv) {
  if constexpr (D == 64)
    wgmma_n64_ra<1>(o, a, dv);
  else
    wgmma_n128_ra<1>(o, a, dv);
}

// One CTA: warpgroups 0 .. QT - 1 consume (QT = fwd_q_tiles<D>()), each
// owning one 64-row query tile of the group (QT p, ..., QT p + QT - 1)
// of one (b, h); warpgroup QT produces (one thread issues every copy).
// The producer loads the group's query tiles once (past the last tile
// it loads tile nq - 1 again: those warpgroups' rows are all past T and
// are never stored), then streams the key and value tiles of the union
// of the warpgroups' `_k_span`s, [lo, hi), through a ring of `stages`
// stages (K and V [64, D] each, 128-byte swizzled boxes of 64 columns:
// two per tile at D = 128), each guarded by a full and an empty
// mbarrier. TMA
// reads [B, T, H, D] in place through 4-D tensor maps and zero-fills
// rows past T. Every warpgroup walks the whole union, so every wgmma
// runs the same number of times in all (none in a divergent branch); a
// tile outside a warpgroup's own span is masked out entirely and adds
// nothing. Per key tile, a warpgroup:
//   1. S[64, 64] = Q K^T: wgmma m64n64k16 over D, both operands K-major;
//   2. masks S only on a tile that holds keys past T, the causal
//      diagonal or the window's edge, and runs the online softmax on the
//      accumulators (base 2, the scale folded in, f32 running max and
//      sum; a row lives on the 4 lanes of a quad);
//   3. O += P V: P rounded to bf16 in registers (the S accumulator
//      layout is wgmma's register-A fragment layout, so P never touches
//      shared memory), V from the ring (N-major, transpose bit),
//      m64nDk16;
//   4. releases the stage once both products have retired.
// CTAs are numbered so that the last groups, whose causal spans are the
// longest, launch first.
template <int D>
__global__ void __launch_bounds__(fwd_threads<D>(), 1)
    k1_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, bf16* o,
                  float* lse, int t, int h, float scale, int causal,
                  int window, int stages) {
  constexpr int kTileB = fwd_tile_bytes<D>();
  constexpr int kQT = fwd_q_tiles<D>();
  constexpr int kConsumers = kQT * 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sq = smem;                   // the group's query tiles
  unsigned char* ring = smem + kQT * kTileB;  // stages x (K tile, V tile)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * 2 * kTileB);
  uint64_t* empty = full + stages;
  uint64_t* qfull = empty + stages;
  const int nq = (t + kTile - 1) / kTile;
  const int ngroups = (nq + kQT - 1) / kQT;
  const int bhn = gridDim.x / ngroups;
  const int grp = ngroups - 1 - (int)(blockIdx.x / bhn);
  const int bh = blockIdx.x % bhn, bi = bh / h, hd = bh % h;
  int lo = nq, hi = 0;
  for (int g = 0; g < kQT; ++g) {
    int a, b;
    k_span(kQT * grp + g, nq, causal, window, &a, &b);
    lo = min(lo, a);
    hi = max(hi, b);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(qfull, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // ------------------------ producer
    setmaxnreg_dec<kQT == 3 ? 32 : 40>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qfull, kQT * kTileB);
      for (int g = 0; g < kQT; ++g)
        for (int p = 0; p < D / 64; ++p)
          tma_load_4d(sq + g * kTileB + p * kBox, &tm_q, p * 64, hd,
                      min(kQT * grp + g, nq - 1) * kTile, bi, qfull);
      int st = 0;
      uint32_t ph = 0;
      for (int jk = lo; jk < hi; ++jk) {
        mbar_wait(&empty[st], ph ^ 1);
        unsigned char* s = ring + st * 2 * kTileB;
        mbar_expect_tx(&full[st], 2 * kTileB);
        for (int p = 0; p < D / 64; ++p) {
          tma_load_4d(s + p * kBox, &tm_k, p * 64, hd, jk * kTile, bi,
                      &full[st]);
          tma_load_4d(s + kTileB + p * kBox, &tm_v, p * 64, hd, jk * kTile,
                      bi, &full[st]);
        }
        if (++st == stages) { st = 0; ph ^= 1; }
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<kQT == 3 ? 160 : 232>();
    const int g = threadIdx.x >> 7;
    const int wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int iq = kQT * grp + g;
    const int row = iq * kTile + wq * 16 + (lane >> 2);  // and row + 8
    const float sl2 = scale * kLog2e;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
    const uint64_t dq = sw128_desc(sq + g * kTileB, 16);
    mbar_wait(qfull, 0);
    int st = 0;
    uint32_t ph = 0;
    for (int jk = lo; jk < hi; ++jk) {
      mbar_wait(&full[st], ph);
      __syncwarp();
      const unsigned char* s = ring + st * 2 * kTileB;
      const uint64_t dk = sw128_desc(s, 16);
      const uint64_t dv = sw128_desc(s + kTileB, kBox);
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * (kBox >> 4) + 2 * (kk % 4);
        wgmma_n64<0, 0>(sc, dq + off, dk + off, kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      // register 4i + 2 half + c: row `row` + 8 half, key 8 i + 2 (lane % 4)
      // + c of the tile
      const bool edge =
          (jk + 1) * kTile > t ||
          (causal && (jk >= iq || (window >= 0 && (iq - jk) * kTile +
                                                          kTile - 1 >
                                                      window)));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row + 8 * half;
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = jk * kTile + 8 * i + 2 * (lane & 3) + c;
            float& x = sc[4 * i + 2 * half + c];
            x = !edge || visible(r, key, t, causal, window) ? x * sl2
                                                            : -CUDART_INF_F;
            mx = fmaxf(mx, x);
          }
        const float m_new = fmaxf(m[half], quad_max(mx));
        const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;  // none visible yet
        const float alpha = exp2f(m[half] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * i + 2 * half + c];
            x = exp2f(x - m_use);
            sum += x;
          }
        l[half] = l[half] * alpha + sum;  // this thread's columns only
        m[half] = m_new;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          acc[4 * i + 2 * half] *= alpha;
          acc[4 * i + 2 * half + 1] *= alpha;
        }
      }
      // P as wgmma's A fragments: 16-key step kc is accumulator columns
      // 8 (2 kc) .. 8 (2 kc + 1) + 7
      uint32_t pa[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kc][e] = pack_bf16(sc[8 * kc + 2 * e], sc[8 * kc + 2 * e + 1]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) pv_step<D>(acc, pa[kc], dv + 128 * kc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == stages) { st = 0; ph ^= 1; }
    }
    const long long ld = (long long)h * D;
    bf16* ob = o + (size_t)bi * t * ld + (size_t)hd * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      l[half] = quad_sum(l[half]);
      const float inv = l[half] == 0.f ? 1.f : 1.f / l[half];
      if (r >= t) continue;
      if (lse != nullptr && (lane & 3) == 0)
        lse[(size_t)bh * t + r] = m[half] * kLn2 + logf(l[half]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r * ld + 8 * i +
                                     2 * (lane & 3)) =
            pack_bf16(acc[4 * i + 2 * half] * inv,
                      acc[4 * i + 2 * half + 1] * inv);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    k1_dq_kernel(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                 const bf16* dout, const float* lse, bf16* dq, float* delta,
                 int t, int h, float scale, int causal, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDo = sQ + kTile * ld_of<D>();
  bf16* sK = sDo + kTile * ld_of<D>();
  bf16* sV = sK + kTile * ld_of<D>();
  float* sDelta = reinterpret_cast<float*>(sV + kTile * ld_of<D>());
  const int iq = blockIdx.x, bh = blockIdx.y;
  const long long ld = (long long)h * D;
  const size_t base = (size_t)(bh / h) * t * ld + (size_t)(bh % h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = iq * kTile;
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const float sl2 = scale * kLog2e;
  stage<D>(sQ, q + base, ld, q0, t);
  stage<D>(sDo, dout + base, ld, q0, t);
  __syncthreads();

  // delta = rowsum(dO * o) for this warp's 16 rows, written for dkv
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    float part = 0.f;
    if (q0 + r < t) {
#pragma unroll
      for (int c = 2 * lane; c < D; c += 64) {
        const bf16* go = o + base + (size_t)(q0 + r) * ld + c;
        const bf16* sd = sDo + r * ld_of<D>() + c;
        part += __bfloat162float(sd[0]) * __bfloat162float(go[0]) +
                __bfloat162float(sd[1]) * __bfloat162float(go[1]);
      }
    }
    part = warp_sum(part);
    if (lane == 0) {
      sDelta[r] = part;
      if (q0 + r < t) delta[(size_t)bh * t + q0 + r] = part;
    }
  }
  __syncwarp();
  float dl[2], ls[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    dl[half] = sDelta[r - q0];
    ls[half] = r < t ? lse[(size_t)bh * t + r] * kLog2e : 0.f;
  }
  int lo, hi;
  k_span(iq, (t + kTile - 1) / kTile, causal, window, &lo, &hi);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int jk = lo; jk < hi; ++jk) {
    __syncthreads();
    stage<D>(sK, k + base, ld, jk * kTile, t);
    stage<D>(sV, v + base, ld, jk * kTile, t);
    __syncthreads();
    float s[8][4], dp[8][4];
    scores<D>(s, sQ, warp * 16, sK);
    scores<D>(dp, sDo, warp * 16, sV);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + 8 * (e >> 1);
        const int key = jk * kTile + j * 8 + 2 * (lane & 3) + (e & 1);
        const float p = visible(r, key, t, causal, window)
                            ? exp2f(s[j][e] * sl2 - ls[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);  // ds
      }
    accumulate<D>(acc, s, sK);
  }
  store_rows<D>(dq + base, ld, row, t, acc, scale, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    k1_dkv_kernel(const bf16* q, const bf16* k, const bf16* v,
                  const bf16* dout, const float* lse, const float* delta,
                  bf16* dk, bf16* dv, int t, int h, float scale, int causal,
                  int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTile * ld_of<D>();
  bf16* sQ = sV + kTile * ld_of<D>();
  bf16* sDo = sQ + kTile * ld_of<D>();
  float* sL = reinterpret_cast<float*>(sDo + kTile * ld_of<D>());
  float* sDelta = sL + kTile;
  const int jk = blockIdx.x, bh = blockIdx.y;
  const long long ld = (long long)h * D;
  const size_t base = (size_t)(bh / h) * t * ld + (size_t)(bh % h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key = jk * kTile + warp * 16 + (lane >> 2);  // and key + 8
  const float sl2 = scale * kLog2e;
  stage<D>(sK, k + base, ld, jk * kTile, t);
  stage<D>(sV, v + base, ld, jk * kTile, t);
  int lo, hi;
  q_span(jk, (t + kTile - 1) / kTile, causal, window, &lo, &hi);

  float gk[D / 8][4], gv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;
  for (int iq = lo; iq < hi; ++iq) {
    const int q0 = iq * kTile;
    __syncthreads();
    stage<D>(sQ, q + base, ld, q0, t);
    stage<D>(sDo, dout + base, ld, q0, t);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      sL[threadIdx.x] = r < t ? lse[(size_t)bh * t + r] * kLog2e : 0.f;
      sDelta[threadIdx.x] = r < t ? delta[(size_t)bh * t + r] : 0.f;
    }
    __syncthreads();
    // transposed space: rows are this warp's 16 keys, columns 64 queries
    float s[8][4], dp[8][4];
    scores<D>(s, sK, warp * 16, sQ);
    scores<D>(dp, sV, warp * 16, sDo);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * (lane & 3) + (e & 1);
        const float p = visible(q0 + c, key + 8 * (e >> 1), t, causal, window)
                            ? exp2f(s[j][e] * sl2 - sL[c]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sDelta[c]);  // ds^T
      }
    accumulate<D>(gv, s, sDo);
    accumulate<D>(gk, dp, sQ);
  }
  store_rows<D>(dk + base, ld, key, t, gk, scale, scale);
  store_rows<D>(dv + base, ld, key, t, gv, 1.f, 1.f);
}

// launch `kernel` on the caller's stream after raising its dynamic
// shared-memory limit where it needs more than the default 48 KB
template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, int smem, void* stream,
           A... args) {
  if (smem > 48 * 1024) {
    const int e = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e) return e;
  }
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

bool shape_ok(int b, int t, int h) {
  return b > 0 && t > 0 && h > 0 && (long long)b * h <= 65535;
}

dim3 grid_of(int b, int t, int h) {
  return dim3((t + kTile - 1) / kTile, b * h);
}

// a [B, T, H, D] bf16 tensor read in boxes of (64 of D, 1 head, 64
// rows, 1 batch), 128-byte swizzled, rows past T read as zeros; 0, or
// the negative code of the C interface
int seq_map(CUtensorMap* map, const void* p, int b, int t, int h, int d) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1;
  const cuuint64_t dim[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t,
                             (cuuint64_t)b};
  const cuuint64_t stride[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2,
                                (cuuint64_t)t * h * d * 2};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(p), dim, stride, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int b, int t, int h, float scale, int causal, int window, int stages,
        long long smem, void* stream) {
  constexpr int kTileB = fwd_tile_bytes<D>();
  constexpr int kQT = fwd_q_tiles<D>();
  if (stages < 2 || stages > kFwdStagesMax ||
      smem < kQT * kTileB + stages * 2 * kTileB + 8 * (2 * stages + 1) + 1024)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int e = seq_map(&tq, q, b, t, h, D);
  if (!e) e = seq_map(&tk, k, b, t, h, D);
  if (!e) e = seq_map(&tv, v, b, t, h, D);
  if (e) return e;
  e = (int)cudaFuncSetAttribute(k1_fwd_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  if (e) return e;
  const int nq = (t + kTile - 1) / kTile;
  k1_fwd_kernel<D><<<(nq + kQT - 1) / kQT * b * h, fwd_threads<D>(), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), t, h,
      scale, causal, window, stages);
  return (int)cudaGetLastError();
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const void* lse, void* dq, void* delta, int b,
       int t, int h, float scale, int causal, int window, void* stream) {
  return launch(k1_dq_kernel<D>, grid_of(b, t, h),
                4 * tile_bytes<D>() + kTile * 4, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                static_cast<const bf16*>(dout),
                static_cast<const float*>(lse), static_cast<bf16*>(dq),
                static_cast<float*>(delta), t, h, scale, causal, window);
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int b, int t,
        int h, float scale, int causal, int window, void* stream) {
  return launch(k1_dkv_kernel<D>, grid_of(b, t, h),
                4 * tile_bytes<D>() + 2 * kTile * 4, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<bf16*>(dk),
                static_cast<bf16*>(dv), t, h, scale, causal, window);
}

}  // namespace

extern "C" {

// o [B, T, H, D] bf16 and, unless lse is null, lse [B*H, T] f32.
// window < 0: no window. A CTA per group of query tiles of each (b, h)
// (three at D = 64, two at D = 128), each a ring of `stages` K/V stages
// in `smem` bytes of dynamic shared memory (`flash_plan`'s fwd_cta)
int k1_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int t, int h, int d, float scale, int causal, int window,
           int stages, long long smem, void* stream) {
  if (!shape_ok(b, t, h)) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return fwd<64>(q, k, v, o, lse, b, t, h, scale, causal, window, stages,
                   smem, stream);
  if (d == 128)
    return fwd<128>(q, k, v, o, lse, b, t, h, scale, causal, window, stages,
                    smem, stream);
  return (int)cudaErrorInvalidValue;
}

// dq [B, T, H, D] bf16 and delta [B*H, T] f32 from the caller's (o, lse)
int k1_dq(const void* q, const void* k, const void* v, const void* o,
          const void* dout, const void* lse, void* dq_out, void* delta, int b,
          int t, int h, int d, float scale, int causal, int window,
          void* stream) {
  if (!shape_ok(b, t, h)) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return dq<64>(q, k, v, o, dout, lse, dq_out, delta, b, t, h, scale, causal,
                  window, stream);
  if (d == 128)
    return dq<128>(q, k, v, o, dout, lse, dq_out, delta, b, t, h, scale,
                   causal, window, stream);
  return (int)cudaErrorInvalidValue;
}

// dk, dv [B, T, H, D] bf16 from lse and k1_dq's delta
int k1_dkv(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int b,
           int t, int h, int d, float scale, int causal, int window,
           void* stream) {
  if (!shape_ok(b, t, h)) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return dkv<64>(q, k, v, dout, lse, delta, dk, dv, b, t, h, scale, causal,
                   window, stream);
  if (d == 128)
    return dkv<128>(q, k, v, dout, lse, delta, dk, dv, b, t, h, scale, causal,
                    window, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
