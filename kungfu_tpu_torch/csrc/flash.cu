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
// Design: all three kernels are TMA-fed wgmma pipelines of one shape
// (FlashAttention-3's, simplified; the kernel comments below give the
// details). A CTA is G consumer warpgroups, each owning one 64-row tile
// of the side that stays resident (query tiles for fwd and dq, key
// tiles for dkv), loaded once by TMA, beside a producer warpgroup that
// streams the other side's tiles (one thread issues every TMA copy)
// through a ring of stages guarded by full/empty mbarriers. TMA reads
// [B, T, H, D] in place
// through 4-D tensor maps (128-byte swizzle, rows past T zero-filled);
// the consumers run wgmma m64nNk16 straight from the swizzled tiles, and
// a probability or score gradient goes from the accumulators to the next
// product as its register A operand, so no [64, 64] tile of p or ds ever
// touches shared memory. Every warpgroup of a CTA walks the union of
// its tiles' spans (`_k_span`, kungfu_tpu/ops/flash.py:260, for fwd and
// dq; `_q_span`, :276, for dkv), so every wgmma runs the same number of
// times (none in a divergent branch) and causal attention visits about
// half the tiles, a sliding window O(window / 64) of them; a tile
// outside a warpgroup's own span is masked out whole and adds nothing.
// Partial tiles and a ragged T are masked element by element, so any T
// runs on the kernels. CTAs with the longest causal spans launch first.
// - fwd keeps the running max and sum in f32 registers (base-2
//   exponent, scale folded in) and writes o in bf16 and, when asked, lse;
// - dq computes delta for its rows first, from its resident dO tile and
//   a TMA-loaded o tile, and writes it (the precompute folded in, as
//   flash.py:34-38 does on the TPU); then per key tile S = Q K^T and
//   dP = dO V^T, p = exp2(S scale log2e - lse log2e), ds = p (dP -
//   delta), dQ += ds K;
// - dkv works in the transposed score space (keys on rows): per query
//   tile S^T = K Q^T and dP^T = V dO^T, p^T from the lse row that the
//   producer streams with the tile, dV += p^T dO, ds^T = p^T (dP^T -
//   delta), dK += ds^T Q; dk and dv accumulate in f32 registers of the
//   warpgroup that owns the keys. It runs after dq on the same stream.
// p and ds are rounded to bf16 before their products
// (`ops.flash.kernel_error_bounds` gives the tolerance). No atomics:
// every result is deterministic.
//
// The PTX building blocks (mbarriers, TMA, wgmma) are in hopper.cuh,
// shared with fused_ce.cu and paged_attn.cu.
//
// C interface (bound with ctypes): every function launches on the
// caller's stream, allocates nothing and returns cudaGetLastError(), or
// a negative code when a tensor map cannot be encoded (-1: the encoder
// was not found; -1000 - CUresult: it refused the operand). D must be 64
// or 128. `stages` and `smem` are the ring's depth and the dynamic
// shared memory in bytes (`flash_plan`'s fwd_cta, dq_cta and dkv_cta);
// a launcher refuses a byte count below what its layout needs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;             // query rows and key rows of a tile
constexpr int kBox = kTile * 64 * 2;  // [64 rows, 64 of D] bf16: 8 KB
constexpr int kRowsB = 2 * kTile * 4; // dkv: a stage's lse and delta rows
constexpr int kStagesMax = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// a [64, D] tile in shared memory: D / 64 swizzled boxes of 8 KB
template <int D>
__host__ __device__ constexpr int tile_bytes() {
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

// dq: query tiles a CTA, two at either head dim (dQ, S and dP: 96
// accumulator registers a thread at D = 64, 128 at D = 128). Three at
// D = 64, at setmaxnreg 160, spilled and were slower at the training
// shape on the H100
template <int D>
__host__ __device__ constexpr int dq_q_tiles() { return 2; }

// dkv: key tiles a CTA. dK, dV, S^T and dP^T take 128 accumulator
// registers a thread at D = 64: two warpgroups beside the producer (three,
// at setmaxnreg 160, spilled and were no faster); at D = 128 they take
// 192, so one warpgroup, which may use 255
template <int D>
__host__ __device__ constexpr int dkv_k_tiles() { return D == 64 ? 2 : 1; }

// the backward's CTAs: G consumer warpgroups and a producer. With three
// warpgroups the producer gives registers to the consumers (2 x 128 x
// 232 + 128 x 40 = 64,512 of the 65,536; ptxas allocates the consumers'
// code to the raised count, though -v reports the launch's 168); with
// two no thread needs more than the 255 it has
template <int G>
__device__ __forceinline__ void producer_regs() {
  if constexpr (G == 2) setmaxnreg_dec<40>();
}
template <int G>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (G == 2) setmaxnreg_inc<232>();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool visible(int q, int k, int t, int causal,
                                        int window) {
  if (q >= t || k >= t) return false;
  if (!causal) return true;
  return q >= k && (window < 0 || q - k <= window);
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

// a tile holds a pair that must be masked: a query or key past T, the
// causal diagonal (or a tile past it) or the window's edge. k1_fwd keeps
// its own copies of this test and of `scores`: built on these two
// helpers its launch took 0.129 ms against 0.114 at the training shape
// on the H100 (benchmarks/kernel_split.py)
__device__ __forceinline__ bool edge_tile(int iq, int jk, int t, int causal,
                                          int window) {
  return (iq + 1) * kTile > t || (jk + 1) * kTile > t ||
         (causal && (jk >= iq || (window >= 0 &&
                                  (iq - jk) * kTile + kTile - 1 > window)));
}

// S[64, 64] = A B^T over D for two [64, D] tiles (K-major wgmma
// operands at descriptors da and db; D / 64 boxes each)
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint64_t da,
                                       uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * (kBox >> 4) + 2 * (kk % 4);
    wgmma_n64<0, 0>(s, da + off, db + off, kk);
  }
}

// rows r and r + 8 (register halves) of a warpgroup's [64, D]
// accumulator, times `mul`, as bf16 into [T, D] rows of stride ld; rows
// at or past T are dropped
template <int D>
__device__ __forceinline__ void store_acc(bf16* g, long long ld, int r,
                                          int t, const float (&acc)[D / 2],
                                          float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= t) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(g + (size_t)row * ld + 8 * i +
                                   2 * (lane & 3)) =
          pack_bf16(acc[4 * i + 2 * half] * mul,
                    acc[4 * i + 2 * half + 1] * mul);
  }
}

// the sum of the products of 8 bf16 pairs held in a and b
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x[i]));
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&y[i]));
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
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
  constexpr int kTileB = tile_bytes<D>();
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

// One CTA: warpgroups 0 .. G - 1 consume (G = dq_q_tiles<D>()), each
// owning one 64-row query tile of the group (G p, ..., G p + G - 1) of
// one (b, h); warpgroup G produces (one thread issues every copy). The
// producer loads each tile's Q, dO and O once (past the last tile it
// loads tile nq - 1 again: those rows are all past T and never stored),
// then streams the K and V tiles of the union of the tiles' `_k_span`s
// through a ring of `stages` stages, as k1_fwd does. A warpgroup first
// forms delta = rowsum(dO * O) of its rows from the two swizzled tiles
// (a row lives on the 4 lanes of a quad, each summing D / 4 products)
// and writes it for dkv; then, per key tile:
//   1. S = Q K^T and, issued right behind it, dP = dO V^T: wgmma
//      m64n64k16 over D, every operand K-major, two commit groups;
//   2. once S has retired (dP still running), P = exp2(S scale log2e -
//      lse log2e) on the accumulators, masked only on an edge tile;
//   3. once dP has retired, dS = P (dP - delta), rounded to bf16 as
//      wgmma's register A fragments (the accumulator layout is the A
//      layout, so dS never touches shared memory);
//   4. dQ += dS K: K from the ring N-major (the transpose bit), m64nDk16,
//      left running while the next tile's S and dP are issued behind it;
//   5. releases the stage once that product has retired (the last
//      stage is never waited for again and is not released).
// dq = scale dQ is written in bf16. CTAs are numbered so that the last
// groups, whose causal spans are the longest, launch first.
template <int D>
__global__ void __launch_bounds__((dq_q_tiles<D>() + 1) * 128, 1)
    k1_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* lse, bf16* dq, float* delta, int t, int h,
                 float scale, int causal, int window, int stages) {
  constexpr int kTileB = tile_bytes<D>();
  constexpr int kG = dq_q_tiles<D>();
  constexpr int kConsumers = kG * 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sq = smem;                       // per tile: Q, dO, O
  unsigned char* ring = smem + kG * 3 * kTileB;   // stages x (K, V)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * 2 * kTileB);
  uint64_t* empty = full + stages;
  uint64_t* qfull = empty + stages;
  const int nq = (t + kTile - 1) / kTile;
  const int ngroups = (nq + kG - 1) / kG;
  const int bhn = gridDim.x / ngroups;
  const int grp = ngroups - 1 - (int)(blockIdx.x / bhn);
  const int bh = blockIdx.x % bhn, bi = bh / h, hd = bh % h;
  int lo = nq, hi = 0;
  for (int g = 0; g < kG; ++g) {
    int a, b;
    k_span(kG * grp + g, nq, causal, window, &a, &b);
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
    producer_regs<kG>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qfull, kG * 3 * kTileB);
      for (int g = 0; g < kG; ++g) {
        const int r = min(kG * grp + g, nq - 1) * kTile;
        for (int p = 0; p < D / 64; ++p) {
          unsigned char* s = sq + 3 * g * kTileB + p * kBox;
          tma_load_4d(s, &tm_q, p * 64, hd, r, bi, qfull);
          tma_load_4d(s + kTileB, &tm_do, p * 64, hd, r, bi, qfull);
          tma_load_4d(s + 2 * kTileB, &tm_o, p * 64, hd, r, bi, qfull);
        }
      }
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
    consumer_regs<kG>();
    const int g = threadIdx.x >> 7;
    const int wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int iq = kG * grp + g;
    const int r0 = wq * 16 + (lane >> 2);  // tile rows r0 and r0 + 8
    const int row = iq * kTile + r0;
    const unsigned char* tq = sq + 3 * g * kTileB;
    const float sl2 = scale * kLog2e;
    mbar_wait(qfull, 0);
    // delta = rowsum(dO * O): lane l of a quad sums 16-byte chunks
    // 2 (l % 4) and + 1 of each 64-column box of the row
    float dl[2], ls[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int off = p * kBox + sw128_off(r, 8 * (2 * (lane & 3) + j));
          sum += dot8(*reinterpret_cast<const uint4*>(tq + kTileB + off),
                      *reinterpret_cast<const uint4*>(tq + 2 * kTileB + off));
        }
      dl[half] = quad_sum(sum);
      const bool live = row + 8 * half < t;
      if (live && (lane & 3) == 0)
        delta[(size_t)bh * t + row + 8 * half] = dl[half];
      ls[half] = live ? lse[(size_t)bh * t + row + 8 * half] * kLog2e : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint64_t dqd = sw128_desc(tq, 16);
    const uint64_t dod = sw128_desc(tq + kTileB, 16);
    uint32_t da[4][4];  // dS fragments, read by a dQ product in flight
    int st = 0, prev = -1;
    uint32_t ph = 0;
    for (int jk = lo; jk < hi; ++jk) {
      mbar_wait(&full[st], ph);
      __syncwarp();
      const unsigned char* s = ring + st * 2 * kTileB;
      float sc[32], dp[32];
      wgmma_fence();
      scores<D>(sc, dqd, sw128_desc(s, 16));
      wgmma_commit();
      scores<D>(dp, dod, sw128_desc(s + kTileB, 16));
      wgmma_commit();
      // the previous tile's dQ product ran behind these two: once it has
      // retired, its stage goes back to the producer
      wgmma_wait<2>();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      wgmma_wait<1>();
      fence_acc(sc);
      // register 4i + 2 half + c: row `row` + 8 half, key 8 i + 2 (lane % 4)
      // + c of the tile
      const bool edge = edge_tile(iq, jk, t, causal, window);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * i + 2 * half + c];
            const int key = jk * kTile + 8 * i + 2 * (lane & 3) + c;
            x = !edge || visible(row + 8 * half, key, t, causal, window)
                    ? exp2f(fmaf(x, sl2, -ls[half]))
                    : 0.f;
          }
      wgmma_wait<0>();
      fence_acc(dp);
      // dS as wgmma's A fragments: 16-key step kc is accumulator columns
      // 8 (2 kc) .. 8 (2 kc + 1) + 7; register pair 8 kc + 2 e is row
      // half e % 2
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * kc + 2 * e;
          da[kc][e] = pack_bf16(sc[j] * (dp[j] - dl[e & 1]),
                                sc[j + 1] * (dp[j + 1] - dl[e & 1]));
        }
      wgmma_fence();
      const uint64_t dkn = sw128_desc(s, kBox);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) pv_step<D>(acc, da[kc], dkn + 128 * kc);
      wgmma_commit();
      prev = st;
      if (++st == stages) { st = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    const long long ld = (long long)h * D;
    store_acc<D>(dq + (size_t)bi * t * ld + (size_t)hd * D, ld, row, t, acc,
                 scale);
  }
}

// One CTA: warpgroups 0 .. G - 1 consume (G = dkv_k_tiles<D>()), each
// owning one 64-row key tile of the group (G p, ..., G p + G - 1) of one
// (b, h), whose K and V the producer loads once (past the last tile,
// tile nk - 1 again: never stored); warpgroup G produces. The producer
// streams the query tiles of the union of the key tiles' `_q_span`s:
// per stage, its first thread copies Q and dO [64, D] by TMA (4-D
// tensor maps, as k1_fwd) and its second warp the tile's 64 lse and 64
// delta values with plain loads (0 past T), each lane arriving on the
// stage's full barrier after its stores (a head's row of lse starts at
// b h T floats, which TMA cannot read from an address that is not a
// multiple of 16 bytes). Per query tile, a warpgroup, in the
// transposed score space (its 64 keys on rows, the 64 queries on
// columns):
//   1. S^T = K Q^T and, issued right behind it, dP^T = V dO^T (wgmma
//      m64n64k16 over D, every operand K-major), two commit groups;
//   2. once S^T has retired, P^T = exp2(S^T scale log2e - lse log2e),
//      lse by column from the stage, masked only on an edge tile;
//   3. once dP^T has retired, P^T and dS^T = P^T (dP^T - delta) rounded
//      to bf16 as register A fragments;
//   4. dV += P^T dO and dK += dS^T Q (dO and Q from the ring N-major,
//      the transpose bit; m64nDk16), one commit group;
//   5. releases the stage once both products have retired.
// dk = scale dK and dv = dV are written in bf16. The first groups,
// whose causal spans are the longest, launch first.
template <int D>
__global__ void __launch_bounds__((dkv_k_tiles<D>() + 1) * 128, 1)
    k1_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const float* lse, const float* delta, bf16* dk, bf16* dv,
                  int t, int h, float scale, int causal, int window,
                  int stages) {
  constexpr int kTileB = tile_bytes<D>();
  constexpr int kG = dkv_k_tiles<D>();
  constexpr int kConsumers = kG * 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* skv = smem;                      // per tile: K, V
  unsigned char* ring = smem + kG * 2 * kTileB;   // stages x (Q, dO)
  unsigned char* rows = ring + stages * 2 * kTileB;  // stages x (lse, delta)
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + stages * kRowsB);
  uint64_t* empty = full + stages;
  uint64_t* kvfull = empty + stages;
  const int nk = (t + kTile - 1) / kTile;
  const int ngroups = (nk + kG - 1) / kG;
  const int bhn = gridDim.x / ngroups;
  const int grp = (int)(blockIdx.x / bhn);
  const int bh = blockIdx.x % bhn, bi = bh / h, hd = bh % h;
  int lo = nk, hi = 0;
  for (int g = 0; g < kG; ++g) {
    int a, b;
    q_span(kG * grp + g, nk, causal, window, &a, &b);
    lo = min(lo, a);
    hi = max(hi, b);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread and the row loaders
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(kvfull, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // ------------------------ producer
    producer_regs<kG>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kvfull, kG * 2 * kTileB);
      for (int g = 0; g < kG; ++g) {
        const int r = min(kG * grp + g, nk - 1) * kTile;
        for (int p = 0; p < D / 64; ++p) {
          unsigned char* s = skv + 2 * g * kTileB + p * kBox;
          tma_load_4d(s, &tm_k, p * 64, hd, r, bi, kvfull);
          tma_load_4d(s + kTileB, &tm_v, p * 64, hd, r, bi, kvfull);
        }
      }
      int st = 0;
      uint32_t ph = 0;
      for (int iq = lo; iq < hi; ++iq) {
        mbar_wait(&empty[st], ph ^ 1);
        unsigned char* s = ring + st * 2 * kTileB;
        mbar_expect_tx(&full[st], 2 * kTileB);
        for (int p = 0; p < D / 64; ++p) {
          tma_load_4d(s + p * kBox, &tm_q, p * 64, hd, iq * kTile, bi,
                      &full[st]);
          tma_load_4d(s + kTileB + p * kBox, &tm_do, p * 64, hd, iq * kTile,
                      bi, &full[st]);
        }
        if (++st == stages) { st = 0; ph ^= 1; }
      }
    } else if (threadIdx.x >= kConsumers + 32 && threadIdx.x < kConsumers + 64) {
      const int l = threadIdx.x - kConsumers - 32;
      const float* gl = lse + (size_t)bh * t;
      const float* gd = delta + (size_t)bh * t;
      int st = 0;
      uint32_t ph = 0;
      for (int iq = lo; iq < hi; ++iq) {
        mbar_wait(&empty[st], ph ^ 1);
        float* r = reinterpret_cast<float*>(rows + st * kRowsB);
#pragma unroll
        for (int j = l; j < kTile; j += 32) {
          const int q = iq * kTile + j;
          r[j] = q < t ? gl[q] : 0.f;
          r[kTile + j] = q < t ? gd[q] : 0.f;
        }
        mbar_arrive(&full[st]);
        if (++st == stages) { st = 0; ph ^= 1; }
      }
    }
  } else {  // ------------------------------------------------ consumers
    consumer_regs<kG>();
    const int g = threadIdx.x >> 7;
    const int wk = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int jk = kG * grp + g;
    const int key = jk * kTile + wk * 16 + (lane >> 2);  // and key + 8
    const float sl2 = scale * kLog2e;
    const uint64_t kd = sw128_desc(skv + 2 * g * kTileB, 16);
    const uint64_t vd = sw128_desc(skv + (2 * g + 1) * kTileB, 16);
    float gk[D / 2], gv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;
    mbar_wait(kvfull, 0);
    int st = 0;
    uint32_t ph = 0;
    for (int iq = lo; iq < hi; ++iq) {
      mbar_wait(&full[st], ph);
      __syncwarp();
      const unsigned char* s = ring + st * 2 * kTileB;
      const float* lr = reinterpret_cast<const float*>(rows + st * kRowsB);
      const float* dr = lr + kTile;
      float sc[32], dp[32];
      wgmma_fence();
      scores<D>(sc, kd, sw128_desc(s, 16));
      wgmma_commit();
      scores<D>(dp, vd, sw128_desc(s + kTileB, 16));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(sc);
      // register 4i + 2 half + c: key `key` + 8 half, query 8 i + 2 (lane
      // % 4) + c of the tile
      const bool edge = edge_tile(iq, jk, t, causal, window);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c0 = 8 * i + 2 * (lane & 3);
        const float2 l = *reinterpret_cast<const float2*>(lr + c0);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * i + 2 * half + c];
            x = !edge || visible(iq * kTile + c0 + c, key + 8 * half, t,
                                 causal, window)
                    ? exp2f(fmaf(x, sl2, -(c ? l.y : l.x) * kLog2e))
                    : 0.f;
          }
      }
      wgmma_wait<0>();
      fence_acc(dp);
      // P^T and dS^T as wgmma's A fragments: 16-query step kc is
      // accumulator columns 16 kc .. 16 kc + 15; register pair 8 kc + 2 e
      // is columns 8 (2 kc + e / 2) + 2 (lane % 4) and + 1
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * kc + 2 * e;
          const float2 d = *reinterpret_cast<const float2*>(
              dr + 8 * (2 * kc + e / 2) + 2 * (lane & 3));
          pa[kc][e] = pack_bf16(sc[j], sc[j + 1]);
          da[kc][e] = pack_bf16(sc[j] * (dp[j] - d.x),
                                sc[j + 1] * (dp[j + 1] - d.y));
        }
      wgmma_fence();
      const uint64_t qn = sw128_desc(s, kBox), don = sw128_desc(s + kTileB, kBox);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) pv_step<D>(gv, pa[kc], don + 128 * kc);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) pv_step<D>(gk, da[kc], qn + 128 * kc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(gv);
      fence_acc(gk);
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == stages) { st = 0; ph ^= 1; }
    }
    const long long ld = (long long)h * D;
    const size_t base = (size_t)bi * t * ld + (size_t)hd * D;
    store_acc<D>(dk + base, ld, key, t, gk, scale);
    store_acc<D>(dv + base, ld, key, t, gv, 1.f);
  }
}

bool shape_ok(int b, int t, int h) {
  return b > 0 && t > 0 && h > 0 && (long long)b * h <= 65535;
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

// the dynamic shared memory a layout needs below the caller's count:
// `tiles` [64, D] tiles, `bytes` more, `bars` mbarriers and 1 KB of
// slack for rounding the base up to the swizzle's 1024-byte period
template <int D>
bool smem_short(long long smem, int tiles, int bytes, int bars) {
  return smem < (long long)tiles * tile_bytes<D>() + bytes + 8 * bars + 1024;
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int b, int t, int h, float scale, int causal, int window, int stages,
        long long smem, void* stream) {
  constexpr int kQT = fwd_q_tiles<D>();
  if (stages < 2 || stages > kStagesMax ||
      smem_short<D>(smem, kQT + 2 * stages, 0, 2 * stages + 1))
    return (int)cudaErrorInvalidValue;
  // a runtime call first: it makes the device's context current in this
  // thread (an autograd worker may have made none), which the tensor-map
  // encoder needs
  int e = (int)cudaFuncSetAttribute(
      k1_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e) return e;
  CUtensorMap tq, tk, tv;
  e = seq_map(&tq, q, b, t, h, D);
  if (!e) e = seq_map(&tk, k, b, t, h, D);
  if (!e) e = seq_map(&tv, v, b, t, h, D);
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
       const void* dout, const void* lse, void* dq_out, void* delta, int b,
       int t, int h, float scale, int causal, int window, int stages,
       long long smem, void* stream) {
  constexpr int kG = dq_q_tiles<D>();
  if (stages < 2 || stages > kStagesMax ||
      smem_short<D>(smem, 3 * kG + 2 * stages, 0, 2 * stages + 1))
    return (int)cudaErrorInvalidValue;
  int e = (int)cudaFuncSetAttribute(
      k1_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);  // first, as in fwd
  if (e) return e;
  CUtensorMap tq, tk, tv, to, tdo;
  e = seq_map(&tq, q, b, t, h, D);
  if (!e) e = seq_map(&tk, k, b, t, h, D);
  if (!e) e = seq_map(&tv, v, b, t, h, D);
  if (!e) e = seq_map(&to, o, b, t, h, D);
  if (!e) e = seq_map(&tdo, dout, b, t, h, D);
  if (e) return e;
  const int nq = (t + kTile - 1) / kTile;
  k1_dq_kernel<D><<<(nq + kG - 1) / kG * b * h, (kG + 1) * 128, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, to, tdo, static_cast<const float*>(lse),
      static_cast<bf16*>(dq_out), static_cast<float*>(delta), t, h, scale,
      causal, window, stages);
  return (int)cudaGetLastError();
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int b, int t,
        int h, float scale, int causal, int window, int stages,
        long long smem, void* stream) {
  constexpr int kG = dkv_k_tiles<D>();
  if (stages < 2 || stages > kStagesMax ||
      smem_short<D>(smem, 2 * kG + 2 * stages, stages * kRowsB,
                    2 * stages + 1))
    return (int)cudaErrorInvalidValue;
  int e = (int)cudaFuncSetAttribute(
      k1_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);  // first, as in fwd
  if (e) return e;
  CUtensorMap tq, tk, tv, tdo;
  e = seq_map(&tq, q, b, t, h, D);
  if (!e) e = seq_map(&tk, k, b, t, h, D);
  if (!e) e = seq_map(&tv, v, b, t, h, D);
  if (!e) e = seq_map(&tdo, dout, b, t, h, D);
  if (e) return e;
  const int nk = (t + kTile - 1) / kTile;
  k1_dkv_kernel<D><<<(nk + kG - 1) / kG * b * h, (kG + 1) * 128, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), t, h, scale, causal, window, stages);
  return (int)cudaGetLastError();
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

// dq [B, T, H, D] bf16 and delta [B*H, T] f32 from the caller's (o, lse).
// A CTA per pair of query tiles of each (b, h), a ring of `stages` K/V
// stages in `smem` bytes (`flash_plan`'s dq_cta)
int k1_dq(const void* q, const void* k, const void* v, const void* o,
          const void* dout, const void* lse, void* dq_out, void* delta, int b,
          int t, int h, int d, float scale, int causal, int window,
          int stages, long long smem, void* stream) {
  if (!shape_ok(b, t, h)) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return dq<64>(q, k, v, o, dout, lse, dq_out, delta, b, t, h, scale, causal,
                  window, stages, smem, stream);
  if (d == 128)
    return dq<128>(q, k, v, o, dout, lse, dq_out, delta, b, t, h, scale,
                   causal, window, stages, smem, stream);
  return (int)cudaErrorInvalidValue;
}

// dk, dv [B, T, H, D] bf16 from lse and k1_dq's delta. A CTA per group
// of key tiles of each (b, h) (two at D = 64, one at D = 128), a ring of
// `stages` (Q, dO, lse, delta) stages in `smem` bytes (`flash_plan`'s
// dkv_cta)
int k1_dkv(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int b,
           int t, int h, int d, float scale, int causal, int window,
           int stages, long long smem, void* stream) {
  if (!shape_ok(b, t, h)) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return dkv<64>(q, k, v, dout, lse, delta, dk, dv, b, t, h, scale, causal,
                   window, stages, smem, stream);
  if (d == 128)
    return dkv<128>(q, k, v, dout, lse, delta, dk, dv, b, t, h, scale, causal,
                    window, stages, smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
