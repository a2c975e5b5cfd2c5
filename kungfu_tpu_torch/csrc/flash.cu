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
//   warpgroup that owns the keys (at D = 256 two CTAs own each key tile,
//   one forming dV and one dK, each from its own S^T). It runs after dq
//   on the same stream.
// p and ds are rounded to bf16 before their products
// (`ops.flash.kernel_error_bounds` gives the tolerance). No atomics:
// every result is deterministic.
//
// The PTX building blocks (mbarriers, TMA, wgmma) are in hopper.cuh,
// shared with fused_ce.cu and paged_attn.cu.
//
// Head dims other than the compiled ones: a call at head dim d with d %
// 8 == 0 runs the kernel compiled for D = 64 (d <= 64), D = 128 (64 < d
// <= 128) or D = 256 (128 < d <= 256). Its tensor maps have the caller's
// d as their innermost extent, so a 64-column box runs past d and TMA
// fills the columns past d with zeros (the box's full bytes still arrive
// on the mbarrier, also for a box wholly past d, as the fourth of a D =
// 256 tile at d <= 192); zero columns add nothing to any of the products
// or to delta, so the padded kernel computes the same function. The
// epilogues write rows of stride H * d and only their first d columns:
// the columns past d are the next head's. d % 8 == 0 is TMA's rule that
// every global stride (here d * 2 bytes) be a multiple of 16 bytes: a
// bf16 call at any other d from 1 to 255 reaches these kernels through a
// copy of its operands zero-padded to ceil(d / 8) * 8 columns, made by
// the wrappers (`ops.flash`), which keep the caller's scale and return
// the caller's d columns.
//
// C interface (bound with ctypes): every function launches on the
// caller's stream, allocates nothing and returns cudaGetLastError(), or
// a negative code when a tensor map cannot be encoded (-1: the encoder
// was not found; -1000 - CUresult: it refused the operand). The inputs
// of k1_fwd, k1_dq and k1_dkv are bf16 at any d from 8 to 256 with d %
// 8 == 0; `stages` and `smem` are the ring's depth and the dynamic
// shared memory in bytes (`flash_plan`'s fwd_cta, dq_cta and dkv_cta, at
// the padded D). k1f_fwd (the f32 forward in split TF32 on the tensor
// cores, after the bf16 kernels) takes f32 at d from 4 to 64 with d % 4
// == 0, `stages` and `smem` from `flash_plan`'s tf32_cta; k1s_fwd,
// k1s_dq and k1s_dkv (the SIMT family at the end of this file) take f32
// or f16 at any D from 1 to 256 and `smem` from `simt_smem`. A launcher
// refuses a dtype, head dim or byte count its layout does not take.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
// and 40. At D = 256 (128 for O, 32 for S, 16 for P) one, which may use
// 255 registers without setmaxnreg: with two, ptxas held the kernel to
// the launch's 168 registers a thread and spilled 412 bytes
template <int D>
__host__ __device__ constexpr int fwd_q_tiles() {
  return D == 64 ? 3 : D == 128 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int fwd_threads() {
  return (fwd_q_tiles<D>() + 1) * 128;
}

// dq: query tiles a CTA, two at D = 64 and 128 (dQ, S and dP: 96
// accumulator registers a thread at D = 64, 128 at D = 128). Three at
// D = 64, at setmaxnreg 160, spilled and were slower at the training
// shape on the H100. At D = 256 one: Q, dO and O of a second tile do not
// fit beside the ring (7 tiles of 32 KB take 229,376 of the 232,448
// bytes a block may use), and dQ alone is 128 registers a thread
template <int D>
__host__ __device__ constexpr int dq_q_tiles() { return D == 256 ? 1 : 2; }

// dkv: key tiles a CTA. dK, dV, S^T and dP^T take 128 accumulator
// registers a thread at D = 64: two warpgroups beside the producer
// (three, at setmaxnreg 160, spilled and were no faster); at D = 128 they
// take 192, so one warpgroup, which may use 255. At D = 256 dK and dV
// alone take 256, more than a thread has, so each key tile has two CTAs
// (`dkv_roles`), one forming dV (S^T, P^T: dV 128 + S^T 32 + P^T 16
// registers) and one dK (S^T, dP^T, dS^T: dK 128 + 32 + 32 + 16), each
// one warpgroup beside the producer, which may use 255 (k1_dkv_kernel's
// comment gives why not two warpgroups of one CTA)
template <int D>
__host__ __device__ constexpr int dkv_k_tiles() { return D == 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int dkv_roles() { return D == 256 ? 2 : 1; }

// every CTA: G consumer warpgroups and a producer. With three or four
// warpgroups the producer gives registers to the consumers (3 x 128 x
// 160 + 128 x 32 = 65,536; 2 x 128 x 232 + 128 x 40 = 64,512); with two
// no thread needs more than the 255 it has
template <int G>
__device__ __forceinline__ void producer_regs() {
  if constexpr (G == 3) setmaxnreg_dec<32>();
  if constexpr (G == 2) setmaxnreg_dec<40>();
}
template <int G>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (G == 3) setmaxnreg_inc<160>();
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
// accumulator, times `mul`, as bf16 into [T, d] rows of stride ld (the
// first d of the D columns; d % 8 == 0); rows at or past T are dropped
template <int D>
__device__ __forceinline__ void store_acc(bf16* g, long long ld, int r,
                                          int t, int d,
                                          const float (&acc)[D / 2],
                                          float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= t) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      if (8 * i < d)
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
  else if constexpr (D == 128)
    wgmma_n128_ra<1>(o, a, dv);
  else
    wgmma_n256_ra<1>(o, a, dv);
}

// One CTA: warpgroups 0 .. QT - 1 consume (QT = fwd_q_tiles<D>()), each
// owning one 64-row query tile of the group (QT p, ..., QT p + QT - 1)
// of one (b, h); warpgroup QT produces (one thread issues every copy).
// The producer loads the group's query tiles once (past the last tile
// it loads tile nq - 1 again: those warpgroups' rows are all past T and
// are never stored), then streams the key and value tiles of the union
// of the warpgroups' `_k_span`s, [lo, hi), through a ring of `stages`
// stages (K and V [64, D] each, 128-byte swizzled boxes of 64 columns:
// D / 64 per tile), each guarded by a full and an empty
// mbarrier. TMA reads [B, T, H, d] in place through 4-D tensor maps and
// zero-fills rows past T and columns past d. Every warpgroup walks the
// whole union, so every wgmma runs the same number of times in all (none
// in a divergent branch); a tile outside a warpgroup's own span is masked
// out entirely and adds nothing. Per key tile, a warpgroup:
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
                  float* lse, int t, int h, int d, float scale, int causal,
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
    producer_regs<kQT>();
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
    consumer_regs<kQT>();
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
    // o's rows have the caller's stride h d; only its first d columns
    // are written (those past d belong to the next head)
    const long long ld = (long long)h * d;
    bf16* ob = o + (size_t)bi * t * ld + (size_t)hd * d;
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
        if (8 * i < d)
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
// (a row lives on the 4 lanes of a quad, each summing D / 4 products;
// at D = 256 the diagonal of a wgmma dO O^T) and writes it for dkv;
// then, per key tile:
//   1. S = Q K^T and, issued right behind it (at D = 256 once the
//      previous tile's dQ product has retired), dP = dO V^T: wgmma
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
// dq = scale dQ is written in bf16, d columns of each row at stride H d
// (as k1_fwd's o). CTAs are numbered so that the last groups, whose
// causal spans are the longest, launch first.
template <int D>
__global__ void __launch_bounds__((dq_q_tiles<D>() + 1) * 128, 1)
    k1_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* lse, bf16* dq, float* delta, int t, int h,
                 int d, float scale, int causal, int window, int stages) {
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
    const uint64_t dqd = sw128_desc(tq, 16);
    const uint64_t dod = sw128_desc(tq + kTileB, 16);
    // delta = rowsum(dO * O). At D = 64 and 128: lane l of a quad sums
    // 16-byte chunks 2 (l % 4) and + 1 of each 64-column box of the row.
    // At D = 256: the diagonal of dO O^T from the tensor cores, the
    // product and summation order of dP = dO V^T, so a row whose o is one
    // v row (a single visible key) gets dP - delta exactly 0, as in exact
    // arithmetic; two f32 sums of 256 products in different orders
    // differ there by more than `kernel_error_bounds` allows
    // (scripts/torch_k1_cancellation.py)
    float dl[2], ls[2];
    if constexpr (D == 256) {
      float dd[32];
      wgmma_fence();
      scores<D>(dd, dod, sw128_desc(tq + 2 * kTileB, 16));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dd);
      // row r0 + 8 half's column: register 4 (2 wq + half) + 2 half +
      // (r0 % 2) of quad lane (r0 % 8) / 2, picked by 0/1 weights (a
      // select by index would put dd in local memory)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            x = fmaf(i == 2 * wq + half && c == ((lane >> 2) & 1) ? 1.f : 0.f,
                     dd[4 * i + 2 * half + c], x);
        dl[half] = __shfl_sync(0xffffffffu, x, (lane & ~3) | (lane >> 3));
      }
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float sum = 0.f;
#pragma unroll
        for (int p = 0; p < D / 64; ++p)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int off =
                p * kBox + sw128_off(r0 + 8 * half, 8 * (2 * (lane & 3) + j));
            sum += dot8(*reinterpret_cast<const uint4*>(tq + kTileB + off),
                        *reinterpret_cast<const uint4*>(tq + 2 * kTileB + off));
          }
        dl[half] = quad_sum(sum);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bool live = row + 8 * half < t;
      if (live && (lane & 3) == 0)
        delta[(size_t)bh * t + row + 8 * half] = dl[half];
      ls[half] = live ? lse[(size_t)bh * t + row + 8 * half] * kLog2e : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
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
      if constexpr (D == 256) {
        // dQ, dS, S and dP together would pass the 255 registers a
        // thread has (ptxas spilled): dP is issued once the previous dQ
        // product, and with it dS, has retired
        wgmma_wait<1>();
        wgmma_fence();
      }
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
    const long long ld = (long long)h * d;  // the caller's d, as in k1_fwd
    store_acc<D>(dq + (size_t)bi * t * ld + (size_t)hd * d, ld, row, t, d,
                 acc, scale);
  }
}

// dkv's loop over the streamed query tiles [lo, hi) for key tile jk (the
// steps are k1_dkv_kernel's): kRole 3 forms dK and dV (D 64 and 128), 1
// only dV and 2 only dK (D 256: a CTA a role, and gk and gv are then one
// array, of which only the role's product is formed). Every stage is
// released by each consumer warp once its products have retired
template <int D, int kRole>
__device__ __forceinline__ void dkv_tiles(
    float (&gk)[D / 2], float (&gv)[D / 2], const unsigned char* ring,
    const unsigned char* rows, uint64_t* full, uint64_t* empty, uint64_t kd,
    uint64_t vd, int jk, int key, int lo, int hi, int t, int causal,
    int window, float sl2, int stages) {
  constexpr bool kV = kRole & 1, kK = kRole & 2;
  constexpr int kTileB = tile_bytes<D>();
  const int lane = threadIdx.x & 31;
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
    if constexpr (kK) {
      scores<D>(dp, vd, sw128_desc(s + kTileB, 16));
      wgmma_commit();
    }
    wgmma_wait<kK ? 1 : 0>();
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
    if constexpr (kK) {
      wgmma_wait<0>();
      fence_acc(dp);
    }
    // P^T and dS^T as wgmma's A fragments: 16-query step kc is
    // accumulator columns 16 kc .. 16 kc + 15; register pair 8 kc + 2 e
    // is columns 8 (2 kc + e / 2) + 2 (lane % 4) and + 1
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * kc + 2 * e;
        if constexpr (kV) pa[kc][e] = pack_bf16(sc[j], sc[j + 1]);
        if constexpr (kK) {
          const float2 d = *reinterpret_cast<const float2*>(
              dr + 8 * (2 * kc + e / 2) + 2 * (lane & 3));
          da[kc][e] = pack_bf16(sc[j] * (dp[j] - d.x),
                                sc[j + 1] * (dp[j + 1] - d.y));
        }
      }
    wgmma_fence();
    const uint64_t qn = sw128_desc(s, kBox), don = sw128_desc(s + kTileB, kBox);
    if constexpr (kV) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) pv_step<D>(gv, pa[kc], don + 128 * kc);
    }
    if constexpr (kK) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) pv_step<D>(gk, da[kc], qn + 128 * kc);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (kV) fence_acc(gv);
    if constexpr (kK) fence_acc(gk);
    if (lane == 0) mbar_arrive(&empty[st]);
    if (++st == stages) { st = 0; ph ^= 1; }
  }
}

// One CTA: warpgroups 0 .. G - 1 consume (G = dkv_k_tiles<D>()), each
// owning one 64-row key tile of the group (G p, ..., G p + G - 1) of one
// (b, h), whose K and V the producer loads once (past the last tile,
// tile nk - 1 again: never stored); warpgroup G produces. At D = 256 the
// group is one tile and has two CTAs, a role each: role 0 forms dV
// (and is loaded no V), role 1 dK. The producer streams the query tiles
// of the union of the key tiles' `_q_span`s: per stage, its first
// thread copies Q and dO [64, D] by TMA (4-D tensor maps, as k1_fwd) and
// its second warp the tile's 64 lse and 64 delta values with plain loads
// (0 past T), each lane arriving on the stage's full barrier after its
// stores (a head's row of lse starts at b h T floats, which TMA cannot
// read from an address that is not a multiple of 16 bytes). Per query
// tile, a warpgroup, in the transposed score space (its 64 keys on rows,
// the 64 queries on columns):
//   1. S^T = K Q^T and, issued right behind it where dK is formed, dP^T
//      = V dO^T (wgmma m64n64k16 over D, every operand K-major), a
//      commit group each;
//   2. once S^T has retired, P^T = exp2(S^T scale log2e - lse log2e),
//      lse by column from the stage, masked only on an edge tile;
//   3. once dP^T has retired, P^T and dS^T = P^T (dP^T - delta) rounded
//      to bf16 as register A fragments (P^T where dV is formed, dS^T
//      where dK is);
//   4. dV += P^T dO and dK += dS^T Q (dO and Q from the ring N-major,
//      the transpose bit; m64nDk16), one commit group;
//   5. releases the stage once its products have retired.
// dk = scale dK and dv = dV are written in bf16. The first groups,
// whose causal spans are the longest, launch first (at D = 256 both
// roles of a group together, so the second reads Q and dO from L2).
// D = 256, why two CTAs: two consumer warpgroups of one CTA sharing the
// key tile, one a role, each recomputing S^T (five products a query
// tile), spilled 932 bytes: ptxas held that 384-thread kernel to the
// launch's 168 registers a thread despite setmaxnreg 232, as it did a
// two-warpgroup k1_fwd<256>, and a 288-thread form (a producer warp, no
// setmaxnreg) was held to the same 168 and spilled 1012. FlashAttention-
// 3's hdim-256 backward (P^T and dS^T through shared memory behind a
// named barrier, dK^T and dV^T with D as the row dimension split over
// two warpgroups) needs those 384 threads too, and a second pipeline
// and operand layout. Two CTAs of 256 threads do the same five
// products, may use 255 registers, and run the D = 64 and 128 loop with
// a product left out; they read Q and dO twice (the second mostly from
// L2). Shared memory: K and V (64 KB), two (Q, dO) stages (128 KB) and
// their rows, 198,784 of the 232,448 bytes a block may use; a third
// stage does not fit.
template <int D>
__global__ void __launch_bounds__((dkv_k_tiles<D>() + 1) * 128, 1)
    k1_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const float* lse, const float* delta, bf16* dk, bf16* dv,
                  int t, int h, int d, float scale, int causal, int window,
                  int stages) {
  constexpr int kTileB = tile_bytes<D>();
  constexpr int kG = dkv_k_tiles<D>();
  constexpr int kRoles = dkv_roles<D>();
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
  const int bhn = gridDim.x / (ngroups * kRoles);
  const int grp = (int)(blockIdx.x / (bhn * kRoles));
  const int role = (int)(blockIdx.x / bhn) % kRoles;  // D = 256: 1 forms dK
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
      const bool with_v = kRoles == 1 || role == 1;  // dV's role needs none
      mbar_expect_tx(kvfull, kG * (with_v ? 2 : 1) * kTileB);
      for (int g = 0; g < kG; ++g) {
        const int r = min(kG * grp + g, nk - 1) * kTile;
        for (int p = 0; p < D / 64; ++p) {
          unsigned char* s = skv + 2 * g * kTileB + p * kBox;
          tma_load_4d(s, &tm_k, p * 64, hd, r, bi, kvfull);
          if (with_v)
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
    const long long ld = (long long)h * d;  // the caller's d, as in k1_fwd
    const size_t base = (size_t)bi * t * ld + (size_t)hd * d;
    mbar_wait(kvfull, 0);
    if constexpr (kRoles == 1) {
      float gk[D / 2], gv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;
      dkv_tiles<D, 3>(gk, gv, ring, rows, full, empty, kd, vd, jk, key, lo,
                      hi, t, causal, window, sl2, stages);
      store_acc<D>(dk + base, ld, key, t, d, gk, scale);
      store_acc<D>(dv + base, ld, key, t, d, gv, 1.f);
    } else {
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      if (role == 0) {
        dkv_tiles<D, 1>(acc, acc, ring, rows, full, empty, kd, vd, jk, key,
                        lo, hi, t, causal, window, sl2, stages);
        store_acc<D>(dv + base, ld, key, t, d, acc, 1.f);
      } else {
        dkv_tiles<D, 2>(acc, acc, ring, rows, full, empty, kd, vd, jk, key,
                        lo, hi, t, causal, window, sl2, stages);
        store_acc<D>(dk + base, ld, key, t, d, acc, scale);
      }
    }
  }
}

// B * H folds into the grid's first dimension (2**31 - 1 CTAs), so it may
// exceed 65535
bool shape_ok(int b, int t, int h) {
  return b > 0 && t > 0 && h > 0 &&
         (long long)b * h * ((t + kTile - 1) / kTile) <= 2147483647LL;
}

// a head dim the wgmma kernels take: TMA's 16-byte stride rule (d * 2
// bytes), at most the 256 columns of their widest instantiation
bool padded_ok(int d) { return d >= 8 && d <= 256 && d % 8 == 0; }

// a [B, T, H, d] bf16 tensor (f32 where `esz` is 4) read in boxes of
// (128 bytes of d: 64 bf16 or 32 f32 values, 1 head, 64 rows, 1 batch),
// 128-byte swizzled, rows past T and columns past d read as zeros; 0, or
// the negative code of the C interface
int seq_map(CUtensorMap* map, const void* p, int b, int t, int h, int d,
            int esz = 2) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1;
  const cuuint64_t dim[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t,
                             (cuuint64_t)b};
  const cuuint64_t stride[3] = {(cuuint64_t)d * esz, (cuuint64_t)h * d * esz,
                                (cuuint64_t)t * h * d * esz};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / esz), 1, kTile, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, esz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
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
        int b, int t, int h, int d, float scale, int causal, int window,
        int stages, long long smem, void* stream) {
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
  e = seq_map(&tq, q, b, t, h, d);
  if (!e) e = seq_map(&tk, k, b, t, h, d);
  if (!e) e = seq_map(&tv, v, b, t, h, d);
  if (e) return e;
  const int nq = (t + kTile - 1) / kTile;
  k1_fwd_kernel<D><<<(nq + kQT - 1) / kQT * b * h, fwd_threads<D>(), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), t, h, d,
      scale, causal, window, stages);
  return (int)cudaGetLastError();
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const void* lse, void* dq_out, void* delta, int b,
       int t, int h, int d, float scale, int causal, int window, int stages,
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
  e = seq_map(&tq, q, b, t, h, d);
  if (!e) e = seq_map(&tk, k, b, t, h, d);
  if (!e) e = seq_map(&tv, v, b, t, h, d);
  if (!e) e = seq_map(&to, o, b, t, h, d);
  if (!e) e = seq_map(&tdo, dout, b, t, h, d);
  if (e) return e;
  const int nq = (t + kTile - 1) / kTile;
  k1_dq_kernel<D><<<(nq + kG - 1) / kG * b * h, (kG + 1) * 128, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, to, tdo, static_cast<const float*>(lse),
      static_cast<bf16*>(dq_out), static_cast<float*>(delta), t, h, d, scale,
      causal, window, stages);
  return (int)cudaGetLastError();
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int b, int t,
        int h, int d, float scale, int causal, int window, int stages,
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
  e = seq_map(&tq, q, b, t, h, d);
  if (!e) e = seq_map(&tk, k, b, t, h, d);
  if (!e) e = seq_map(&tv, v, b, t, h, d);
  if (!e) e = seq_map(&tdo, dout, b, t, h, d);
  if (e) return e;
  const int nk = (t + kTile - 1) / kTile;
  const long long grid =
      (long long)((nk + kG - 1) / kG) * dkv_roles<D>() * b * h;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  k1_dkv_kernel<D><<<(unsigned)grid, (kG + 1) * 128, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), t, h, d, scale, causal, window, stages);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The f32 forward on the tensor cores (k1f_fwd): k1_fwd's function for
// f32 q, k, v at head dims d from 4 to 64 with d % 4 == 0 (TMA's 16-byte
// rule for a row stride of d * 4 bytes), o in f32, in split TF32
// ("3xTF32"). Plain TF32 keeps 11 significant bits and misses f32's
// tolerance; the split writes each operand x = hi + lo, hi = tf32(x) and
// lo = tf32(x - hi) (both rounded to nearest, `tf32_rna`, so each is an
// exact tf32 value however the tensor cores read an operand's low 13
// bits), and forms a.b ~ hi_a.hi_b + hi_a.lo_b + lo_a.hi_b. Each tf32
// product is exact in the f32 accumulator; what is lost is lo_a.lo_b and
// lo's own rounding, about 2**-22 of |a.b|. The two small products go
// first. `tests/test_torch_flash.py` emulates this arithmetic on the CPU
// against the f32 tolerance (1e-5, 1e-5).
//
// Bound at the training shape (B 8, T 1024, H 12, d 64, causal): three
// tf32 products for each of the 12.9 GFLOP of useful work at 495 TFLOP/s,
// 0.0782 ms, by operations (`chip_smoke.py::k1_bound`).
//
// Design: k1_fwd<64>'s shape (consumer warpgroups each owning a 64-row
// query tile, a producer streaming K and V tiles by TMA through a ring
// of full/empty mbarriers, the union of the spans walked, edge tiles
// masked, the online softmax in base 2 on the accumulators), with:
// - a [64, 64] f32 tile as two 128-byte-swizzled boxes of 32 columns
//   (TMA zero-fills the columns past d, a whole box at d <= 32);
// - tf32 wgmma (m64n64k8), which takes no transpose bit, so both
//   operands are K-major: S = Q K^T as stored, and O += P V with V
//   stored transposed (V^T: keys contiguous);
// - converters, two warps beside the producer's: once a stage's raw K
//   and V have landed, they split K in place (hi) beside a K lo tile and
//   write V^T hi and V^T lo (`transpose_v`), then arrive on the stage's
//   `ready` barrier, which the consumers wait for; each consumer
//   warpgroup splits its own Q tile the same way once;
// - P split in registers. The S accumulator is not a tf32 A fragment: a
//   thread holds keys 2 (lane % 4) and + 1 of each 8-key group, and the
//   A fragment k indices lane % 4 and + 4. So V^T's key slots are
//   permuted within each group of 8 (slot = key / 2 + 4 (key % 2)): the
//   accumulator pair is then the fragment pair, and the sum over keys
//   does not care about their order;
// - each tile's P V into fresh accumulators, folded into O with f32
//   FMAs (O = alpha O + P V), so no sum over more than one tile's 24
//   tensor-core steps runs in an accumulator. The tensor cores' sums are
//   not f32's, and their error grows with the steps summed: with O as
//   the running sum across tiles (FlashAttention's form) o reached the
//   f32 tolerance at T 4096 on the H100, and this form stays an order of
//   magnitude inside it. P V is formed in two halves of 32 columns
//   (m64n32k8), one after the other: with one 64-column accumulator
//   beside O and P's hi and lo fragments (128 registers live) the kernel
//   spilled 68 bytes (both: scripts/torch_k1f_accumulate.py).
// Two query tiles a CTA: Q (hi, lo) of two tiles and two stages of (K,
// K lo, V, V^T hi, V^T lo) take 224 KB of the 227 a block may use. The
// CTA is 352 threads (two consumer warpgroups, the producer warp and two
// converter warps); ptxas gives each thread 168 registers, as it does any
// CTA of 9 to 12 warps (three warps on a quarter of the SM's registers):
// a producer warpgroup with setmaxnreg 216 for the consumers did not
// raise it (84 bytes spilled), as it did not for k1_fwd<256> and
// k1_dkv<256>.
// ---------------------------------------------------------------------------

constexpr int kFQT = 2;                 // query tiles a CTA (F32_Q_TILES)
constexpr int kFTile = kTile * 64 * 4;  // [64, 64] f32: two 8 KB boxes
constexpr int kFStage = 5 * kFTile;     // K (hi), K lo, V, V^T hi, V^T lo
constexpr int kFConvWarps = 2;          // converter warps
constexpr int kFConsumers = kFQT * 128;
constexpr int kFThreads = kFConsumers + 32 * (1 + kFConvWarps);
constexpr int kFMaxD = 64;

// byte offset of f32 element (r, c) in a [rows, 32] box with 128-byte
// rows under the 128-byte swizzle: 16-byte chunk c / 4 of row r sits at
// chunk (c / 4) ^ (r % 8)
__device__ __forceinline__ int sw128_off32(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2);
}

// x becomes hi = tf32(x); returns lo = tf32(x - hi)
__device__ __forceinline__ float split_tf32(float& x) {
  const float hi = tf32_rna(x);
  const float lo = tf32_rna(x - hi);
  x = hi;
  return lo;
}

// a [64, 64] f32 tile (16 KB) split in place into hi, with lo at the same
// offsets of `lo`: 16-byte vectors i0, i0 + step, ...
__device__ __forceinline__ void split_tile(unsigned char* hi,
                                           unsigned char* lo, int i0,
                                           int step) {
  for (int i = i0; i < kFTile / 16; i += step) {
    float4 x = reinterpret_cast<float4*>(hi)[i];
    float4 l;
    l.x = split_tf32(x.x);
    l.y = split_tf32(x.y);
    l.z = split_tf32(x.z);
    l.w = split_tf32(x.w);
    reinterpret_cast<float4*>(hi)[i] = x;
    reinterpret_cast<float4*>(lo)[i] = l;
  }
}

// the raw [64 keys, 64] V tile at v (two boxes of 32 columns) into V^T's
// hi and lo at vh and vl: [64 columns, 64 key slots], K-major, as two
// boxes of 32 slots (keys 32 b .. 32 b + 31 in box b), slot = key / 2 + 4
// (key % 2) within each group of 8 keys. Converter warp w takes the
// 8-key groups kb = w, w + 2, ...: lane 16 par + cq reads keys 8 kb + par
// + 2 i (i < 4) at columns 4 cq .. 4 cq + 3 (16-byte loads, conflict
// free) and writes, for each of those columns, slots 8 (kb % 4) + 4 par
// .. + 3 (16-byte stores)
__device__ __forceinline__ void transpose_v(const unsigned char* v,
                                            unsigned char* vh,
                                            unsigned char* vl, int w,
                                            int lane) {
  const int par = lane >> 4, cq = lane & 15;
  for (int kb = w; kb < kTile / 8; kb += kFConvWarps) {
    float4 x[4];  // key 8 kb + par + 2 i, columns 4 cq ..
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(
          v + (cq >> 3) * kBox + sw128_off32(8 * kb + par + 2 * i, 4 * cq));
    const int s = 8 * (kb & 3) + 4 * par;  // the first slot in its box
    const float4 cols[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                            make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                            make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                            make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int off = (kb >> 2) * kBox + sw128_off32(4 * cq + c, s);
      float4 hi = cols[c], lo;
      lo.x = split_tf32(hi.x);
      lo.y = split_tf32(hi.y);
      lo.z = split_tf32(hi.z);
      lo.w = split_tf32(hi.w);
      *reinterpret_cast<float4*>(vh + off) = hi;
      *reinterpret_cast<float4*>(vl + off) = lo;
    }
  }
}

// One CTA: warpgroups 0 and 1 consume, each owning one 64-row query tile
// of the group (2 p, 2 p + 1) of one (b, h); warp 8 produces: its first
// thread issues every TMA copy (the group's Q tiles once, past the last
// tile tile nq - 1 again; then the raw K and V tiles of the union of the
// tiles' `_k_span`s into a ring of `stages` stages); warps 9 and 10
// convert each stage (split K, V^T hi and lo) and arrive on `ready`. Per
// key tile, a consumer warpgroup:
//   1. S[64, 64] = Q K^T in split tf32: Q hi K lo, Q lo K hi, Q hi K hi,
//      m64n64k8 over d, every operand from shared memory;
//   2. masks S only on an edge tile, and runs k1_fwd's online softmax
//      (base 2, the scale folded in; a row lives on the 4 lanes of a
//      quad), keeping alpha, the factor of the old O;
//   3. for each half of O's 64 columns, PV = P V in split tf32 into a
//      fresh accumulator (P lo V^T hi, P hi V^T lo, P hi V^T hi, P's hi
//      and lo from registers, V^T's from the stage, m64n32k8) and, once
//      it has retired, O = alpha O + PV;
//   4. releases the stage.
// o is written in f32, d columns of each row at stride H d; lse (unless
// null) as k1_fwd's. The last groups, whose causal spans are the
// longest, launch first.
__global__ void __launch_bounds__(kFThreads, 1)
    k1f_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, float* o,
                   float* lse, int t, int h, int d, float scale, int causal,
                   int window, int stages) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sq = smem;                        // per tile: Q (hi), Q lo
  unsigned char* ring = smem + kFQT * 2 * kFTile;  // stages x kFStage
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kFStage);
  uint64_t* ready = full + stages;
  uint64_t* empty = ready + stages;
  uint64_t* qfull = empty + stages;
  const int nq = (t + kTile - 1) / kTile;
  const int ngroups = (nq + kFQT - 1) / kFQT;
  const int bhn = gridDim.x / ngroups;
  const int grp = ngroups - 1 - (int)(blockIdx.x / bhn);
  const int bh = blockIdx.x % bhn, bi = bh / h, hd = bh % h;
  int lo = nq, hi = 0;
  for (int g = 0; g < kFQT; ++g) {
    int a, b;
    k_span(kFQT * grp + g, nq, causal, window, &a, &b);
    lo = min(lo, a);
    hi = max(hi, b);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kFConvWarps);
      mbar_init(&empty[s], kFConsumers / 32);
    }
    mbar_init(qfull, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kFConsumers) {  // ---------------- producer, converters
    const int w = (threadIdx.x - kFConsumers) >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == kFConsumers) {
      mbar_expect_tx(qfull, kFQT * kFTile);
      for (int g = 0; g < kFQT; ++g)
        for (int p = 0; p < 2; ++p)
          tma_load_4d(sq + 2 * g * kFTile + p * kBox, &tm_q, p * 32, hd,
                      min(kFQT * grp + g, nq - 1) * kTile, bi, qfull);
      int st = 0;
      uint32_t ph = 0;
      for (int jk = lo; jk < hi; ++jk) {
        mbar_wait(&empty[st], ph ^ 1);
        unsigned char* s = ring + st * kFStage;
        mbar_expect_tx(&full[st], 2 * kFTile);
        for (int p = 0; p < 2; ++p) {
          tma_load_4d(s + p * kBox, &tm_k, p * 32, hd, jk * kTile, bi,
                      &full[st]);
          tma_load_4d(s + 2 * kFTile + p * kBox, &tm_v, p * 32, hd,
                      jk * kTile, bi, &full[st]);
        }
        if (++st == stages) { st = 0; ph ^= 1; }
      }
    } else if (w > 0) {
      int st = 0;
      uint32_t ph = 0;
      for (int jk = lo; jk < hi; ++jk) {
        mbar_wait(&full[st], ph);
        unsigned char* s = ring + st * kFStage;
        split_tile(s, s + kFTile, threadIdx.x - kFConsumers - 32,
                   32 * kFConvWarps);
        transpose_v(s + 2 * kFTile, s + 3 * kFTile, s + 4 * kFTile, w - 1,
                    lane);
        fence_proxy_async();  // the splits, before the consumers' wgmma
        __syncwarp();
        if (lane == 0) mbar_arrive(&ready[st]);
        if (++st == stages) { st = 0; ph ^= 1; }
      }
    }
  } else {  // ------------------------------------------------ consumers
    const int g = threadIdx.x >> 7;
    const int wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int iq = kFQT * grp + g;
    const int row = iq * kTile + wq * 16 + (lane >> 2);  // and row + 8
    const float sl2 = scale * kLog2e;
    unsigned char* tq = sq + 2 * g * kFTile;
    mbar_wait(qfull, 0);
    split_tile(tq, tq + kFTile, threadIdx.x & 127, 128);
    fence_proxy_async();
    named_bar(1 + g, 128);
    const uint64_t dqh = sw128_desc(tq, 16);
    const uint64_t dql = sw128_desc(tq + kFTile, 16);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
    int st = 0;
    uint32_t ph = 0;
    for (int jk = lo; jk < hi; ++jk) {
      mbar_wait(&ready[st], ph);
      __syncwarp();
      const unsigned char* s = ring + st * kFStage;
      const uint64_t dkh = sw128_desc(s, 16);
      const uint64_t dkl = sw128_desc(s + kFTile, 16);
      const uint64_t dvh = sw128_desc(s + 3 * kFTile, 16);
      const uint64_t dvl = sw128_desc(s + 4 * kFTile, 16);
      // k-step kk: box kk / 4, 32 bytes (8 values) kk % 4 into its rows
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_n64_tf32(sc, dqh + (kk / 4) * (kBox >> 4) + 2 * (kk % 4),
                       dkl + (kk / 4) * (kBox >> 4) + 2 * (kk % 4), kk);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_n64_tf32(sc, dql + (kk / 4) * (kBox >> 4) + 2 * (kk % 4),
                       dkh + (kk / 4) * (kBox >> 4) + 2 * (kk % 4), 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_n64_tf32(sc, dqh + (kk / 4) * (kBox >> 4) + 2 * (kk % 4),
                       dkh + (kk / 4) * (kBox >> 4) + 2 * (kk % 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      // register 4i + 2 half + c: row `row` + 8 half, key 8 i + 2 (lane % 4)
      // + c of the tile
      const bool edge =
          (jk + 1) * kTile > t ||
          (causal && (jk >= iq || (window >= 0 &&
                                   (iq - jk) * kTile + kTile - 1 > window)));
      float alpha[2];
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
        const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
        alpha[half] = exp2f(m[half] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * i + 2 * half + c];
            x = exp2f(x - m_use);
            sum += x;
          }
        l[half] = l[half] * alpha[half] + sum;  // this thread's columns
        m[half] = m_new;
      }
      // P's hi and lo as tf32 A fragments: 8-key step j takes registers
      // 4j, 4j + 2 (keys 2 (lane % 4), rows r and r + 8: k index lane % 4)
      // and 4j + 1, 4j + 3 (keys + 1: k index lane % 4 + 4), which V^T's
      // slot order matches
      uint32_t pa[8][4], pb[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + (e >> 1) + 2 * (e & 1)];
          pb[j][e] = __float_as_uint(split_tf32(x));
          pa[j][e] = __float_as_uint(x);
        }
      // P V in two halves of 32 columns, each into a fresh 16-register
      // accumulator folded into O once it has retired (one 64-column
      // accumulator spilled: ptxas holds this kernel to 168 registers)
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        float pv[16];
        const uint64_t vh = dvh + nh * (32 * 128 >> 4);  // V^T rows 32 nh..
        const uint64_t vl = dvl + nh * (32 * 128 >> 4);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 8; ++j)
          wgmma_n32_tf32_ra(pv, pb[j], vh + (j / 4) * (kBox >> 4) + 2 * (j % 4),
                            j);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          wgmma_n32_tf32_ra(pv, pa[j], vl + (j / 4) * (kBox >> 4) + 2 * (j % 4),
                            1);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          wgmma_n32_tf32_ra(pv, pa[j], vh + (j / 4) * (kBox >> 4) + 2 * (j % 4),
                            1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(pv);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          acc[16 * nh + i] = fmaf(acc[16 * nh + i], alpha[(i >> 1) & 1], pv[i]);
      }
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == stages) { st = 0; ph ^= 1; }
    }
    // o's rows have the caller's stride h d; only its first d columns
    // are written (those past d belong to the next head)
    const long long ld = (long long)h * d;
    float* ob = o + (size_t)bi * t * ld + (size_t)hd * d;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      l[half] = quad_sum(l[half]);
      const float inv = l[half] == 0.f ? 1.f : 1.f / l[half];
      if (r >= t) continue;
      if (lse != nullptr && (lane & 3) == 0)
        lse[(size_t)bh * t + r] = m[half] * kLn2 + logf(l[half]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 8 * i + 2 * (lane & 3);
        if (col < d)
          *reinterpret_cast<float2*>(ob + (size_t)r * ld + col) =
              make_float2(acc[4 * i + 2 * half] * inv,
                          acc[4 * i + 2 * half + 1] * inv);
      }
    }
  }
}

// the dynamic shared memory k1f_fwd's layout needs at `stages` stages:
// two Q tiles with their lo, the ring, 3 stages + 1 mbarriers and 1 KB of
// slack for the 1024-byte alignment (`tf32_smem` rounds the mbarriers up
// to 128 bytes)
long long f32_fwd_smem(int stages) {
  return (long long)(2 * kFQT) * kFTile + (long long)stages * kFStage +
         8 * (3 * stages + 1) + 1024;
}

int f32_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
            int b, int t, int h, int d, float scale, int causal, int window,
            int stages, long long smem, void* stream) {
  if (stages < 2 || stages > kStagesMax || smem < f32_fwd_smem(stages))
    return (int)cudaErrorInvalidValue;
  int e = (int)cudaFuncSetAttribute(
      k1f_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);  // first, as in fwd
  if (e) return e;
  CUtensorMap tq, tk, tv;
  e = seq_map(&tq, q, b, t, h, d, 4);
  if (!e) e = seq_map(&tk, k, b, t, h, d, 4);
  if (!e) e = seq_map(&tv, v, b, t, h, d, 4);
  if (e) return e;
  const int nq = (t + kTile - 1) / kTile;
  k1f_fwd_kernel<<<(nq + kFQT - 1) / kFQT * b * h, kFThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<float*>(o), static_cast<float*>(lse), t, h, d,
      scale, causal, window, stages);
  return (int)cudaGetLastError();
}

// the probe: d[64, 8] = a[64, 8] . b[8, 8]^T (row-major f32, b as [n,
// k]) through one tf32 wgmma (m64n8k8, both operands from shared memory,
// 128-byte swizzled, given as they are): how the tensor cores read the
// low 13 bits of an f32 operand
__global__ void __launch_bounds__(128) k1f_probe_kernel(const float* a,
                                                        const float* b,
                                                        float* d) {
  __shared__ __align__(1024) unsigned char sa[64 * 128];
  __shared__ __align__(1024) unsigned char sb[8 * 128];
  for (int i = threadIdx.x; i < 64 * 32; i += 128)
    *reinterpret_cast<float*>(sa + sw128_off32(i / 32, i % 32)) =
        i % 32 < 8 ? a[(i / 32) * 8 + i % 32] : 0.f;
  for (int i = threadIdx.x; i < 8 * 32; i += 128)
    *reinterpret_cast<float*>(sb + sw128_off32(i / 32, i % 32)) =
        i % 32 < 8 ? b[(i / 32) * 8 + i % 32] : 0.f;
  fence_proxy_async();
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  wgmma_fence();
  wgmma_n8_tf32(acc, sw128_desc(sa, 16), sw128_desc(sb, 16));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  const int lane = threadIdx.x & 31;
  const int r = 16 * (threadIdx.x >> 5) + (lane >> 2), c = 2 * (lane & 3);
  d[r * 8 + c] = acc[0];
  d[r * 8 + c + 1] = acc[1];
  d[(r + 8) * 8 + c] = acc[2];
  d[(r + 8) * 8 + c + 1] = acc[3];
}


// ---------------------------------------------------------------------------
// The SIMT family: the f32 and f16 calls that the wgmma kernels above do
// not take — f32 dq and dkv, the f32 forward at head dims k1f_fwd does
// not take, and all of f16 — at any head dim D from 1 to 256 (the
// reference's kernels take any float dtype and any head dim). The same
// functions as k1_fwd, k1_dq and k1_dkv, in f32 FMA arithmetic (f32
// inputs compute in full f32: no TF32, no rounding of p or ds), one
// simple shape for all three, templated on the input type T and on C >=
// ceil(D / 32), the columns of a row each lane owns (1, 2, 4 or 8). The
// f32 dq and dkv move onto the tensor cores next (split TF32, as
// k1f_fwd).
//
// A CTA is 4 warps and owns 16 rows of one (b, h): query rows for fwd and
// dq, key rows for dkv; each warp owns 4 of them. The other side streams
// through shared memory 32 rows at a time (f32, rows padded to D + 1 so
// lane j reading row j is free of bank conflicts), lane j holding row j:
// a lane computes its row's scores against the warp's 4 own rows (the own
// rows broadcast from shared memory), the warp reduces the softmax
// statistics with shuffles, and each lane accumulates its C columns of
// the warp's 4 output rows, the 32 scores broadcast by shuffles. Causal
// CTAs walk only the other side's rows they can see (and a window's).
// The grid is ceil(T / 16) * B * H CTAs in the first dimension (B * H may
// exceed 65535); fwd and dq launch the last rows first, dkv the first.
// No atomics: results are deterministic.
// ---------------------------------------------------------------------------

constexpr int kSRows = 4;                  // rows a warp owns
constexpr int kSWarps = 4;                 // warps a CTA
constexpr int kSBlock = kSRows * kSWarps;  // rows a CTA owns (SIMT_ROWS)
constexpr int kSKeys = 32;                 // rows a staged tile (SIMT_KEYS)
constexpr int kSThreads = 32 * kSWarps;
constexpr int kSMaxD = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// rows [r0, r0 + n) of head (bi, hd) of a [B, T, H, D] tensor into
// shared rows of `ld` floats; rows past T as zeros
template <typename T>
__device__ __forceinline__ void stage_rows(float* s, int ld, const T* g,
                                           int bi, int hd, int r0, int n,
                                           int t, int h, int d) {
  for (int i = threadIdx.x; i < n * d; i += kSThreads) {
    const int r = i / d, c = i - r * d, row = r0 + r;
    s[r * ld + c] =
        row < t ? to_f32(g[(((size_t)bi * t + row) * h + hd) * d + c]) : 0.f;
  }
}

__device__ __forceinline__ size_t row_at(int bi, int row, int t, int h,
                                         int hd, int d) {
  return (((size_t)bi * t + row) * h + hd) * d;
}

// the key rows [lo, hi) that query rows [q0, q0 + kSBlock) can see
__device__ __forceinline__ void key_range(int q0, int t, int causal,
                                          int window, int* lo, int* hi) {
  *lo = 0;
  *hi = t;
  if (causal) {
    *hi = min(t, q0 + kSBlock);
    if (window >= 0) *lo = max(0, q0 - window);
  }
}

// fwd: o = softmax(s) . v, lse = logsumexp(s), online over key tiles
template <typename T, int C>
__global__ void __launch_bounds__(kSThreads)
    k1s_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o,
                   float* __restrict__ lse, int t, int h, int d, int bhn,
                   float scale, int causal, int window) {
  extern __shared__ float sm[];
  const int ld = d + 1;
  float* sk = sm;                     // [32][ld]
  float* sv = sk + kSKeys * ld;       // [32][ld]
  float* sq = sv + kSKeys * ld;       // [16][d]
  const int ntiles = (t + kSBlock - 1) / kSBlock;
  const int bh = blockIdx.x % bhn;
  const int tile = ntiles - 1 - (int)(blockIdx.x / bhn);
  const int bi = bh / h, hd = bh % h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = tile * kSBlock, r0 = q0 + warp * kSRows;
  const float* qw = sq + warp * kSRows * d;
  stage_rows(sq, d, q, bi, hd, q0, kSBlock, t, h, d);
  int lo, hi;
  key_range(q0, t, causal, window, &lo, &hi);
  float m[kSRows], l[kSRows], acc[kSRows][C];
#pragma unroll
  for (int r = 0; r < kSRows; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  for (int k0 = lo; k0 < hi; k0 += kSKeys) {
    __syncthreads();  // the previous tile is consumed
    stage_rows(sk, ld, k, bi, hd, k0, kSKeys, t, h, d);
    stage_rows(sv, ld, v, bi, hd, k0, kSKeys, t, h, d);
    __syncthreads();
    const int key = k0 + lane;
    const float* kr = sk + lane * ld;
    float s[kSRows];
#pragma unroll
    for (int r = 0; r < kSRows; ++r) s[r] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float kc = kr[c];
#pragma unroll
      for (int r = 0; r < kSRows; ++r) s[r] = fmaf(qw[r * d + c], kc, s[r]);
    }
#pragma unroll
    for (int r = 0; r < kSRows; ++r) {
      const float sr = visible(r0 + r, key, t, causal, window)
                           ? s[r] * scale : -CUDART_INF_F;
      const float mx = warp_max(sr);
      if (mx == -CUDART_INF_F) continue;  // nothing visible: warp-uniform
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);  // 0 while m[r] is -inf
      const float p = expf(sr - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
#pragma unroll 4
      for (int j = 0; j < kSKeys; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        const float* vr = sv + j * ld;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = lane + 32 * c;
          if (col < d) acc[r][c] = fmaf(pj, vr[col], acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kSRows; ++r) {
    const int row = r0 + r;
    if (row >= t) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* orow = o + row_at(bi, row, t, h, hd, d);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      if (col < d) orow[col] = from_f32<T>(acc[r][c] * inv);
    }
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * t + row] = m[r] + logf(l[r]);
  }
}

// dq: delta = rowsum(dO * o); p = exp(s - lse); dq = scale * (p * (dO.v^T
// - delta)) . k
template <typename T, int C>
__global__ void __launch_bounds__(kSThreads)
    k1s_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  T* __restrict__ dq, float* __restrict__ delta, int t, int h,
                  int d, int bhn, float scale, int causal, int window) {
  extern __shared__ float sm[];
  const int ld = d + 1;
  float* sk = sm;                     // [32][ld]
  float* sv = sk + kSKeys * ld;       // [32][ld]
  float* sq = sv + kSKeys * ld;       // [16][d]
  float* sdo = sq + kSBlock * d;      // [16][d]
  const int ntiles = (t + kSBlock - 1) / kSBlock;
  const int bh = blockIdx.x % bhn;
  const int tile = ntiles - 1 - (int)(blockIdx.x / bhn);
  const int bi = bh / h, hd = bh % h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = tile * kSBlock, r0 = q0 + warp * kSRows;
  stage_rows(sq, d, q, bi, hd, q0, kSBlock, t, h, d);
  stage_rows(sdo, d, dout, bi, hd, q0, kSBlock, t, h, d);
  __syncthreads();
  const float* qw = sq + warp * kSRows * d;
  const float* dow = sdo + warp * kSRows * d;
  float dl[kSRows], ls[kSRows];
#pragma unroll
  for (int r = 0; r < kSRows; ++r) {
    const int row = r0 + r;
    float part = 0.f;
    if (row < t) {
      const T* orow = o + row_at(bi, row, t, h, hd, d);
      for (int c = lane; c < d; c += 32)
        part = fmaf(dow[r * d + c], to_f32(orow[c]), part);
    }
    dl[r] = warp_sum(part);
    ls[r] = row < t ? lse[(size_t)bh * t + row] : 0.f;
    if (row < t && lane == 0) delta[(size_t)bh * t + row] = dl[r];
  }
  int lo, hi;
  key_range(q0, t, causal, window, &lo, &hi);
  float acc[kSRows][C];
#pragma unroll
  for (int r = 0; r < kSRows; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  for (int k0 = lo; k0 < hi; k0 += kSKeys) {
    __syncthreads();
    stage_rows(sk, ld, k, bi, hd, k0, kSKeys, t, h, d);
    stage_rows(sv, ld, v, bi, hd, k0, kSKeys, t, h, d);
    __syncthreads();
    const int key = k0 + lane;
    const float* kr = sk + lane * ld;
    const float* vr = sv + lane * ld;
    float s[kSRows], dp[kSRows];
#pragma unroll
    for (int r = 0; r < kSRows; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float kc = kr[c], vc = vr[c];
#pragma unroll
      for (int r = 0; r < kSRows; ++r) {
        s[r] = fmaf(qw[r * d + c], kc, s[r]);
        dp[r] = fmaf(dow[r * d + c], vc, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kSRows; ++r) {
      const float p = visible(r0 + r, key, t, causal, window)
                          ? expf(s[r] * scale - ls[r]) : 0.f;
      const float ds = p * (dp[r] - dl[r]);
#pragma unroll 4
      for (int j = 0; j < kSKeys; ++j) {
        const float dsj = __shfl_sync(kFull, ds, j);
        const float* kj = sk + j * ld;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = lane + 32 * c;
          if (col < d) acc[r][c] = fmaf(dsj, kj[col], acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kSRows; ++r) {
    const int row = r0 + r;
    if (row >= t) continue;
    T* out = dq + row_at(bi, row, t, h, hd, d);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      if (col < d) out[col] = from_f32<T>(scale * acc[r][c]);
    }
  }
}

// dkv, over the CTA's 16 key rows: dv = p^T . dO; dk = scale * (p * (dO.v^T
// - delta))^T . q, the query rows streamed with their lse and delta
template <typename T, int C>
__global__ void __launch_bounds__(kSThreads)
    k1s_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int t, int h, int d, int bhn,
                   float scale, int causal, int window) {
  extern __shared__ float sm[];
  const int ld = d + 1;
  float* sq = sm;                     // [32][ld] query rows
  float* sdo = sq + kSKeys * ld;      // [32][ld] their dO
  float* skr = sdo + kSKeys * ld;     // [16][d] own key rows
  float* svr = skr + kSBlock * d;     // [16][d] their values
  float* sl = svr + kSBlock * d;      // [32] lse of the query rows
  float* sdl = sl + kSKeys;           // [32] delta of the query rows
  const int bh = blockIdx.x % bhn;
  const int tile = (int)(blockIdx.x / bhn);
  const int bi = bh / h, hd = bh % h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = tile * kSBlock, r0 = k0 + warp * kSRows;
  stage_rows(skr, d, k, bi, hd, k0, kSBlock, t, h, d);
  stage_rows(svr, d, v, bi, hd, k0, kSBlock, t, h, d);
  const float* kw = skr + warp * kSRows * d;
  const float* vw = svr + warp * kSRows * d;
  // the query rows [lo, hi) that can see key rows [k0, k0 + kSBlock)
  int lo = 0, hi = t;
  if (causal) {
    lo = k0;
    if (window >= 0) hi = min(t, k0 + kSBlock + window);
  }
  float ak[kSRows][C], av[kSRows][C];
#pragma unroll
  for (int r = 0; r < kSRows; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) ak[r][c] = av[r][c] = 0.f;
  for (int q0 = lo; q0 < hi; q0 += kSKeys) {
    __syncthreads();
    stage_rows(sq, ld, q, bi, hd, q0, kSKeys, t, h, d);
    stage_rows(sdo, ld, dout, bi, hd, q0, kSKeys, t, h, d);
    if (threadIdx.x < kSKeys) {
      const int row = q0 + threadIdx.x;
      sl[threadIdx.x] = row < t ? lse[(size_t)bh * t + row] : 0.f;
      sdl[threadIdx.x] = row < t ? delta[(size_t)bh * t + row] : 0.f;
    }
    __syncthreads();
    const int qrow = q0 + lane;
    const float* qr = sq + lane * ld;
    const float* dor = sdo + lane * ld;
    float s[kSRows], dp[kSRows];
#pragma unroll
    for (int r = 0; r < kSRows; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qc = qr[c], doc = dor[c];
#pragma unroll
      for (int r = 0; r < kSRows; ++r) {
        s[r] = fmaf(kw[r * d + c], qc, s[r]);
        dp[r] = fmaf(vw[r * d + c], doc, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kSRows; ++r) {
      const float p = visible(qrow, r0 + r, t, causal, window)
                          ? expf(s[r] * scale - sl[lane]) : 0.f;
      const float ds = p * (dp[r] - sdl[lane]);
#pragma unroll 4
      for (int j = 0; j < kSKeys; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        const float dsj = __shfl_sync(kFull, ds, j);
        const float* qj = sq + j * ld;
        const float* doj = sdo + j * ld;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = lane + 32 * c;
          if (col < d) {
            av[r][c] = fmaf(pj, doj[col], av[r][c]);
            ak[r][c] = fmaf(dsj, qj[col], ak[r][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kSRows; ++r) {
    const int row = r0 + r;
    if (row >= t) continue;
    T* kout = dk + row_at(bi, row, t, h, hd, d);
    T* vout = dv + row_at(bi, row, t, h, hd, d);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      if (col < d) {
        kout[col] = from_f32<T>(scale * ak[r][c]);
        vout[col] = from_f32<T>(av[r][c]);
      }
    }
  }
}

// the shared memory a SIMT kernel needs, in bytes (`simt_smem`)
long long simt_smem_bytes(int kernel, int d) {
  const long long tile = 2LL * kSKeys * (d + 1);
  const long long own = (kernel == 0 ? 1 : 2) * kSBlock * d;
  return 4 * (tile + own + (kernel == 2 ? 2 * kSKeys : 0));
}

// grid of a SIMT launch; 0 for a shape it does not take
long long simt_grid(int b, int t, int h, int d) {
  if (b <= 0 || t <= 0 || h <= 0 || d < 1 || d > kSMaxD) return 0;
  const long long g = (long long)b * h * ((t + kSBlock - 1) / kSBlock);
  return g <= 2147483647LL ? g : 0;
}

template <typename T, int C>
int simt_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
             int b, int t, int h, int d, float scale, int causal, int window,
             long long smem, cudaStream_t stream) {
  const long long grid = simt_grid(b, t, h, d);
  if (grid == 0 || smem < simt_smem_bytes(0, d))
    return (int)cudaErrorInvalidValue;
  int e = (int)cudaFuncSetAttribute(
      k1s_fwd_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e) return e;
  k1s_fwd_kernel<T, C><<<(unsigned)grid, kSThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t, h, d, b * h, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int simt_dq(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const void* lse, void* dq_out, void* delta,
            int b, int t, int h, int d, float scale, int causal, int window,
            long long smem, cudaStream_t stream) {
  const long long grid = simt_grid(b, t, h, d);
  if (grid == 0 || smem < simt_smem_bytes(1, d))
    return (int)cudaErrorInvalidValue;
  int e = (int)cudaFuncSetAttribute(
      k1s_dq_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e) return e;
  k1s_dq_kernel<T, C><<<(unsigned)grid, kSThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq_out), static_cast<float*>(delta), t, h, d, b * h,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int simt_dkv(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, int b,
             int t, int h, int d, float scale, int causal, int window,
             long long smem, cudaStream_t stream) {
  const long long grid = simt_grid(b, t, h, d);
  if (grid == 0 || smem < simt_smem_bytes(2, d))
    return (int)cudaErrorInvalidValue;
  int e = (int)cudaFuncSetAttribute(
      k1s_dkv_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e) return e;
  k1s_dkv_kernel<T, C><<<(unsigned)grid, kSThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t, h, d, b * h, scale,
      causal, window);
  return (int)cudaGetLastError();
}

// fn<T, C>(args...) for the input type of `dtype` (0 f32, 2 f16; code 1,
// bf16, runs on the wgmma kernels and is refused here) and C = ceil(d /
// 32) rounded up to 1, 2, 4 or 8 (few instantiations: the build time of
// the library)
#define K1S_DISPATCH(fn, dtype, d, ...)                                     \
  do {                                                                      \
    const int c_ = (d) <= 32 ? 1 : (d) <= 64 ? 2 : (d) <= 128 ? 4 : 8;    \
    switch ((dtype) * 16 + c_) {                                            \
      case 1: return fn<float, 1>(__VA_ARGS__);                             \
      case 2: return fn<float, 2>(__VA_ARGS__);                             \
      case 4: return fn<float, 4>(__VA_ARGS__);                             \
      case 8: return fn<float, 8>(__VA_ARGS__);                             \
      case 33: return fn<__half, 1>(__VA_ARGS__);                           \
      case 34: return fn<__half, 2>(__VA_ARGS__);                           \
      case 36: return fn<__half, 4>(__VA_ARGS__);                           \
      case 40: return fn<__half, 8>(__VA_ARGS__);                           \
      default: return (int)cudaErrorInvalidValue;                           \
    }                                                                       \
  } while (0)

}  // namespace

extern "C" {

// o [B, T, H, d] bf16 and, unless lse is null, lse [B*H, T] f32, at
// any d from 8 to 256 with d % 8 == 0 (the kernel of D = 64 up to d 64,
// of D = 128 up to 128, of D = 256 above). window < 0: no window. A CTA
// per group of query tiles of each (b, h) (three at D = 64, two at 128,
// one at 256), each a ring of `stages` K/V stages in `smem` bytes of
// dynamic shared memory (`flash_plan`'s fwd_cta)
int k1_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int t, int h, int d, float scale, int causal, int window,
           int stages, long long smem, void* stream) {
  if (!shape_ok(b, t, h) || !padded_ok(d))
    return (int)cudaErrorInvalidValue;
  if (d <= 64)
    return fwd<64>(q, k, v, o, lse, b, t, h, d, scale, causal, window,
                   stages, smem, stream);
  if (d <= 128)
    return fwd<128>(q, k, v, o, lse, b, t, h, d, scale, causal, window,
                    stages, smem, stream);
  return fwd<256>(q, k, v, o, lse, b, t, h, d, scale, causal, window, stages,
                  smem, stream);
}

// dq [B, T, H, d] bf16 and delta [B*H, T] f32 from the caller's (o, lse),
// at the d k1_fwd takes. A CTA per pair of query tiles of each (b, h)
// (one tile at D = 256), a ring of `stages` K/V stages in `smem` bytes
// (`flash_plan`'s dq_cta)
int k1_dq(const void* q, const void* k, const void* v, const void* o,
          const void* dout, const void* lse, void* dq_out, void* delta, int b,
          int t, int h, int d, float scale, int causal, int window,
          int stages, long long smem, void* stream) {
  if (!shape_ok(b, t, h) || !padded_ok(d))
    return (int)cudaErrorInvalidValue;
  if (d <= 64)
    return dq<64>(q, k, v, o, dout, lse, dq_out, delta, b, t, h, d, scale,
                  causal, window, stages, smem, stream);
  if (d <= 128)
    return dq<128>(q, k, v, o, dout, lse, dq_out, delta, b, t, h, d, scale,
                   causal, window, stages, smem, stream);
  return dq<256>(q, k, v, o, dout, lse, dq_out, delta, b, t, h, d, scale,
                 causal, window, stages, smem, stream);
}

// dk, dv [B, T, H, d] bf16 from lse and the delta of k1_dq, at the d
// k1_fwd takes. A CTA per group of key tiles of each (b, h) (two at D =
// 64, one at D = 128; at D = 256 two CTAs per tile, one forming dv and
// one dk), a ring of `stages` (Q, dO, lse, delta) stages in `smem` bytes
// (`flash_plan`'s dkv_cta)
int k1_dkv(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int b,
           int t, int h, int d, float scale, int causal, int window,
           int stages, long long smem, void* stream) {
  if (!shape_ok(b, t, h) || !padded_ok(d))
    return (int)cudaErrorInvalidValue;
  if (d <= 64)
    return dkv<64>(q, k, v, dout, lse, delta, dk, dv, b, t, h, d, scale,
                   causal, window, stages, smem, stream);
  if (d <= 128)
    return dkv<128>(q, k, v, dout, lse, delta, dk, dv, b, t, h, d, scale,
                    causal, window, stages, smem, stream);
  return dkv<256>(q, k, v, dout, lse, delta, dk, dv, b, t, h, d, scale,
                  causal, window, stages, smem, stream);
}

// the SIMT family: dtype 0 f32, 2 f16 (1, bf16, is refused: it runs on
// the wgmma kernels; the wrappers send the f32 forward at d % 4 == 0 up
// to 64 to k1f_fwd, though this one takes it too); any d from 1 to 256;
// the same operands, layouts and results as k1_fwd, k1_dq and k1_dkv,
// and `smem` bytes of dynamic shared memory (`simt_smem`); a CTA per 16
// rows of each (b, h)
int k1s_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
            void* lse, int b, int t, int h, int d, float scale, int causal,
            int window, long long smem, void* stream) {
  K1S_DISPATCH(simt_fwd, dtype, d, q, k, v, o, lse, b, t, h, d, scale, causal,
               window, smem, static_cast<cudaStream_t>(stream));
}

int k1s_dq(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const void* lse, void* dq_out,
           void* delta, int b, int t, int h, int d, float scale, int causal,
           int window, long long smem, void* stream) {
  K1S_DISPATCH(simt_dq, dtype, d, q, k, v, o, dout, lse, dq_out, delta, b, t,
               h, d, scale, causal, window, smem,
               static_cast<cudaStream_t>(stream));
}

int k1s_dkv(int dtype, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* delta, void* dk,
            void* dv, int b, int t, int h, int d, float scale, int causal,
            int window, long long smem, void* stream) {
  K1S_DISPATCH(simt_dkv, dtype, d, q, k, v, dout, lse, delta, dk, dv, b, t, h,
               d, scale, causal, window, smem,
               static_cast<cudaStream_t>(stream));
}

// the f32 forward on the tensor cores (split TF32): k1_fwd's operands,
// layouts and results for dtype 0 (f32; any other code is refused) at d
// from 4 to 64 with d % 4 == 0; a CTA per pair of query tiles of each
// (b, h), a ring of `stages` stages in `smem` bytes (`flash_plan`'s
// tf32_cta)
int k1f_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
            void* lse, int b, int t, int h, int d, float scale, int causal,
            int window, int stages, long long smem, void* stream) {
  if (dtype != 0 || !shape_ok(b, t, h) || d < 4 || d > kFMaxD || d % 4)
    return (int)cudaErrorInvalidValue;
  return f32_fwd(q, k, v, o, lse, b, t, h, d, scale, causal, window, stages,
                 smem, stream);
}

// d[64, 8] = a[64, 8] . b[8, 8]^T through one tf32 wgmma, the f32
// operands handed to the tensor cores as they are (k1f_probe_kernel)
int k1f_tf32_probe(const void* a, const void* b, void* d, void* stream) {
  k1f_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(d));
  return (int)cudaGetLastError();
}

}  // extern "C"
