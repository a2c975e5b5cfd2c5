// K2: fused projection head + softmax cross-entropy, hand-written for
// Hopper (sm_90a). Replaces the Pallas TPU kernels of
// kungfu_tpu/ops/fused_ce.py:
//   k2_fwd         <- `_fwd_common` / `_fwd_kernel_nores` (`_fwd_pallas`)
//   k2_residual_d  <- `_bwd_kernel` (`_residual_d_pallas`)
//   k2_dw          <- `_dw_kernel` (`_dw_pallas`)
//   k2_dx          <- `_dx_kernel` (`_dx_pallas`)
//
// Function, over padded operands x [n_pad, h] bf16, W [h, v_pad] bf16,
// b [v_pad] f32 (padded columns carry -1e30), t [n_pad] int32 (-1 marks a
// padded row; t >= v_pad a valid row whose target is in another vocab
// shard), lse [n_pad] f32 and the scalar g/N at `scale`:
//   logits = x.W + b                  (bf16 products, f32 accumulation)
//   fwd:   lse = logsumexp_v(logits), tl = logits[t] (0 when t misses),
//          and, with a residual, bf16(logits)
//   d      = (exp(logits - lse) - onehot(t)) * (t >= 0 ? g/N : 0)
//   residual_d: d from the bf16 residual, bf16, over the residual in
//          place; db = column sums of the f32 d
//   dw:    dW = x^T bf16(d) (f32 accumulation, stored bf16); db as above
//   dx:    dx = bf16(d) W^T (f32 accumulation, stored bf16)
//
// Bound on the H100: fwd, dw and dx are compute-bound (2 n h v flops per
// logits pass, three passes for dw + dx together, against ~295 flops a
// byte at the balance point); residual_d is bytes-bound (it reads and
// writes the [n_pad, v_pad] bf16 residual once: 2 x 824 MB at GPT-2-small
// training shape).
//
// Design (simple and right first; wgmma/TMA pipelines are later work):
// - tensor cores through nvcuda::wmma (bf16 m16n16k16, f32 accumulators);
//   every logits tile is x-block . W-tile over the WHOLE hidden size, with
//   both operands staged in shared memory by 16-byte loads (rows padded by
//   16 bytes against bank conflicts), one 16x16 output tile per warp, its
//   k sweep over two independent accumulators;
//   the same routine (`logits_tile`) rebuilds the logits in all three
//   GEMM kernels, so the recompute backward sees the forward's logits;
// - fwd: one CTA per (64-row block, vocab split). The TPU kernel runs its
//   online logsumexp over ALL of V in one sequential grid sweep; here the
//   vocab is split over gridDim.y (about four CTAs per SM) and each split
//   keeps (max, sum-exp, target logit) per row in registers (one lane per
//   vocab column of a 32-wide tile, warp shuffles for the row reductions);
//   a combine pass (k2_fwd_combine, same launch call) merges the splits;
// - residual_d: one CTA per 128-column strip walks all rows, 16-byte
//   loads and stores, four rows in flight per thread; d goes back over
//   the residual in place (no second [n_pad, v_pad] buffer), db is the
//   CTA's column sums (deterministic, no atomics);
// - dw: the TPU kernel keeps an [h, bv] f32 accumulator in VMEM (3 MB at
//   bv 1024). Here one CTA owns a 32-column vocab strip, keeps its W strip
//   resident and walks all 64-row x blocks; the [768, 32] f32 dW
//   accumulator lives in registers (12 wmma fragments per warp, 8 warps).
//   A larger h splits the accumulator over gridDim.y (chunks of 768 rows),
//   each CTA rebuilding the logits it needs;
// - dx: one CTA owns 32 rows and walks all 64-column W tiles; the
//   [32, 768] f32 dx accumulator lives in registers the same way;
// - padded vocab columns: their bias -1e30 makes exp(logit - lse) exactly
//   0, so they add nothing to the sums, d or db's meaning.
//
// Shared memory: the wrapper passes the byte offsets of each buffer and
// the total from the Python plan (`smem_layout` in
// kungfu_tpu_torch/ops/fused_ce.py, the one formula); the row strides are
// h + 8 (x), bv + 8 (W, d) and bv + 4 (f32 logits tile). dw and dx stage
// their output through the f32 logits tile once the sweep is done (eight
// 16x16 warp tiles fit in it), which keeps h = 1024 inside 227 KB.
//
// C interface (bound with ctypes): every function launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdBM = 64, kFwdBV = 32;
constexpr int kDwBM = 64, kDwBV = 32;
constexpr int kDxBM = 32, kDxBV = 64;
constexpr int kHChunk = 768;   // gradient rows/cols a dw/dx CTA holds
constexpr int kFragMax = 12;   // accumulator fragments per warp
constexpr int kRdCols = 128;   // vocab columns of one residual_d CTA
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

static_assert((kHChunk / 16) * (kDwBV / 16) == kFragMax * kWarps,
              "dw accumulator tiles must fill kFragMax per warp");
static_assert((kDxBM / 16) * (kHChunk / 16) == kFragMax * kWarps,
              "dx accumulator tiles must fill kFragMax per warp");
static_assert(kDwBM * (kDwBV + 4) >= kWarps * 256 &&
                  kDxBM * (kDxBV + 4) >= kWarps * 256,
              "the logits tile must hold the eight warps' output tiles");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows x cols bf16 (cols a multiple of 8) from global memory (row stride
// lds) into shared memory (row stride ldd), 16 bytes a thread
__device__ __forceinline__ void stage(bf16* dst, int ldd, const bf16* src,
                                      long long lds, int rows, int cols) {
  const int vpr = cols >> 3;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i - r * vpr) << 3;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * lds + c);
  }
}

// sS[BM][BV] (f32, row stride lds) = sX[BM][h] . sW[h][BV], one 16x16
// output tile per warp at a time, its k sweep split over two independent
// accumulators (even and odd 16-wide k steps) so consecutive mma_syncs
// do not wait on each other; the bias is added by the caller
template <int BM, int BV>
__device__ __forceinline__ void logits_tile(const bf16* sX, int ldx,
                                            const bf16* sW, int ldw, int h,
                                            float* sS, int lds) {
  constexpr int kTc = BV / 16;
  constexpr int kTiles = (BM / 16) * kTc;
  const int warp = threadIdx.x >> 5;
  for (int tile = warp; tile < kTiles; tile += kWarps) {
    const int tr = tile / kTc;
    const int tc = tile - tr * kTc;
    FragC acc0, acc1;
    wmma::fill_fragment(acc0, 0.f);
    wmma::fill_fragment(acc1, 0.f);
    const bf16* a = sX + (size_t)tr * 16 * ldx;
    const bf16* bm = sW + tc * 16;
    int k = 0;
    for (; k + 32 <= h; k += 32) {
      FragA fa0, fa1;
      FragB fb0, fb1;
      wmma::load_matrix_sync(fa0, a + k, ldx);
      wmma::load_matrix_sync(fb0, bm + (size_t)k * ldw, ldw);
      wmma::load_matrix_sync(fa1, a + k + 16, ldx);
      wmma::load_matrix_sync(fb1, bm + (size_t)(k + 16) * ldw, ldw);
      wmma::mma_sync(acc0, fa0, fb0, acc0);
      wmma::mma_sync(acc1, fa1, fb1, acc1);
    }
    if (k < h) {  // h / 16 odd: one step left
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, a + k, ldx);
      wmma::load_matrix_sync(fb, bm + (size_t)k * ldw, ldw);
      wmma::mma_sync(acc0, fa, fb, acc0);
    }
#pragma unroll
    for (int i = 0; i < acc0.num_elements; ++i) acc0.x[i] += acc1.x[i];
    wmma::store_matrix_sync(sS + (size_t)tr * 16 * lds + tc * 16, acc0, lds,
                            wmma::mem_row_major);
  }
}

// d over the [BM, BV] logits tile in sS (bias not yet added) at rows
// n0.., vocab columns v0..: f32 d back into sS, bf16 d into sD
template <int BM, int BV>
__device__ __forceinline__ void form_d(float* sS, int lds, bf16* sD, int ldd,
                                       const float* b, const int* t,
                                       const float* lse, float g, int n0,
                                       int v0) {
  for (int e = threadIdx.x; e < BM * BV; e += kThreads) {
    const int r = e / BV;
    const int c = e - r * BV;
    const int tr = t[n0 + r];
    const float p = expf(sS[r * lds + c] + b[v0 + c] - lse[n0 + r]);
    const float d = (p - (tr == v0 + c ? 1.f : 0.f)) * (tr >= 0 ? g : 0.f);
    sS[r * lds + c] = d;
    sD[r * ldd + c] = __float2bfloat16(d);
  }
}

// ---------------------------------------------------------------- K2a
__global__ void __launch_bounds__(kThreads)
k2_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
              const float* __restrict__ b, const int* __restrict__ t,
              bf16* __restrict__ logits, float* __restrict__ part,
              int n_pad, int h, int v_pad, int tiles_per_split,
              long long off_w, long long off_s) {
  constexpr int BM = kFwdBM, BV = kFwdBV, kRows = BM / kWarps;
  static_assert(BV == 32, "one lane per vocab column of a tile");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sW = reinterpret_cast<bf16*>(smem + off_w);
  float* sS = reinterpret_cast<float*>(smem + off_s);
  const int ldx = h + 8, ldw = BV + 8, lds = BV + 4;
  const int n0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int jt0 = split * tiles_per_split;
  const int jt1 = min(jt0 + tiles_per_split, v_pad / BV);

  stage(sX, ldx, x + (size_t)n0 * h, h, BM, h);
  float m[kRows], s[kRows], tl[kRows];
  int trow[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    s[i] = 0.f;
    tl[i] = 0.f;
    trow[i] = t[n0 + warp * kRows + i];
  }
  for (int jt = jt0; jt < jt1; ++jt) {
    const int v0 = jt * BV;
    __syncthreads();  // the previous tile's sW and sS are consumed
    stage(sW, ldw, w + v0, v_pad, h, BV);
    __syncthreads();
    logits_tile<BM, BV>(sX, ldx, sW, ldw, h, sS, lds);
    __syncthreads();
    const float bias = b[v0 + lane];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp * kRows + i;
      const float val = sS[r * lds + lane] + bias;
      if (logits != nullptr)
        logits[(size_t)(n0 + r) * v_pad + v0 + lane] = __float2bfloat16(val);
      const float m_new = fmaxf(m[i], warp_max(val));
      s[i] = s[i] * expf(m[i] - m_new) + warp_sum(expf(val - m_new));
      m[i] = m_new;
      if (trow[i] - v0 == lane) tl[i] += val;  // -1 and >= v_pad never hit
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float tsum = warp_sum(tl[i]);
    if (lane == 0) {
      const int n = n0 + warp * kRows + i;
      part[(size_t)(split * 3 + 0) * n_pad + n] = m[i];
      part[(size_t)(split * 3 + 1) * n_pad + n] = s[i];
      part[(size_t)(split * 3 + 2) * n_pad + n] = tsum;
    }
  }
}

// merges the vocab splits' (max, sum-exp, target logit) of each row
__global__ void __launch_bounds__(kThreads)
k2_fwd_combine(const float* __restrict__ part, int splits, int n_pad,
               float* __restrict__ lse, float* __restrict__ tl) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= n_pad) return;
  float mx = kNegInf;
  for (int k = 0; k < splits; ++k)
    mx = fmaxf(mx, part[(size_t)(k * 3) * n_pad + n]);
  float s = 0.f, tsum = 0.f;
  for (int k = 0; k < splits; ++k) {
    s += part[(size_t)(k * 3 + 1) * n_pad + n] *
         expf(part[(size_t)(k * 3) * n_pad + n] - mx);
    tsum += part[(size_t)(k * 3 + 2) * n_pad + n];
  }
  lse[n] = mx + logf(s);
  tl[n] = tsum;
}

// ---------------------------------------------------------------- K2b
__global__ void __launch_bounds__(kThreads)
k2_residual_d_kernel(const float* __restrict__ scale, bf16* logits,
                     const float* __restrict__ lse, const int* __restrict__ t,
                     float* __restrict__ db, int n_pad, int v_pad) {
  constexpr int kVec = 8;                  // bf16 per 16-byte access
  constexpr int kTx = kRdCols / kVec;      // threads along a row strip
  constexpr int kTy = kThreads / kTx;      // rows per pass
  constexpr int kUnroll = 4;               // rows in flight per thread
  __shared__ float red[kTy][kRdCols];
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int c = blockIdx.x * kRdCols + tx * kVec;
  const float g = *scale;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  for (int r0 = ty; r0 < n_pad; r0 += kTy * kUnroll) {
    uint4 raw[kUnroll];
    float l[kUnroll];
    int tt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kTy;
      if (r < n_pad) {
        raw[u] = *reinterpret_cast<const uint4*>(logits + (size_t)r * v_pad + c);
        l[u] = lse[r];
        tt[u] = t[r];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kTy;
      if (r < n_pad) {
        const bf16* e = reinterpret_cast<const bf16*>(&raw[u]);
        const float sc = tt[u] >= 0 ? g : 0.f;
        uint4 out;
        bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float p = expf(__bfloat162float(e[i]) - l[u]);
          const float d = (p - (tt[u] == c + i ? 1.f : 0.f)) * sc;
          acc[i] += d;
          o[i] = __float2bfloat16(d);
        }
        *reinterpret_cast<uint4*>(logits + (size_t)r * v_pad + c) = out;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) red[ty][tx * kVec + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < kRdCols) {
    float sum = 0.f;
    for (int y = 0; y < kTy; ++y) sum += red[y][threadIdx.x];
    db[blockIdx.x * kRdCols + threadIdx.x] = sum;
  }
}

// write one warp's 16x16 f32 accumulator tile as bf16 at out (row stride
// ld), through the warp's 256-float scratch
__device__ __forceinline__ void store_bf16_tile(const FragC& acc, float* scr,
                                                bf16* out, long long ld) {
  const int lane = threadIdx.x & 31;
  wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32)
    out[(size_t)(e >> 4) * ld + (e & 15)] = __float2bfloat16(scr[e]);
  __syncwarp();
}

// ---------------------------------------------------------------- K2c
__global__ void __launch_bounds__(kThreads, 1)
k2_dw_kernel(const float* __restrict__ scale, const bf16* __restrict__ x,
             const bf16* __restrict__ w, const float* __restrict__ b,
             const int* __restrict__ t, const float* __restrict__ lse,
             bf16* __restrict__ dw, float* __restrict__ db, int n_pad, int h,
             int v_pad, long long off_w, long long off_s, long long off_d) {
  constexpr int BM = kDwBM, BV = kDwBV, kTc = BV / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sW = reinterpret_cast<bf16*>(smem + off_w);
  float* sS = reinterpret_cast<float*>(smem + off_s);
  bf16* sD = reinterpret_cast<bf16*>(smem + off_d);
  const int ldx = h + 8, ldw = BV + 8, lds = BV + 4, ldd = BV + 8;
  const int warp = threadIdx.x >> 5;
  const int v0 = blockIdx.x * BV;
  const int h_lo = blockIdx.y * kHChunk;
  const int n_tiles = (min(kHChunk, h - h_lo) / 16) * kTc;
  const float g = *scale;

  stage(sW, ldw, w + v0, v_pad, h, BV);  // resident for the whole sweep
  FragC acc[kFragMax];
#pragma unroll
  for (int i = 0; i < kFragMax; ++i) wmma::fill_fragment(acc[i], 0.f);
  float dbacc = 0.f;
  for (int n0 = 0; n0 < n_pad; n0 += BM) {
    __syncthreads();  // the previous block's sX, sS and sD are consumed
    stage(sX, ldx, x + (size_t)n0 * h, h, BM, h);
    __syncthreads();
    logits_tile<BM, BV>(sX, ldx, sW, ldw, h, sS, lds);
    __syncthreads();
    form_d<BM, BV>(sS, lds, sD, ldd, b, t, lse, g, n0, v0);
    __syncthreads();
    if (threadIdx.x < BV)
      for (int r = 0; r < BM; ++r) dbacc += sS[r * lds + threadIdx.x];
#pragma unroll
    for (int i = 0; i < kFragMax; ++i) {
      const int tile = warp + i * kWarps;
      if (tile < n_tiles) {
        const int th = tile / kTc, tc = tile - (tile / kTc) * kTc;
#pragma unroll
        for (int k = 0; k < BM; k += 16) {
          FragAT fa;  // x^T: element (h, n) at sX[n * ldx + h]
          FragB fb;
          wmma::load_matrix_sync(fa, sX + (size_t)k * ldx + h_lo + th * 16, ldx);
          wmma::load_matrix_sync(fb, sD + (size_t)k * ldd + tc * 16, ldd);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
  }
  __syncthreads();  // sS (read for db) becomes the output staging
#pragma unroll
  for (int i = 0; i < kFragMax; ++i) {
    const int tile = warp + i * kWarps;
    if (tile < n_tiles) {
      const int th = tile / kTc, tc = tile - (tile / kTc) * kTc;
      store_bf16_tile(acc[i], sS + warp * 256,
                      dw + (size_t)(h_lo + th * 16) * v_pad + v0 + tc * 16,
                      v_pad);
    }
  }
  if (blockIdx.y == 0 && threadIdx.x < BV) db[v0 + threadIdx.x] = dbacc;
}

// ---------------------------------------------------------------- K2d
__global__ void __launch_bounds__(kThreads, 1)
k2_dx_kernel(const float* __restrict__ scale, const bf16* __restrict__ x,
             const bf16* __restrict__ w, const float* __restrict__ b,
             const int* __restrict__ t, const float* __restrict__ lse,
             bf16* __restrict__ dx, int n_pad, int h, int v_pad,
             long long off_w, long long off_s, long long off_d) {
  constexpr int BM = kDxBM, BV = kDxBV;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sW = reinterpret_cast<bf16*>(smem + off_w);
  float* sS = reinterpret_cast<float*>(smem + off_s);
  bf16* sD = reinterpret_cast<bf16*>(smem + off_d);
  const int ldx = h + 8, ldw = BV + 8, lds = BV + 4, ldd = BV + 8;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * BM;
  const int h_lo = blockIdx.y * kHChunk;
  const int th_n = min(kHChunk, h - h_lo) / 16;  // hidden tiles of this CTA
  const int n_tiles = (BM / 16) * th_n;
  const float g = *scale;

  stage(sX, ldx, x + (size_t)n0 * h, h, BM, h);  // resident for the sweep
  FragC acc[kFragMax];
#pragma unroll
  for (int i = 0; i < kFragMax; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int v0 = 0; v0 < v_pad; v0 += BV) {
    __syncthreads();  // the previous tile's sW, sS and sD are consumed
    stage(sW, ldw, w + v0, v_pad, h, BV);
    __syncthreads();
    logits_tile<BM, BV>(sX, ldx, sW, ldw, h, sS, lds);
    __syncthreads();
    form_d<BM, BV>(sS, lds, sD, ldd, b, t, lse, g, n0, v0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFragMax; ++i) {
      const int tile = warp + i * kWarps;
      if (tile < n_tiles) {
        const int tr = tile / th_n, tc = tile - (tile / th_n) * th_n;
#pragma unroll
        for (int k = 0; k < BV; k += 16) {
          FragA fa;
          FragBT fb;  // W^T: element (v, h) at sW[h * ldw + v]
          wmma::load_matrix_sync(fa, sD + (size_t)tr * 16 * ldd + k, ldd);
          wmma::load_matrix_sync(fb, sW + (size_t)(h_lo + tc * 16) * ldw + k, ldw);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
  }
  __syncthreads();  // sS becomes the output staging
#pragma unroll
  for (int i = 0; i < kFragMax; ++i) {
    const int tile = warp + i * kWarps;
    if (tile < n_tiles) {
      const int tr = tile / th_n, tc = tile - (tile / th_n) * th_n;
      store_bf16_tile(acc[i], sS + warp * 256,
                      dx + (size_t)(n0 + tr * 16) * h + h_lo + tc * 16, h);
    }
  }
}

template <typename K>
int set_smem(K kernel, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool shape_ok(int n_pad, int h, int v_pad) {
  return n_pad > 0 && h > 0 && v_pad > 0 && h % 16 == 0 && n_pad % 128 == 0 &&
         v_pad % 128 == 0;
}

}  // namespace

extern "C" {

// (logits | null, lse, tl) of padded operands; part is [splits, 3, n_pad]
// f32 scratch for the per-split row state
int k2_fwd(const void* x, const void* w, const void* b, const void* t,
           void* logits, void* part, void* lse, void* tl, int n_pad, int h,
           int v_pad, int splits, int tiles_per_split, long long smem,
           long long off_w, long long off_s, void* stream) {
  if (!shape_ok(n_pad, h, v_pad) || splits <= 0 || tiles_per_split <= 0 ||
      (long long)splits * tiles_per_split < v_pad / kFwdBV)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = set_smem(k2_fwd_kernel, smem);
  if (e) return e;
  k2_fwd_kernel<<<dim3(n_pad / kFwdBM, splits), kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const int*>(t),
      static_cast<bf16*>(logits), static_cast<float*>(part), n_pad, h, v_pad,
      tiles_per_split, off_w, off_s);
  e = (int)cudaGetLastError();
  if (e) return e;
  k2_fwd_combine<<<(n_pad + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(part), splits, n_pad,
      static_cast<float*>(lse), static_cast<float*>(tl));
  return (int)cudaGetLastError();
}

// d over `logits` in place, db [v_pad]
int k2_residual_d(const void* scale, void* logits, const void* lse,
                  const void* t, void* db, int n_pad, int v_pad,
                  void* stream) {
  if (!shape_ok(n_pad, 16, v_pad)) return (int)cudaErrorInvalidValue;
  k2_residual_d_kernel<<<v_pad / kRdCols, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scale), static_cast<bf16*>(logits),
      static_cast<const float*>(lse), static_cast<const int*>(t),
      static_cast<float*>(db), n_pad, v_pad);
  return (int)cudaGetLastError();
}

// dw [h, v_pad] bf16 and db [v_pad] f32 of the recompute scheme
int k2_dw(const void* scale, const void* x, const void* w, const void* b,
          const void* t, const void* lse, void* dw, void* db, int n_pad,
          int h, int v_pad, long long smem, long long off_w, long long off_s,
          long long off_d, void* stream) {
  if (!shape_ok(n_pad, h, v_pad)) return (int)cudaErrorInvalidValue;
  const int e = set_smem(k2_dw_kernel, smem);
  if (e) return e;
  const dim3 grid(v_pad / kDwBV, (h + kHChunk - 1) / kHChunk);
  k2_dw_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scale), static_cast<const bf16*>(x),
      static_cast<const bf16*>(w), static_cast<const float*>(b),
      static_cast<const int*>(t), static_cast<const float*>(lse),
      static_cast<bf16*>(dw), static_cast<float*>(db), n_pad, h, v_pad, off_w,
      off_s, off_d);
  return (int)cudaGetLastError();
}

// dx [n_pad, h] bf16 of the recompute scheme
int k2_dx(const void* scale, const void* x, const void* w, const void* b,
          const void* t, const void* lse, void* dx, int n_pad, int h,
          int v_pad, long long smem, long long off_w, long long off_s,
          long long off_d, void* stream) {
  if (!shape_ok(n_pad, h, v_pad)) return (int)cudaErrorInvalidValue;
  const int e = set_smem(k2_dx_kernel, smem);
  if (e) return e;
  const dim3 grid(n_pad / kDxBM, (h + kHChunk - 1) / kHChunk);
  k2_dx_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scale), static_cast<const bf16*>(x),
      static_cast<const bf16*>(w), static_cast<const float*>(b),
      static_cast<const int*>(t), static_cast<const float*>(lse),
      static_cast<bf16*>(dx), n_pad, h, v_pad, off_w, off_s, off_d);
  return (int)cudaGetLastError();
}

}  // extern "C"
