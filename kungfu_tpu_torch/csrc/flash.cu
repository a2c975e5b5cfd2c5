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
// Design (right and simple first; TMA/wgmma pipelines are later work):
// - FlashAttention-2 tiling: one CTA of 4 warps per (64-row tile, b*h);
//   each warp owns 16 rows of that tile. The other side streams through
//   shared memory in 64-row tiles, staged by 16-byte loads (rows padded
//   by 16 bytes against bank conflicts), with no overlap of loads and
//   products;
// - products are bf16 mma.sync.m16n8k16 with f32 accumulation. The
//   score accumulator's register layout is the A operand's, so p (and
//   ds) become the next product's A fragments in registers without a
//   trip through shared memory;
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
// C interface (bound with ctypes): every function launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
// D must be 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kTile = 64;      // query rows and key rows of a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// shared-memory row stride of a staged [64, D] bf16 tile
template <int D>
__host__ __device__ constexpr int ld_of() { return D + 8; }

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * ld_of<D>() * 2;
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    k1_fwd_kernel(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                  float* lse, int t, int h, float scale, int causal,
                  int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTile * ld_of<D>();
  bf16* sV = sK + kTile * ld_of<D>();
  const int iq = blockIdx.x, bh = blockIdx.y;
  const long long ld = (long long)h * D;
  const size_t base = (size_t)(bh / h) * t * ld + (size_t)(bh % h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = iq * kTile + warp * 16 + (lane >> 2);  // and row + 8
  const float sl2 = scale * kLog2e;
  stage<D>(sQ, q + base, ld, iq * kTile, t);
  int lo, hi;
  k_span(iq, (t + kTile - 1) / kTile, causal, window, &lo, &hi);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int jk = lo; jk < hi; ++jk) {
    __syncthreads();  // the previous tile is consumed
    stage<D>(sK, k + base, ld, jk * kTile, t);
    stage<D>(sV, v + base, ld, jk * kTile, t);
    __syncthreads();
    float s[8][4];
    scores<D>(s, sQ, warp * 16, sK);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = jk * kTile + j * 8 + 2 * (lane & 3) + e;
          float& x = s[j][2 * half + e];
          x = visible(r, key, t, causal, window) ? x * sl2 : -CUDART_INF_F;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[half], quad_max(mx));
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;  // no visible key yet
      const float alpha = exp2f(m[half] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * half + e];
          x = exp2f(x - m_use);
          sum += x;
        }
      l[half] = l[half] * alpha + sum;  // this thread's columns only
      m[half] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * half] *= alpha;
        acc[n][2 * half + 1] *= alpha;
      }
    }
    accumulate<D>(acc, s, sV);
  }
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] = quad_sum(l[half]);
    inv[half] = l[half] == 0.f ? 1.f : 1.f / l[half];
    const int r = row + 8 * half;
    if (lse != nullptr && (lane & 3) == 0 && r < t)
      lse[(size_t)bh * t + r] = m[half] * kLn2 + logf(l[half]);
  }
  store_rows<D>(o + base, ld, row, t, acc, inv[0], inv[1]);
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

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int b, int t, int h, float scale, int causal, int window,
        void* stream) {
  return launch(k1_fwd_kernel<D>, grid_of(b, t, h), 3 * tile_bytes<D>(),
                stream, static_cast<const bf16*>(q),
                static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<bf16*>(o), static_cast<float*>(lse), t, h, scale,
                causal, window);
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
// window < 0: no window
int k1_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int t, int h, int d, float scale, int causal, int window,
           void* stream) {
  if (!shape_ok(b, t, h)) return (int)cudaErrorInvalidValue;
  if (d == 64) return fwd<64>(q, k, v, o, lse, b, t, h, scale, causal, window, stream);
  if (d == 128) return fwd<128>(q, k, v, o, lse, b, t, h, scale, causal, window, stream);
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
