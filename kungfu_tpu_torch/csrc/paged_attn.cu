// K3: paged decode attention for one layer, hand-written for Hopper
// (sm_90a). Replaces the Pallas TPU kernels `_res_kernel` and
// `_stream_kernel` of kungfu_tpu/ops/paged_attn.py (the
// `paged_attention` pallas_call).
//
// Function: for each batch row b and head n,
//   s_t = (q[b,n,:] . K[block(b,t), t % bt, n, :]) * d^-0.5   (f32)
//   positions t = 0..lengths[b] INCLUSIVE are visible, the rest are
//   masked with finfo(float32).min;
//   o[b,n,:] = softmax(s) . V   (f32), stored in q's dtype,
// where block(b,t) = block_base + tables[b, t / bt] indexes a pool
// [n_pool_blocks, bt, h, d] (the whole [L, NB+1, ...] pool viewed flat;
// block_base selects the layer without copying it).
//
// Bound on the H100: bytes. A row reads only its visible blocks of K and
// V (length/bt + 1 of them) and does ~4 flops per element read, far
// below the card's ~295 flops/byte balance point. At B=8, h=12, d=64,
// bt=16 and full 1023-token rows one launch must read ~25.2 MB of K and
// V (12.6 MB each), >= ~7.5 us at 3.35 TB/s.
//
// Design (simple and right first; speed is later work):
// - grid (B, h), one CTA of 128 threads per (row, head); the CTA loads
//   its own table row and length (no scalar prefetch on this card) and
//   visits only the row's visible blocks, so the bytes moved follow
//   the length, not max_blocks;
// - loads are 16 bytes a thread; for the scores each thread owns one
//   position (its 8 x 16 B loads are independent, which keeps many
//   loads in flight), for o = w.V each group of d/VEC threads reads one
//   position's V row contiguously;
// - resident scheme (`_res_kernel`): every visible score lives in shared
//   memory (max_blocks*bt f32, 4 KB at max_len 1024), then ONE
//   full-width max / sum-exp / normalise, then o = sum_t w_t v_t;
// - stream scheme (`_stream_kernel`): the online-softmax recurrence at
//   block granularity (m, l, acc rescaled by alpha per pool block,
//   l == 0 -> 1 at the end), with the scores of up to 128 positions
//   fetched per tile so the loads of several blocks overlap; shared
//   memory stays O(bt + d) whatever max_len is;
// - both are templated on float and __nv_bfloat16; all arithmetic is
//   f32 (expf, no fast-math), so the f32 instantiation agrees with the
//   plain PyTorch version to ~1e-6.
//
// C interface (bound with ctypes): k3_paged_attention launches on the
// caller's stream, allocates nothing and returns cudaGetLastError(). The
// caller passes the dynamic shared memory to request: `smem_bytes` in
// kungfu_tpu_torch/ops/paged_attn.py is the one formula for it, and the
// buffers each kernel carves out of `smem` below follow that layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one 16-byte load of VEC consecutive elements, widened to f32
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// CTA-wide reductions; every thread calls them and gets the same value
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();  // `red` may still be read by the previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r += red[w];
  return r;
}

// Everything one CTA needs to find a position's K or V row.
struct Rows {
  const int* tbl;  // this row's block table
  long long base;  // block_base
  long long n_pool_blocks;
  long long blk_stride;  // bt * h * d
  long long tok_stride;  // h * d
  long long head_off;    // head * d
  int bt;

  __device__ __forceinline__ long long offset(int t) const {
    long long blk = base + tbl[t / bt];
    // out-of-range ids clamp, as XLA's gathers do: never a stray read
    blk = blk < 0 ? 0 : (blk >= n_pool_blocks ? n_pool_blocks - 1 : blk);
    return blk * blk_stride + (t % bt) * tok_stride + head_off;
  }
};

template <typename T, int VEC>
__device__ __forceinline__ float score(const T* __restrict__ kp,
                                       const float* q_s, long long off,
                                       int nchunk, float scale) {
  float acc = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    float kv[VEC];
    load_vec<T, VEC>(kp + off + c * VEC, kv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc = fmaf(q_s[c * VEC + i], kv[i], acc);
  }
  return acc * scale;
}

__device__ __forceinline__ int tile_blocks(int bt) {
  return bt >= kThreads ? 1 : kThreads / bt;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k3_resident(const T* __restrict__ q, const T* __restrict__ kp,
                const T* __restrict__ vp, const int* __restrict__ tables,
                const int* __restrict__ lengths, T* __restrict__ out, int H,
                int D, int BT, int max_blocks, long long block_base,
                long long n_pool_blocks, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int b = blockIdx.x, head = blockIdx.y, tid = threadIdx.x;
  const int nchunk = D / VEC;
  const int groups = kThreads / nchunk;
  float* s_buf = smem;                                  // max_blocks*BT
  float* q_s = s_buf + (long long)max_blocks * BT;      // D
  float* part = q_s + D;                                // groups*D
  float* red = part + groups * D;                       // 32
  int* tbl_s = reinterpret_cast<int*>(red + 32);        // max_blocks

  const int length = lengths[b];
  int nvis = length / BT + 1;  // the incoming token sits at `length`
  nvis = nvis > max_blocks ? max_blocks : (nvis < 1 ? 1 : nvis);
  const int ntok = nvis * BT;
  for (int i = tid; i < max_blocks; i += kThreads)
    tbl_s[i] = tables[(long long)b * max_blocks + i];
  const long long qo = ((long long)b * H + head) * D;
  for (int i = tid; i < D; i += kThreads) q_s[i] = to_f32(q[qo + i]);
  __syncthreads();
  const Rows rows{tbl_s, block_base, n_pool_blocks,
                  (long long)BT * H * D, (long long)H * D,
                  (long long)head * D, BT};

  // 1. the score of every visible position, one thread per position
  float mx = kNegInf;
  for (int t = tid; t < ntok; t += kThreads) {
    const float s = t <= length
        ? score<T, VEC>(kp, q_s, rows.offset(t), nchunk, scale)
        : kNegInf;
    s_buf[t] = s;
    mx = fmaxf(mx, s);
  }
  // 2. one full-width softmax: max, exp, sum, normalise
  mx = block_max(mx, red);
  float sum = 0.f;
  for (int t = tid; t < ntok; t += kThreads) {
    const float e = expf(s_buf[t] - mx);
    s_buf[t] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int t = tid; t < ntok; t += kThreads) s_buf[t] = s_buf[t] / sum;
  __syncthreads();

  // 3. o = sum_t w_t v_t: thread (c, g) owns chunk c of positions
  //    t = g, g + groups, ...
  const int c = tid % nchunk, g = tid / nchunk;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (g < groups) {
    for (int t = g; t < ntok; t += groups) {
      const float w = s_buf[t];
      float vv[VEC];
      load_vec<T, VEC>(vp + rows.offset(t) + c * VEC, vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w, vv[i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[g * D + c * VEC + i] = acc[i];
  }
  __syncthreads();
  for (int i = tid; i < D; i += kThreads) {
    float o = 0.f;
    for (int gg = 0; gg < groups; ++gg) o += part[gg * D + i];
    out[qo + i] = from_f32<T>(o);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k3_stream(const T* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const int* __restrict__ tables,
              const int* __restrict__ lengths, T* __restrict__ out, int H,
              int D, int BT, int max_blocks, long long block_base,
              long long n_pool_blocks, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int b = blockIdx.x, head = blockIdx.y, tid = threadIdx.x;
  const int nchunk = D / VEC;
  const int groups = kThreads / nchunk;
  const int tb = tile_blocks(BT);
  float* s_t = smem;                               // tb*BT scores, then p
  float* alpha_s = s_t + tb * BT;                  // tb
  float* q_s = alpha_s + tb;                       // D
  float* part = q_s + D;                           // groups*D
  float* red = part + groups * D;                  // 32 (unused here)
  float* stat = red + 32;                          // 2

  const int length = lengths[b];
  int nvis = length / BT + 1;
  nvis = nvis > max_blocks ? max_blocks : (nvis < 1 ? 1 : nvis);
  const long long qo = ((long long)b * H + head) * D;
  for (int i = tid; i < D; i += kThreads) q_s[i] = to_f32(q[qo + i]);
  __syncthreads();
  // the table row stays in global memory: shared memory is O(bt + d)
  const Rows rows{tables + (long long)b * max_blocks, block_base,
                  n_pool_blocks,
                  (long long)BT * H * D, (long long)H * D,
                  (long long)head * D, BT};

  const int c = tid % nchunk, g = tid / nchunk;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;  // held by warp 0, equal on every lane

  for (int j0 = 0; j0 < nvis; j0 += tb) {
    const int nb = nvis - j0 < tb ? nvis - j0 : tb;
    const int p0 = j0 * BT;
    // the scores of this tile's blocks, one thread per position
    for (int t = tid; t < nb * BT; t += kThreads)
      s_t[t] = p0 + t <= length
          ? score<T, VEC>(kp, q_s, rows.offset(p0 + t), nchunk, scale)
          : kNegInf;
    __syncthreads();
    // the online-softmax recurrence, one pool block after another
    if (tid < 32) {
      for (int jb = 0; jb < nb; ++jb) {
        float* s = s_t + jb * BT;
        float bm = kNegInf;
        for (int i = tid; i < BT; i += 32) bm = fmaxf(bm, s[i]);
        const float m_new = fmaxf(m, warp_max(bm));
        const float alpha = expf(m - m_new);
        float ps = 0.f;
        for (int i = tid; i < BT; i += 32) {
          const float p = expf(s[i] - m_new);
          s[i] = p;
          ps += p;
        }
        l = l * alpha + warp_sum(ps);
        m = m_new;
        if (tid == 0) alpha_s[jb] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + sum_t p_t v_t, block by block
    if (g < groups) {
      for (int jb = 0; jb < nb; ++jb) {
        const float alpha = alpha_s[jb];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
        for (int i = g; i < BT; i += groups) {
          const int t = jb * BT + i;
          const float p = s_t[t];
          float vv[VEC];
          load_vec<T, VEC>(vp + rows.offset(p0 + t) + c * VEC, vv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
        }
      }
    }
    __syncthreads();  // s_t and alpha_s are rewritten by the next tile
  }
  if (tid == 0) stat[0] = l == 0.f ? 1.f : l;
  if (g < groups) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[g * D + c * VEC + i] = acc[i];
  }
  __syncthreads();
  for (int i = tid; i < D; i += kThreads) {
    float o = 0.f;
    for (int gg = 0; gg < groups; ++gg) o += part[gg * D + i];
    out[qo + i] = from_f32<T>(o / stat[0]);
  }
}

template <typename T>
int launch(int scheme, const void* q, const void* kp, const void* vp,
           const void* tables, const void* lengths, void* out, int B, int H,
           int D, int BT, int max_blocks, long long block_base,
           long long n_pool_blocks, float scale, long long smem,
           cudaStream_t stream) {
  auto kernel = scheme == 0 ? k3_resident<T> : k3_stream<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, D, BT,
      max_blocks, block_base, n_pool_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// scheme: 0 resident, 1 stream; dtype: 0 float32, 1 bfloat16.
// smem: dynamic shared memory bytes, from the Python plan's smem_bytes.
int k3_paged_attention(int scheme, int dtype, const void* q, const void* kp,
                       const void* vp, const void* tables,
                       const void* lengths, void* out, int B, int H, int D,
                       int BT, int max_blocks, long long block_base,
                       long long n_pool_blocks, float scale, long long smem,
                       void* stream) {
  if ((scheme != 0 && scheme != 1) || (dtype != 0 && dtype != 1) || smem <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(scheme, q, kp, vp, tables, lengths, out, B, H, D,
                         BT, max_blocks, block_base, n_pool_blocks, scale,
                         smem, s);
  return launch<__nv_bfloat16>(scheme, q, kp, vp, tables, lengths, out, B,
                               H, D, BT, max_blocks, block_base,
                               n_pool_blocks, scale, smem, s);
}

}  // extern "C"
