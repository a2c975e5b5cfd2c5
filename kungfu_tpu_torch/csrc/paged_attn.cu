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
// Bound on the H100: bytes, then latency. A row reads only its visible
// blocks of K and V (length/bt + 1 of them) and does ~4 flops per
// element read, far below the card's ~295 flops/byte balance point. At
// B=8, h=12, d=64, bt=16 and full 1023-token rows one launch must read
// ~25.2 MB of K and V (12.6 MB each), >= ~7.5 us at 3.35 TB/s. To get
// near that the card needs bytes in flight on every SM: by Little's law
// ~25 KB per SM at ~1 us of latency. One CTA per (row, head) gave 96 CTAs
// of 4 warps at the serving batch (36 SMs idle), each walking 64 blocks
// alone. Split, each CTA's work is a short chain -- read the length and
// table, copy its tiles, score, exchange with the cluster, combine --
// and at the serving shape that chain of dependent round trips, not the
// bytes, sets the time once the rows are shorter than max_len (PERF.md
// section 6 splits it with benchmarks/kernel_split.py).
//
// Design: split-K (flash-decoding) over a thread-block cluster.
// - Grid (splits, h, B), cluster (splits, 1, 1): the row's max_blocks
//   blocks are cut into `splits` runs of `split_blocks` (from
//   paged_plan: splits <= 8, the portable cluster), one CTA of 128
//   threads each, so the serving shape launches 8 x 12 x 8 = 768 CTAs,
//   all resident at once (~22 KB of shared memory and 64-72 registers a
//   thread). A CTA whose run starts past the row's visible blocks loads
//   nothing and joins the cluster's barriers with m = finfo.min, l = 0,
//   acc = 0.
// - Bytes in flight: every thread issues independent 16-byte
//   cp.async.cg copies of K and V rows into a ring of `ring` shared
//   tiles (`tile_blocks` pool blocks, ~8 KB of K or V each), the next
//   tile's copies issued as soon as a slot frees; a tile's V is in
//   flight while its scores and softmax run. Plain cp.async and not TMA:
//   a (block, head) tile is only bt x d (2 KB at the serving shape), and
//   a tensor map would have to be encoded on the host at every launch of
//   a decode step that is already host-bound. Larger rings or tiles
//   (all of a split in flight at once) cost occupancy and were slower on
//   the card. The row's table entries are read once into a shared window
//   beside q and the length, and thread (c, g) copies chunk c of
//   positions g, g + groups, ... advancing block, token and chunk without
//   a division: the copy loop had been the CTA's longest instruction
//   stream. The copies rotate each row's 16-byte chunks by the row
//   index, so the one-position-per-thread score reads hit distinct banks.
// - Every warp works: a thread owns one position for the score and the
//   same (c, g) walk for o += p v; reductions are CTA-wide.
// - resident (`_res_kernel`): the slice's scores stay in shared memory
//   (split_blocks * bt f32, 512 B at max_len 1024); the cluster forms
//   the exact global max M (each CTA reads the others' maxima through
//   distributed shared memory), then e = exp(s - M) and the global sum
//   L (summed in rank order by every CTA, so all hold the same bits),
//   then w = e / L and each CTA's partial sum_t w_t v_t: the functional
//   path's one full-width softmax, spread over the cluster;
// - stream (`_stream_kernel`): the online-softmax recurrence over the
//   CTA's own tiles (m, l, acc rescaled by alpha per tile); shared
//   memory stays O(bt + d) whatever max_len is;
// - combine: rank 0 reads every CTA's partial through distributed
//   shared memory after a cluster barrier and writes o, summing in rank
//   order (stream: rescaled by exp(m_i - M), l == 0 divides by 1). No
//   atomics, so a second launch gives the same bits. A cluster barrier
//   before exit keeps each CTA's shared memory alive for rank 0; the
//   resident scheme adds two for M and L. Remote reads are issued all at
//   once (one latency a step), and there are no remote accesses or
//   cluster fences inside a loop.
// - both are templated on float and __nv_bfloat16; all arithmetic is
//   f32 (expf, no fast-math), so the f32 instantiation agrees with the
//   plain PyTorch version to ~1e-6.
//
// C interface (bound with ctypes): k3_paged_attention launches on the
// caller's stream with cudaLaunchKernelEx, allocates nothing and returns
// the launch's error (cudaErrorInvalidValue for a plan it cannot run).
// The caller passes the plan (splits, split_blocks, tile_blocks, ring)
// and the dynamic shared memory to request: `smem_bytes` in
// kungfu_tpu_torch/ops/paged_attn.py is the one formula for it, the
// buffers each kernel carves out of `smem` below follow that layout,
// and the launcher refuses a request smaller than the layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;  // CTAs of a cluster (portable)
constexpr int kMaxRing = 4;
constexpr int kWindow = kThreads;  // table entries held in shared memory
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

// ----------------------------------------------------------- K3 kernels

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

// one 16-byte shared-memory load of VEC consecutive elements, widened
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
}

// 16 bytes global -> shared, asynchronous, cached in L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// this thread's copies are done but for its `pending` newest groups
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else if (pending == 2)
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;" ::: "memory");
}

// the f32 at `p`'s offset in the shared memory of cluster CTA `rank`
// (no memory clobber: unrolled callers keep several in flight; the
// cluster barriers before them order them)
__device__ __forceinline__ float remote_f32(const float* p, uint32_t rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(dsmem_addr(p, rank)));
  return v;
}

// the f32 at `p`'s offset in every CTA of an n-CTA cluster, into v[0..n)
// (the rest `fill`), all loads in flight at once
__device__ __forceinline__ void remote_all(const float* p, int n, float fill,
                                           float (&v)[kMaxSplits]) {
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r)
    v[r] = r < n ? remote_f32(p, (uint32_t)r) : fill;
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

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const int* tables;
  const int* lengths;
  void* out;
  int H, D, BT, max_blocks, split_blocks, tile_blocks, ring;
  long long block_base, n_pool_blocks;
  float scale;
};

// Shared memory of one CTA: the ring (ring x tile x D elements of T),
// q (D f32), the cluster exchange (m, l, 2 unused, then the D partial
// outputs), the group partials (groups x D), reduction scratch (32), the
// scores (s_len f32) and a window of kWindow table entries (int32) --
// smem_bytes' terms, ordered so that q and the exchange are 16-byte
// aligned.
struct Layout {
  int nchunk, groups, tile, s_len;
  long long ring_elems;

  __device__ __forceinline__ Layout(const Args& a, int vec, bool resident) {
    nchunk = a.D / vec;
    groups = kThreads / nchunk;
    tile = a.tile_blocks * a.BT;
    s_len = resident ? a.split_blocks * a.BT : tile;
    ring_elems = (long long)a.ring * tile * a.D;
  }
};

// One CTA: split `blockIdx.x` (its cluster rank) of row blockIdx.z's
// blocks for head blockIdx.y.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads) k3_split(const Args a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rank = blockIdx.x, nsplit = gridDim.x;
  const int head = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int D = a.D, BT = a.BT;
  const Layout lay(a, VEC, kResident);
  const int nchunk = lay.nchunk, groups = lay.groups, P = lay.tile;
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(ring + lay.ring_elems);
  float* xchg = q_s + D;
  float* part = xchg + 4 + D;
  float* red = part + groups * D;
  float* s_buf = red + 32;
  int* tbl_s = reinterpret_cast<int*>(s_buf + lay.s_len);

  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);
  const int* tbl = a.tables + (long long)b * a.max_blocks;
  const int length = a.lengths[b];
  int nvis = length / BT + 1;  // the incoming token sits at `length`
  nvis = nvis > a.max_blocks ? a.max_blocks : (nvis < 1 ? 1 : nvis);
  const int j0 = rank * a.split_blocks;
  const int j1 = j0 + a.split_blocks < nvis ? j0 + a.split_blocks : nvis;
  const int nblk = j1 > j0 ? j1 - j0 : 0;
  const int ntiles = (nblk + a.tile_blocks - 1) / a.tile_blocks;
  const int n_items = 2 * ntiles;  // a K and a V copy per tile
  const long long tok_stride = (long long)a.H * D;
  const long long head_off = (long long)head * D;

  const long long qo = ((long long)b * a.H + head) * D;
  for (int i = tid; i < D; i += kThreads)
    q_s[i] = to_f32(static_cast<const T*>(a.q)[qo + i]);
  // table entries [w0, w0 + kWindow) of the row, in shared memory, so the
  // copies compute their addresses without a global load each; the
  // first window is read beside q and the length
  const int jend = j0 + a.split_blocks < a.max_blocks ? j0 + a.split_blocks
                                                       : a.max_blocks;
  int w0 = j0;
  auto fill = [&]() {
    for (int i = tid; i < kWindow && w0 + i < jend; i += kThreads)
      tbl_s[i] = tbl[w0 + i];
  };
  fill();
  __syncthreads();

  // item i of the ring: resident K tiles 0..n-1 then V tiles 0..n-1;
  // stream K0, V0, K1, V1, ... Row r's chunk c lands at chunk
  // (c + r) % nchunk of its shared row.
  auto item_tile = [&](int i) { return kResident ? i % ntiles : i >> 1; };
  auto item_is_v = [&](int i) { return kResident ? i >= ntiles : (i & 1); };
  auto slot = [&](int i) { return ring + (long long)(i % a.ring) * P * D; };
  auto tile_len = [&](int tile) {
    const int p0 = (j0 + tile * a.tile_blocks) * BT;
    return j1 * BT - p0 < P ? j1 * BT - p0 : P;
  };
  // Thread (c, g) copies (and later weighs) chunk c of the tile's
  // positions g, g + groups, ...: the walk's block, token and rotated
  // chunk advance without a division per copy.
  const int c = tid % nchunk, g = tid / nchunk;
  const int rot0 = (c + g) % nchunk, rot_step = groups % nchunk;
  const int blk0 = g / BT, tok0 = g % BT;
  const int blk_step = groups / BT, tok_step = groups % BT;
  const long long blk_stride = (long long)BT * tok_stride;
  // called by every thread at once (it may refill the window)
  auto issue = [&](int i) {
    const int tile = item_tile(i);
    const T* src = item_is_v(i) ? vp : kp;
    T* dst = slot(i);
    const int jt = j0 + tile * a.tile_blocks;
    const int p0 = jt * BT;
    const int np = tile_len(tile);
    if (jt < w0 || jt + (np + BT - 1) / BT > w0 + kWindow) {
      __syncthreads();  // every thread is done with the old window
      w0 = jt;
      fill();
      __syncthreads();
    }
    if (g < groups) {
      const T* from = src + head_off + c * VEC;
      const int* ids = tbl_s + (jt - w0);
      int blk = blk0, tok = tok0, rot = rot0;
      for (int pos = g; pos < np; pos += groups) {
        long long id = a.block_base + ids[blk];
        // out-of-range ids clamp, as XLA's gathers do: never a stray read
        id = id < 0 ? 0 : (id >= a.n_pool_blocks ? a.n_pool_blocks - 1 : id);
        cp_async16(dst + pos * D + rot * VEC,
                   from + id * blk_stride + tok * tok_stride);
        blk += blk_step;
        tok += tok_step;
        if (tok >= BT) {
          tok -= BT;
          ++blk;
        }
        rot += rot_step;
        if (rot >= nchunk) rot -= nchunk;
      }
    }
    cp_async_commit();  // one group per item, empty or not
  };
  int issued = 0;
  for (; issued < n_items && issued < a.ring; ++issued) issue(issued);
  // before item i is used: this thread's copies of it are done, every
  // thread's are visible, and item i - 1's slot is free for item
  // i - 1 + ring
  auto arrive = [&](int i) {
    cp_async_wait(issued - i - 1);
    __syncthreads();
    if (i > 0 && issued < n_items) issue(issued++);
  };

  // the score of row `pos` of K tile `k` (rotated chunks)
  auto score = [&](const T* k, int pos) {
    float acc = 0.f;
    int cr = pos % nchunk;
    const T* row = k + pos * D;
    for (int cc = 0; cc < nchunk; ++cc) {
      float kv[VEC];
      load_vec<T, VEC>(row + cr * VEC, kv);
      const float4* q4 = reinterpret_cast<const float4*>(q_s + cc * VEC);
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i) {
        const float4 qv = q4[i];
        acc = fmaf(qv.x, kv[4 * i], acc);
        acc = fmaf(qv.y, kv[4 * i + 1], acc);
        acc = fmaf(qv.z, kv[4 * i + 2], acc);
        acc = fmaf(qv.w, kv[4 * i + 3], acc);
      }
      cr = cr + 1 == nchunk ? 0 : cr + 1;
    }
    return acc * a.scale;
  };
  // acc += sum_pos w[pos] v[pos] over this thread's positions of V tile
  // `v`: thread (c, g) owns chunk c of positions g, g + groups, ...
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  auto weigh = [&](const T* v, const float* w, int np) {
    if (g >= groups) return;
    int rot = rot0;
    for (int pos = g; pos < np; pos += groups) {
      const float wt = w[pos];
      float vv[VEC];
      load_vec<T, VEC>(v + pos * D + rot * VEC, vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wt, vv[i], acc[i]);
      rot += rot_step;
      if (rot >= nchunk) rot -= nchunk;
    }
  };

  float m = kNegInf, l = 0.f;
  if (kResident) {
    // 1. the slice's scores, kept in s_buf
    float mx = kNegInf;
    for (int i = 0; i < ntiles; ++i) {
      arrive(i);
      const T* k = slot(i);
      const int p0 = (j0 + i * a.tile_blocks) * BT, np = tile_len(i);
      for (int pos = tid; pos < np; pos += kThreads) {
        const float s = p0 + pos <= length ? score(k, pos) : kNegInf;
        s_buf[i * P + pos] = s;
        mx = fmaxf(mx, s);
      }
    }
    // 2. the cluster's exact global max, before any exponent
    mx = block_max(mx, red);
    if (tid == 0) xchg[0] = mx;
    cluster_sync();
    float v[kMaxSplits];
    remote_all(xchg, nsplit, kNegInf, v);
    float big = v[0];
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r) big = fmaxf(big, v[r]);
    // 3. e = exp(s - M), the slice's sum, the cluster's sum in rank order
    const int ns = nblk * BT;
    float es = 0.f;
    for (int pos = tid; pos < ns; pos += kThreads) {
      const float e = expf(s_buf[pos] - big);
      s_buf[pos] = e;
      es += e;
    }
    es = block_sum(es, red);
    if (tid == 0) xchg[1] = es;
    cluster_sync();
    remote_all(xchg + 1, nsplit, 0.f, v);
    float total = v[0];  // in rank order, the same bits in every CTA
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r)
      if (r < nsplit) total += v[r];
    // 4. w = e / L, then the partial sum_t w_t v_t
    for (int pos = tid; pos < ns; pos += kThreads)
      s_buf[pos] = s_buf[pos] / total;
    for (int i = 0; i < ntiles; ++i) {
      arrive(ntiles + i);
      weigh(slot(ntiles + i), s_buf + i * P, tile_len(i));
    }
  } else {
    for (int i = 0; i < ntiles; ++i) {
      arrive(2 * i);  // K tile i (its V tile is in flight)
      const T* k = slot(2 * i);
      const int p0 = (j0 + i * a.tile_blocks) * BT, np = tile_len(i);
      float mx = kNegInf;
      for (int pos = tid; pos < np; pos += kThreads) {
        const float s = p0 + pos <= length ? score(k, pos) : kNegInf;
        s_buf[pos] = s;
        mx = fmaxf(mx, s);
      }
      mx = block_max(mx, red);
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      float ps = 0.f;
      for (int pos = tid; pos < np; pos += kThreads) {
        const float p = expf(s_buf[pos] - m_new);
        s_buf[pos] = p;
        ps += p;
      }
      ps = block_sum(ps, red);  // its barriers also publish s_buf
      l = l * alpha + ps;
      m = m_new;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
      arrive(2 * i + 1);  // V tile i
      weigh(slot(2 * i + 1), s_buf, np);
    }
  }

  // this CTA's partial output: the groups' sums, into the exchange
  if (g < groups) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[g * D + c * VEC + i] = acc[i];
  }
  __syncthreads();
  for (int i = tid; i < D; i += kThreads) {
    float o = 0.f;
    for (int gg = 0; gg < groups; ++gg) o += part[gg * D + i];
    xchg[4 + i] = o;
  }
  if (!kResident && tid == 0) {
    xchg[0] = m;
    xchg[1] = l;
  }
  cluster_sync();
  if (rank == 0) {
    T* out = static_cast<T*>(a.out);
    float f[kMaxSplits], v[kMaxSplits];
    float total = 1.f;
    if (!kResident) {  // each partial's rescale exp(m_r - M), and L
      remote_all(xchg, nsplit, kNegInf, f);
      float big = f[0];
#pragma unroll
      for (int r = 1; r < kMaxSplits; ++r) big = fmaxf(big, f[r]);
      remote_all(xchg + 1, nsplit, 0.f, v);
      total = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        f[r] = r < nsplit ? expf(f[r] - big) : 0.f;
        if (r < nsplit) total += v[r] * f[r];
      }
      if (total == 0.f) total = 1.f;
    }
    for (int i = tid; i < D; i += kThreads) {
      remote_all(xchg + 4 + i, nsplit, 0.f, v);
      float o = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        if (r < nsplit) o += kResident ? v[r] : v[r] * f[r];
      out[qo + i] = from_f32<T>(kResident ? o : o / total);
    }
  }
  cluster_sync();  // no CTA leaves while rank 0 may still read it
}

// ------------------------------------------------------------- launcher

// the bytes the kernel's Layout carves (smem_bytes' formula)
long long layout_bytes(int scheme, int isz, int D, int BT, int split_blocks,
                       int tile_blocks, int ring) {
  const long long tile = (long long)tile_blocks * BT;
  const long long groups = kThreads / (D / (16 / isz));
  const long long scores = scheme == 0 ? (long long)split_blocks * BT : tile;
  const long long words = scores + D + groups * D + 32 + 4 + D + kWindow;
  return ring * tile * D * isz + 4 * words;
}

template <typename T>
int launch(int scheme, const Args& a, int B, int splits, long long smem,
           cudaStream_t stream) {
  auto kernel = scheme == 0 ? k3_split<T, true> : k3_split<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.H, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int e = (int)cudaLaunchKernelEx(&cfg, kernel, a);
  if (e) return e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// scheme: 0 resident, 1 stream; dtype: 0 float32, 1 bfloat16.
// splits, split_blocks, tile_blocks, ring: the Python plan's; smem: its
// smem_bytes. Returns cudaErrorInvalidValue for a plan the kernel
// cannot run (more splits than a portable cluster, splits that do not
// cover max_blocks, an empty split at full length, a tile over the table
// window, a ring over 4, or less shared memory than the layout needs).
int k3_paged_attention(int scheme, int dtype, const void* q, const void* kp,
                       const void* vp, const void* tables,
                       const void* lengths, void* out, int B, int H, int D,
                       int BT, int max_blocks, int splits, int split_blocks,
                       int tile_blocks, int ring, long long block_base,
                       long long n_pool_blocks, float scale, long long smem,
                       void* stream) {
  const int isz = dtype == 0 ? 4 : 2;
  if ((scheme != 0 && scheme != 1) || (dtype != 0 && dtype != 1) ||
      B <= 0 || H <= 0 || BT <= 0 || max_blocks <= 0 || D <= 0 ||
      D % (16 / isz) || D / (16 / isz) > kThreads || splits <= 0 ||
      splits > kMaxSplits || split_blocks <= 0 ||
      (long long)splits * split_blocks < max_blocks ||
      (long long)(splits - 1) * split_blocks >= max_blocks ||
      tile_blocks <= 0 || tile_blocks > split_blocks ||
      tile_blocks > kWindow || ring <= 0 ||
      ring > kMaxRing ||
      smem < layout_bytes(scheme, isz, D, BT, split_blocks, tile_blocks,
                          ring))
    return (int)cudaErrorInvalidValue;
  const Args a{q,  kp, vp, static_cast<const int*>(tables),
               static_cast<const int*>(lengths), out, H, D, BT, max_blocks,
               split_blocks, tile_blocks, ring, block_base, n_pool_blocks,
               scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(scheme, a, B, splits, smem, s);
  return launch<__nv_bfloat16>(scheme, a, B, splits, smem, s);
}

}  // extern "C"
