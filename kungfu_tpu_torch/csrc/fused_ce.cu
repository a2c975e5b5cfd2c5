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
// Bound on the H100 (chip_smoke.py `k2_bound`): fwd, dw and dx are
// compute-bound (2 n h v flops per logits pass; dw and dx add one
// product each: at GPT-2-small training shape n_pad 8192, h 768, v_pad
// 50304, fwd 0.64 ms and dw 1.28 ms at 989 TFLOP/s); residual_d is
// bytes-bound (it reads and writes the [n_pad, v_pad] bf16 residual
// once: 2 x 824 MB).
//
// fwd, dw and dx: TMA-fed wgmma pipelines. One CTA is three warpgroups:
// warpgroups 0 and 1 consume (setmaxnreg 232), warpgroup 2 produces
// (setmaxnreg 40; one thread issues every copy). Operands move only by
// TMA (cp.async.bulk.tensor, 128-byte swizzle, a CUtensorMap per
// operand encoded by the launcher for the call's pointers and passed as
// a __grid_constant__ parameter) into a ring of K chunks in shared
// memory, each stage guarded by a full and an empty mbarrier; the
// consumers never stage through registers. h need not fit in shared
// memory: TMA zero-fills a K chunk past h (h % 64 != 0), and those zeros
// add nothing. The tensor cores run wgmma.mma_async m64nNk16 (bf16 in,
// f32 accumulators in registers) straight from the swizzled tiles: x is
// K-major; W [h, v] is N-major (the transpose bit on B). The launch plan
// (stages, grid, h chunks, shared-memory offsets) comes from the Python
// plan `fused_ce_plan` / `smem_layout` in kungfu_tpu_torch/ops/fused_ce.py.
//
// - fwd (K2a) -- the parent kernel's bottlenecks and what this design
//   does about them:
//   * synchronous 16-byte staging between two __syncthreads, no copy
//     overlapping math: the ring (4 stages of x [128, 64] + W [64, 128],
//     32 KB each) keeps up to 4 K chunks in flight while the consumers
//     multiply; a consumer releases a stage as soon as the wgmma group
//     that read it has retired (wait_group 1);
//   * one 170 KB CTA of 8 warps per SM with nothing hiding latency: the
//     CTA is persistent (grid = min(#SMs, items)), and the producer runs
//     ahead across work items, so the next item's loads overlap this
//     item's epilogue;
//   * wmma reloading both fragments from shared memory for every
//     16x16x16 product: each consumer warpgroup issues m64n128k16 on its
//     64 rows of a 128 x 128 logits tile (64 accumulators a thread);
//   * an epilogue through an f32 tile in shared memory with 10 shuffles
//     per row per 32 columns: the bias, the tile's row max, sum-exp and
//     target logit are formed on the accumulator registers (a row lives
//     on 4 threads: two quad shuffles per reduction, once per 128-column
//     tile); with the residual, bf16 logits go through a swizzled
//     [64, 64] shared tile per half-tile and a TMA store;
//   * W (77 MB, above the 50 MB L2) re-read by each of 128 64-row blocks:
//     rows come in blocks of BM = 128, and the work walk puts the row
//     block fastest (item i: row block i % n_blocks, vocab tile
//     i / n_blocks), so the 132 resident CTAs share two or three W tiles
//     at a time from L2 and W leaves HBM about once; the L2 -> SM traffic
//     is 64 x 77 MB of W plus 393 x 12.6 MB of x, 9.9 GB at the training
//     shape.
//   Each (row block, vocab tile) item writes its rows' (max, sum-exp,
//   tl) partials to `part` [v_pad / 128, 3, n_pad] (no [n_pad, v_pad] f32
//   scratch); k2_fwd_combine merges them.
// - dw (K2c): one CTA owns a 64-column vocab strip and a chunk of h
//   (tiles_per_chunk 64-row tiles, at most 6), keeps the W strip [h, 64]
//   resident (one TMA per 64-row chunk, 96 KB at h 768) and walks all
//   128-row blocks. For each block it runs, in this order, without a
//   round trip through global memory:
//     1. logits [128, 64] = x-block . W-strip with wgmma (each consumer
//        warpgroup its 64 rows, m64n64k16 over the h chunks of the ring);
//     2. d on the accumulator registers: exp(l + b - lse), the one-hot
//        and the (t >= 0) g/N factor;
//     3. db summed on the same registers (three xor shuffles over the
//        row lanes per block, each lane keeping two columns; at the end
//        one shared reduction over the 8 warps, in a fixed order:
//        deterministic);
//     4. bf16 d into a swizzled [128, 64] shared tile;
//     5. dW[h chunk, strip] += x^T . d with a second wgmma (m64n64k16,
//        transpose bits on A = x^T and B = d), each warpgroup up to three
//        64-row h tiles (96 f32 accumulators a thread).
//   The x chunks of the CTA's own h range come last in the block's K walk
//   and stay in the ring until step 5 has read them (the ring has at
//   least one stage more than the chunk has tiles, so the producer never
//   waits on a chunk that is still to be consumed): x is read once per
//   block for both products. The strip width is traded against the
//   recompute: the dW accumulator [h chunk, 64] must fit the consumers'
//   registers, so at h 768 two chunks of 384 rows recompute the logits
//   twice. Cost at the training shape: x re-reads from L2 of (v_pad / 64)
//   x (h / 384) x 12.6 MB = 19.8 GB, and 2 + 1 products of 2 n h v
//   flops = 1.9 TFLOP (1.92 ms at 989 TFLOP/s). dW and db are written
//   once per element, with no atomics: bitwise the same on every launch.
//   The parent kernel's bottlenecks: 1572 one-CTA-per-SM strips walking
//   every row block with synchronous restaging of the whole x block
//   (19.8 GB), rebuilding logits with wmma, forming d element by element
//   through shared memory, summing db with 32 threads and updating dW
//   with fragments reloaded every k step, each step behind a
//   __syncthreads; here copies run ahead through the ring, both
//   products run on wgmma, d and db come off the accumulators.
// - residual_d: one CTA per 128-column strip walks all rows, 16-byte
//   loads and stores, four rows in flight per thread; d goes back over
//   the residual in place (no second [n_pad, v_pad] buffer), db is the
//   CTA's column sums (deterministic, no atomics);
// - dx (K2d): a cluster split-K pipeline (kernel comment below). dx for
//   a 128-row block at h 768 is [128, 768] f32, 384 KB, more than an SM's
//   registers, and keeping that x block resident beside a ring does not
//   fit shared memory either; so the h chunks of one row block (at most
//   three 64-wide tiles each: 96 dx accumulators a thread beside the 32
//   of the partial logits) form a thread-block cluster. Each CTA
//   multiplies its resident x chunk by a W tile [chunk, 64] from the ring
//   into partial logits; the cluster sums the partials in distributed
//   shared memory, each CTA forming d on its share of the rows and
//   sending bf16 d to every CTA; the same W tile then serves as B of
//   dx += d W^T. The tensor work is the bound's 2 x 2 n h v (no logits
//   are recomputed), and W passes through each CTA once (64 x 77 MB =
//   4.9 GB of L2 traffic at the training shape). The parent, a wmma
//   kernel with one CTA per 32 rows, restaged the whole W tile with
//   synchronous loads every vocab step (19.8 GB) and ran four
//   __syncthreads-separated phases with no overlap. What costs time now
//   is the exchange: 32 KB of partials and 16 KB of d cross the cluster
//   per CTA and vocab step, behind two cluster round trips
//   (`benchmarks/kernel_split.py` times the kernel without it).
// - padded vocab columns: their bias -1e30 makes exp(logit - lse) exactly
//   0, so they add nothing to the sums, d or db's meaning.
//
// The PTX building blocks (mbarriers, TMA, wgmma, clusters) are in
// hopper.cuh, shared with flash.cu.
//
// Shared memory: the wrapper passes the byte offsets of each buffer and
// the total from the Python plan (`smem_layout`, the one formula). The
// pipelined kernels round their dynamic shared memory up to a 1024-byte
// boundary (the 128-byte swizzle repeats every 1024 bytes, and TMA and
// wgmma both apply it to address bits), for which the total holds 1 KB
// of slack.
//
// libcuda's cuTensorMapEncodeTiled is looked up once through the runtime
// (hopper.cuh `encoder`), so the library needs no -lcuda.
//
// C interface (bound with ctypes): every function launches on the
// caller's stream, allocates nothing and returns cudaGetLastError(), or
// a negative code when a tensor map cannot be encoded (-1: the encoder
// was not found; -1000 - CUresult: it refused the operand).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRdCols = 128;   // vocab columns of one residual_d CTA
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

// the TMA/wgmma pipelines (fwd, dw, dx)
constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kPipeThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBM = 128;                 // rows of a block (64 a warpgroup)
constexpr int kKC = 64;                  // K chunk: one 128-byte swizzle row
constexpr int kFwdBN = 128;              // vocab columns of a fwd tile
constexpr int kDwBN = 64;                // vocab columns of a dw strip
constexpr int kDwTilesMax = 6;           // 64-row h tiles of a dw chunk
constexpr int kDxBV = 64;                // vocab columns of a dx step
constexpr int kDxTilesMax = 3;           // 64-wide h tiles of a dx chunk
constexpr int kDxClusterMax = 8;         // CTAs of a dx cluster (portable)
constexpr int kXChunk = kBM * kKC * 2;   // x [128, 64] bf16: 16 KB
constexpr int kWBox = kKC * 64 * 2;      // W [64, 64] bf16: 8 KB
constexpr int kFwdStage = kXChunk + 2 * kWBox;  // 32 KB
constexpr int kOutTile = 2 * 64 * 64 * 2;       // a warpgroup's bf16 logits
constexpr int kDTile = kBM * kDxBV * 2;  // a bf16 d tile [128, 64]: 16 KB
constexpr int kMaxStages = 8;

// ---------------------------------------------------------------- K2a
// Persistent CTAs walk (row block, vocab tile) items: item i is row block
// i % n_blocks and vocab tile i / n_blocks (`fwd_work` in the Python plan
// lists the same walk). Shared memory, from 1024-byte-aligned base:
// `stages` ring stages of kFwdStage bytes (x [128, 64] then the two W
// boxes [64 k, 64 v]), the two warpgroups' logits staging tiles at
// off_out, and the full/empty mbarriers at off_bar.
__global__ void __launch_bounds__(kPipeThreads, 1)
k2_fwd_kernel(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w,
              const __grid_constant__ CUtensorMap tm_l,
              const float* __restrict__ b, const int* __restrict__ t,
              float* __restrict__ part, int residual, int n_pad, int h,
              int v_pad, int stages, long long off_out, long long off_bar) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + off_bar);
  uint64_t* empty = full + stages;
  const int n_blocks = n_pad / kBM;
  const int n_items = n_blocks * (v_pad / kFwdBN);
  const int kt = (h + kKC - 1) / kKC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // ------------------------ producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) {
      int st = 0;
      uint32_t ph = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int rb = item % n_blocks, vt = item / n_blocks;
        for (int kc = 0; kc < kt; ++kc) {
          mbar_wait(&empty[st], ph ^ 1);
          unsigned char* s = smem + (size_t)st * kFwdStage;
          mbar_expect_tx(&full[st], kFwdStage);
          tma_load(s, &tm_x, kc * kKC, rb * kBM, &full[st]);
          tma_load(s + kXChunk, &tm_w, vt * kFwdBN, kc * kKC, &full[st]);
          tma_load(s + kXChunk + kWBox, &tm_w, vt * kFwdBN + 64, kc * kKC,
                   &full[st]);
          if (++st == stages) { st = 0; ph ^= 1; }
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int g = threadIdx.x >> 7;          // warpgroup: rows 64 g..
    const int ctid = threadIdx.x & 127;
    const int wq = ctid >> 5, lane = threadIdx.x & 31;
    unsigned char* out = smem + off_out + g * kOutTile;
    const int rl = wq * 16 + (lane >> 2);    // the thread's rows rl, rl + 8
    int st = 0;
    uint32_t ph = 0;
    float acc[64];
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int rb = item % n_blocks, vt = item / n_blocks;
      int prev = 0;
      for (int kc = 0; kc < kt; ++kc) {
        mbar_wait(&full[st], ph);
        __syncwarp();  // the wgmma below are warp-aligned
        const unsigned char* s = smem + (size_t)st * kFwdStage;
        const uint64_t da = sw128_desc(s + g * (kXChunk / 2), 16);
        const uint64_t dw = sw128_desc(s + kXChunk, kWBox);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk)
          wgmma_n128<0, 1>(acc, da + 2 * kk, dw + 128 * kk, kc | kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's products have retired
        if (kc > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = st;
        if (++st == stages) { st = 0; ph ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue on the accumulators: register 4i + 2j + c holds row
      // rl + 8 j, column 8 i + 2 (lane % 4) + c of the warpgroup's tile
      const int row0 = rb * kBM + g * 64 + rl;
      const int t0 = __ldg(t + row0), t1 = __ldg(t + row0 + 8);
      const int cb = vt * kFwdBN + 2 * (lane & 3);
      float m0 = kNegInf, m1 = kNegInf, tl0 = 0.f, tl1 = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = cb + 8 * i;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b + c));
        acc[4 * i] += bb.x;
        acc[4 * i + 1] += bb.y;
        acc[4 * i + 2] += bb.x;
        acc[4 * i + 3] += bb.y;
        m0 = fmaxf(m0, fmaxf(acc[4 * i], acc[4 * i + 1]));
        m1 = fmaxf(m1, fmaxf(acc[4 * i + 2], acc[4 * i + 3]));
        // -1 and targets >= v_pad never hit
        tl0 += (t0 == c ? acc[4 * i] : 0.f) + (t0 == c + 1 ? acc[4 * i + 1] : 0.f);
        tl1 += (t1 == c ? acc[4 * i + 2] : 0.f) +
               (t1 == c + 1 ? acc[4 * i + 3] : 0.f);
      }
      if (residual) {
        if (ctid == 0) bulk_wait_read();  // the last item's store has read
        named_bar(1 + g, 128);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          unsigned char* o = out + (i >> 3) * (kOutTile / 2);
          const int c = 8 * (i & 7) + 2 * (lane & 3);
          *reinterpret_cast<__nv_bfloat162*>(o + sw128_off(rl, c)) =
              __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(o + sw128_off(rl + 8, c)) =
              __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
        }
        fence_proxy_async();
        named_bar(1 + g, 128);
        if (ctid == 0) {
          tma_store(&tm_l, out, vt * kFwdBN, rb * kBM + g * 64);
          tma_store(&tm_l, out + kOutTile / 2, vt * kFwdBN + 64,
                    rb * kBM + g * 64);
          bulk_commit();
        }
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s0 += __expf(acc[4 * i] - m0) + __expf(acc[4 * i + 1] - m0);
        s1 += __expf(acc[4 * i + 2] - m1) + __expf(acc[4 * i + 3] - m1);
      }
      s0 = quad_sum(s0);
      s1 = quad_sum(s1);
      tl0 = quad_sum(tl0);
      tl1 = quad_sum(tl1);
      if ((lane & 3) == 0) {
        float* p = part + (size_t)vt * 3 * n_pad + row0;
        p[0] = m0;
        p[8] = m1;
        p[n_pad] = s0;
        p[n_pad + 8] = s1;
        p[2 * (size_t)n_pad] = tl0;
        p[2 * (size_t)n_pad + 8] = tl1;
      }
    }
    if (residual && ctid == 0) bulk_wait();
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

// ---------------------------------------------------------------- K2c
// CTA (blockIdx.x, blockIdx.y) owns vocab strip [64 x, 64 x + 64) and the
// h tiles [y tpc, min(kt, (y + 1) tpc)) of 64 rows (`dw_chunks` in the
// Python plan). Shared memory, from a 1024-byte-aligned base: the W strip
// (kt boxes [64 k, 64 v]) at 0, the bf16 d tile [128, 64] at off_d, the
// ring of `stages` x chunks [128, 64] at off_ring, the full/empty
// mbarriers and the strip's barrier at off_bar.
__global__ void __launch_bounds__(kPipeThreads, 1)
k2_dw_kernel(const __grid_constant__ CUtensorMap tm_x,
             const __grid_constant__ CUtensorMap tm_w,
             const float* __restrict__ scale, const float* __restrict__ b,
             const int* __restrict__ t, const float* __restrict__ lse,
             bf16* __restrict__ dw, float* __restrict__ db, int n_pad, int h,
             int v_pad, int stages, int tiles_per_chunk, long long off_d,
             long long off_ring, long long off_bar) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* dtile = smem + off_d;
  unsigned char* ring = smem + off_ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + off_bar);
  uint64_t* empty = full + stages;
  uint64_t* wfull = empty + stages;
  const int kt = (h + kKC - 1) / kKC;
  const int v0 = blockIdx.x * kDwBN;
  const int c_lo = blockIdx.y * tiles_per_chunk;
  const int c_hi = min(kt, c_lo + tiles_per_chunk);
  const int kh = c_hi - c_lo;     // h tiles of this CTA, held for step 5
  const int n_blocks = n_pad / kBM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(wfull, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // ------------------------ producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(wfull, kt * kWBox);
      for (int kc = 0; kc < kt; ++kc)
        tma_load(smem + kc * kWBox, &tm_w, v0, kc * kKC, wfull);
      int st = 0;
      uint32_t ph = 0;
      for (int rb = 0; rb < n_blocks; ++rb)
        for (int j = 0; j < kt; ++j) {  // the held chunks come last
          const int kc = (c_hi + j) % kt;
          mbar_wait(&empty[st], ph ^ 1);
          mbar_expect_tx(&full[st], kXChunk);
          tma_load(ring + st * kXChunk, &tm_x, kc * kKC, rb * kBM, &full[st]);
          if (++st == stages) { st = 0; ph ^= 1; }
        }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int g = threadIdx.x >> 7;
    const int wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int rl = wq * 16 + (lane >> 2);    // the thread's rows rl, rl + 8
    const float gs = *scale;
    // warpgroup 0 takes the first nt = ceil(kh / 2) h tiles of step 5,
    // warpgroup 1 the rest; both issue nt products (a count uniform over
    // the CTA, so no wgmma sits in a divergent branch), warpgroup 1's
    // last one a duplicate of tile kh - 1 when kh is odd, never stored
    const int nt = (kh + 1) >> 1;
    const int my_t0 = g ? nt : 0, my_nt = g ? kh - nt : nt;
    // db: lane l keeps strip columns 8 (l / 4) + 2 (l % 4) + {0, 1},
    // summed over the warp's rows of every block
    float dwacc[3][32], db0 = 0.f, db1 = 0.f;
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i) dwacc[q][i] = 0.f;
    const uint64_t dd = sw128_desc(dtile, 16);
    mbar_wait(wfull, 0);
    __syncwarp();
    int st = 0;
    uint32_t ph = 0;
    for (int rb = 0; rb < n_blocks; ++rb) {
      // 1. logits [128, 64] over the ring's K chunks
      float acc[32];
      int prev = -1, held0 = 0;
      for (int j = 0; j < kt; ++j) {
        const int kc = (c_hi + j) % kt;
        mbar_wait(&full[st], ph);
        __syncwarp();
        const uint64_t da =
            sw128_desc(ring + st * kXChunk + g * (kXChunk / 2), 16);
        const uint64_t dwd = sw128_desc(smem + kc * kWBox, 16);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk)
          wgmma_n64<0, 1>(acc, da + 2 * kk, dwd + 128 * kk, j | kk);
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        if (j == kt - kh) held0 = st;
        prev = j < kt - kh ? st : -1;
        if (++st == stages) { st = 0; ph ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      // 2. d on the accumulators (register 4i + 2j + c: row rl + 8 j,
      // strip column 8 i + 2 (lane % 4) + c); 3. db; 4. bf16 d tile
      const int row0 = rb * kBM + g * 64 + rl;
      const float l0 = __ldg(lse + row0), l1 = __ldg(lse + row0 + 8);
      const int t0 = __ldg(t + row0), t1 = __ldg(t + row0 + 8);
      const float f0 = t0 >= 0 ? gs : 0.f, f1 = t1 >= 0 ? gs : 0.f;
      named_bar(3, kConsumers);  // both warpgroups are done with the d tile
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 8 * i + 2 * (lane & 3);
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b + v0 + c));
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = v0 + c + (e & 1);
          const int tt = e < 2 ? t0 : t1;
          d[e] = (__expf(acc[4 * i + e] + ((e & 1) ? bb.y : bb.x) -
                         (e < 2 ? l0 : l1)) -
                  (tt == col ? 1.f : 0.f)) *
                 (e < 2 ? f0 : f1);
        }
        // 3. db: the column pair's sum over the warp's 16 rows (the row
        // lanes differ in bits 2-4), kept by the lanes of group i
        float c0 = d[0] + d[2], c1 = d[1] + d[3];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          c0 += __shfl_xor_sync(0xffffffffu, c0, o);
          c1 += __shfl_xor_sync(0xffffffffu, c1, o);
        }
        if ((lane >> 2) == i) {
          db0 += c0;
          db1 += c1;
        }
        const int r = g * 64 + rl;
        *reinterpret_cast<__nv_bfloat162*>(dtile + sw128_off(r, c)) =
            __floats2bfloat162_rn(d[0], d[1]);
        *reinterpret_cast<__nv_bfloat162*>(dtile + sw128_off(r + 8, c)) =
            __floats2bfloat162_rn(d[2], d[3]);
      }
      fence_proxy_async();
      named_bar(3, kConsumers);
      // 5. dW[h tiles, strip] += x^T d: A = the held x chunk (M = h,
      // contiguous), B = the d tile (N = v, contiguous), K = the 128 rows
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 3; ++q)
        if (q < nt) {
          const int s = (held0 + min(my_t0 + q, kh - 1)) % stages;
          const uint64_t da = sw128_desc(ring + s * kXChunk, 16);
#pragma unroll
          for (int kk = 0; kk < kBM / 16; ++kk)
            wgmma_n64<1, 1>(dwacc[q], da + 128 * kk, dd + 128 * kk, 1);
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < 3; ++q) fence_acc(dwacc[q]);
      if (lane == 0)
        for (int q = 0; q < kh; ++q) mbar_arrive(&empty[(held0 + q) % stages]);
    }
    // db: the 8 warps' column sums, added in a fixed order
    float* red = reinterpret_cast<float*>(dtile);  // [8 warps][64]
    named_bar(3, kConsumers);
    red[(threadIdx.x >> 5) * 64 + 8 * (lane >> 2) + 2 * (lane & 3)] = db0;
    red[(threadIdx.x >> 5) * 64 + 8 * (lane >> 2) + 2 * (lane & 3) + 1] = db1;
    named_bar(3, kConsumers);
    if (blockIdx.y == 0 && threadIdx.x < kDwBN) {
      float s = 0.f;
      for (int w = 0; w < kConsumerWarps; ++w) s += red[w * 64 + threadIdx.x];
      db[v0 + threadIdx.x] = s;
    }
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q < my_nt) {
        const int r = (c_lo + my_t0 + q) * 64 + rl;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          bf16* o = dw + (size_t)r * v_pad + v0 + 8 * i + 2 * (lane & 3);
          if (r < h)
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(dwacc[q][4 * i], dwacc[q][4 * i + 1]);
          if (r + 8 < h)
            *reinterpret_cast<__nv_bfloat162*>(o + 8 * (size_t)v_pad) =
                __floats2bfloat162_rn(dwacc[q][4 * i + 2], dwacc[q][4 * i + 3]);
        }
      }
  }
}

// ---------------------------------------------------------------- K2d
// x[rows of warpgroup g, chunk] . W[chunk, one vocab step]: the partial
// logits [64, 64] over the CTA's kh h tiles (x resident, W in the ring
// stage at wst), committed as one wgmma group. kh is uniform over the
// CTA, so no wgmma sits in a divergent branch
__device__ __forceinline__ void dx_partial(float (&acc)[32],
                                           const unsigned char* xres,
                                           const unsigned char* wst, int g,
                                           int kh) {
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < kDxTilesMax; ++q)
    if (q < kh) {
      const uint64_t da =
          sw128_desc(xres + q * kXChunk + g * (kXChunk / 2), 16);
      const uint64_t db = sw128_desc(wst + q * kWBox, 16);
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk)
        wgmma_n64<0, 1>(acc, da + 2 * kk, db + 128 * kk, q | kk);
    }
  wgmma_commit();
}

// f32 column c of partial-logits row r sits at c ^ 8 (r % 4) of the row
// (64 floats): the 8 rows a warp's accumulators store at once fall in
// distinct banks, and a 4-column group stays contiguous
__device__ __forceinline__ int dx_col(int r, int c) {
  return c ^ ((r & 3) << 3);
}

// the warpgroup's accumulator rows into the partials [128, 64]
// (register 4i + 2j + c: row r + 8 j, column 8 i + 2 (lane % 4) + c)
__device__ __forceinline__ void dx_store_partial(float* part,
                                                 const float (&acc)[32],
                                                 int r, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = r + 8 * j;
      *reinterpret_cast<float2*>(part + row * kDxBV +
                                 dx_col(row, 8 * i + 2 * (lane & 3))) =
          make_float2(acc[4 * i + 2 * j], acc[4 * i + 2 * j + 1]);
    }
}

// Grid (n_pad / 128, cluster): one cluster of `cluster` (C) CTAs per
// 128-row block. The CTA of rank r owns the h tiles [r tpc, min(kt, (r +
// 1) tpc)) (`dx_chunks` in the Python plan), keeps its x chunk [128, kh
// 64] resident and streams the matching W rows [kh 64, 64] of every
// vocab step through the ring; in the exchange it owns rows [r 128 / C,
// (r + 1) 128 / C). Every transfer between CTAs is an async bulk copy
// into the other CTA's shared memory that completes bytes on that CTA's
// mbarrier (cp.async.bulk.shared::cluster): no remote loads, and no
// cluster-scope release (which compiles to a GPU-wide memory barrier).
// Per vocab step j (columns v0 = 64 j):
//   1. partial logits [128, 64] over the CTA's h chunk (wgmma, x K-major,
//      W N-major), written f32 into the CTA's `part` buffer;
//   2. one thread copies each owner's rows of `part` into slice r of that
//      owner's `recv` buffer, completing on its `pready`;
//   3. when `pready` holds all C slices of its rows, the CTA sums them
//      (in rank order 0, 1, ..., so the sum is the same on every launch),
//      adds the bias, forms d = (exp(l - lse) - onehot) g/N (0 on pad
//      rows) and writes bf16 d into its own d tile j % 2, under the
//      128-byte swizzle of a wgmma K-major operand;
//   4. one thread copies those d rows into d tile j % 2 of every other
//      CTA, completing on its `dready`; past `dready` every row of d is
//      in place and every copy out of `part` of step j has landed;
//   5. dx[128, chunk] += d[128, 64] . W[chunk, v0:v0+64]^T (wgmma, A = d
//      K-major, B = the same W stage read K-major: no transpose).
// The consumers issue step j + 1's partial product before step j's
// exchange and retire it (wait_group 1) after issuing step j's dx
// product, so the tensor cores run while the cluster exchanges. Each
// exchange barrier is armed (arrive.expect_tx) for the bytes of its next
// phase by the thread that issues this CTA's copies, after every local
// waiter has passed the current phase and before this CTA sends what
// lets another CTA answer it. Reuse: `part` is rewritten only past
// `dready` of the step it held; `recv` only after the CTA has summed it
// and sent its d rows; d tile j % 2 is written for step j + 2 only after
// every CTA has sent its step j + 2 partials, which each sends after its
// dx product of step j has retired; a ring stage is released when the dx
// product that read it retires. d rows written here by generic stores
// are fenced to the async proxy before they are copied or read by
// wgmma. A cluster barrier after the mbarrier set-up and another before
// exit keep every CTA's shared memory alive while the others use it.
__global__ void __launch_bounds__(kPipeThreads, 1)
k2_dx_kernel(const __grid_constant__ CUtensorMap tm_x,
             const __grid_constant__ CUtensorMap tm_w,
             const float* __restrict__ scale, const float* __restrict__ b,
             const int* __restrict__ t, const float* __restrict__ lse,
             bf16* __restrict__ dx, int n_pad, int h, int v_pad, int stages,
             int tiles_per_chunk, long long off_p, long long off_r,
             long long off_d, long long off_ring, long long off_bar) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* xres = smem;
  float* part = reinterpret_cast<float*>(smem + off_p);
  float* recv = reinterpret_cast<float*>(smem + off_r);
  unsigned char* dtile = smem + off_d;
  unsigned char* ring = smem + off_ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + off_bar);
  uint64_t* empty = full + stages;
  uint64_t* xfull = empty + stages;
  uint64_t* pready = xfull + 1;
  uint64_t* dready = pready + 1;
  const int csize = gridDim.y;           // the cluster spans gridDim.y
  const int rank = (int)cluster_rank();
  const int kt = (h + kKC - 1) / kKC;
  const int c_lo = blockIdx.y * tiles_per_chunk;
  const int kh = min(kt, c_lo + tiles_per_chunk) - c_lo;
  const int rb = blockIdx.x;
  const int nv = v_pad / kDxBV;
  const int stage_bytes = tiles_per_chunk * kWBox;
  // the exchange: rank o owns rows [o 128 / C, (o + 1) 128 / C); `recv`
  // holds C slices of rmax rows; the bytes each barrier phase receives
  const int e_lo = rank * kBM / csize, e_hi = (rank + 1) * kBM / csize;
  const int rmax = (kBM + csize - 1) / csize;
  const uint32_t p_bytes = csize * (e_hi - e_lo) * kDxBV * 4;
  const uint32_t d_bytes = (kBM - (e_hi - e_lo)) * kDxBV * 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(xfull, 1);
    mbar_init(pready, 1);
    mbar_init(dready, 1);
    mbar_expect_tx(pready, p_bytes);  // armed for step 0
    mbar_expect_tx(dready, d_bytes);
    mbar_init_fence();
  }
  cluster_sync();  // every CTA's mbarriers exist before a remote copy

  if (threadIdx.x >= kConsumers) {  // ------------------------ producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(xfull, kh * kXChunk);
      for (int q = 0; q < kh; ++q)
        tma_load(xres + q * kXChunk, &tm_x, (c_lo + q) * kKC, rb * kBM,
                 xfull);
      int st = 0;
      uint32_t ph = 0;
      for (int j = 0; j < nv; ++j) {
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], kh * kWBox);
        for (int q = 0; q < kh; ++q)
          tma_load(ring + st * stage_bytes + q * kWBox, &tm_w, j * kDxBV,
                   (c_lo + q) * kKC, &full[st]);
        if (++st == stages) { st = 0; ph ^= 1; }
      }
    }
  } else {  // ------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int g = threadIdx.x >> 7;
    const int wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int rl = g * 64 + wq * 16 + (lane >> 2);  // rows rl, rl + 8
    const float gs = *scale;
    float pacc[32], dacc[kDxTilesMax][32];
#pragma unroll
    for (int q = 0; q < kDxTilesMax; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i) dacc[q][i] = 0.f;
    // 2. every owner's rows of `part` into its `recv` slice `rank`
    auto send_partials = [&]() {
      fence_proxy_async();
      named_bar(1, kConsumers);
      if (threadIdx.x == 0)
        for (int o = 0; o < csize; ++o) {
          const int lo = o * kBM / csize, hi = (o + 1) * kBM / csize;
          dsmem_copy(recv + rank * rmax * kDxBV, part + lo * kDxBV,
                     (hi - lo) * kDxBV * 4, pready, o);
        }
    };
    mbar_wait(xfull, 0);
    mbar_wait(&full[0], 0);
    __syncwarp();
    dx_partial(pacc, xres, ring, g, kh);
    wgmma_wait<0>();
    fence_acc(pacc);
    dx_store_partial(part, pacc, rl, lane);
    send_partials();

    int st = 0, pst = 0;  // ring stages of steps j and j - 1
    uint32_t ph = 0;
    for (int j = 0; j < nv; ++j) {
      const int v0 = j * kDxBV;
      int nst = st + 1;
      uint32_t nph = ph;
      if (nst == stages) { nst = 0; nph ^= 1; }
      if (j + 1 < nv) {  // step j + 1's partial product, in flight below
        mbar_wait(&full[nst], nph);
        __syncwarp();
        dx_partial(pacc, xres, ring + nst * stage_bytes, g, kh);
      }
      // 3. this CTA's rows of d, summed over the cluster's partials
      mbar_wait(pready, j & 1);
      unsigned char* dj = dtile + (j & 1) * kDTile;
      for (int e = threadIdx.x; e < (e_hi - e_lo) * (kDxBV / 4);
           e += kConsumers) {
        const int rr = e / (kDxBV / 4), r = e_lo + rr;
        const int c = 4 * (e % (kDxBV / 4));
        const float* src = recv + rr * kDxBV + dx_col(r, c);
        float4 s = *reinterpret_cast<const float4*>(src);
        for (int k = 1; k < csize; ++k) {
          const float4 o =
              *reinterpret_cast<const float4*>(src + k * rmax * kDxBV);
          s.x += o.x;
          s.y += o.y;
          s.z += o.z;
          s.w += o.w;
        }
        const int row = rb * kBM + r;
        const int tt = __ldg(t + row);
        const float l = __ldg(lse + row), f = tt >= 0 ? gs : 0.f;
        const float4 bb = __ldg(reinterpret_cast<const float4*>(b + v0 + c));
        const int hit = tt - v0 - c;  // -1 and targets >= v_pad never hit
        __nv_bfloat162 dv[2];
        dv[0] = __floats2bfloat162_rn(
            (__expf(s.x + bb.x - l) - (hit == 0 ? 1.f : 0.f)) * f,
            (__expf(s.y + bb.y - l) - (hit == 1 ? 1.f : 0.f)) * f);
        dv[1] = __floats2bfloat162_rn(
            (__expf(s.z + bb.z - l) - (hit == 2 ? 1.f : 0.f)) * f,
            (__expf(s.w + bb.w - l) - (hit == 3 ? 1.f : 0.f)) * f);
        *reinterpret_cast<uint2*>(dj + sw128_off(r, c)) =
            *reinterpret_cast<const uint2*>(dv);
      }
      fence_proxy_async();
      named_bar(1, kConsumers);
      // 4. this CTA's d rows to every other CTA; `pready` armed for the
      // next step first (every local waiter has passed this one)
      if (threadIdx.x == 0) {
        if (j + 1 < nv) mbar_expect_tx(pready, p_bytes);
        for (int o = 0; o < csize; ++o)
          if (o != rank)
            dsmem_copy(dj + e_lo * 128, dj + e_lo * 128,
                       (e_hi - e_lo) * 128, dready, o);
      }
      mbar_wait(dready, j & 1);
      __syncwarp();
      // 5. dx += d . W^T over the ring stage of step j
      wgmma_fence();
      const uint64_t dd = sw128_desc(dj + g * (kDTile / 2), 16);
#pragma unroll
      for (int q = 0; q < kDxTilesMax; ++q)
        if (q < kh) {
          const uint64_t dw =
              sw128_desc(ring + st * stage_bytes + q * kWBox, 16);
#pragma unroll
          for (int kk = 0; kk < kDxBV / 16; ++kk)
            wgmma_n64<0, 0>(dacc[q], dd + 2 * kk, dw + 2 * kk, 1);
        }
      wgmma_commit();
      if (j + 1 < nv) {
        // retires step j - 1's dx product and step j + 1's partials
        wgmma_wait<1>();
        fence_acc(pacc);
        if (j > 0 && lane == 0) mbar_arrive(&empty[pst]);
        dx_store_partial(part, pacc, rl, lane);
        named_bar(1, kConsumers);  // every local waiter has passed dready
        if (threadIdx.x == 0) mbar_expect_tx(dready, d_bytes);
        send_partials();
      } else {
        wgmma_wait<0>();
      }
      pst = st;
      st = nst;
      ph = nph;
    }
#pragma unroll
    for (int q = 0; q < kDxTilesMax; ++q) fence_acc(dacc[q]);
    const int row = rb * kBM + rl;
#pragma unroll
    for (int q = 0; q < kDxTilesMax; ++q)
      if (q < kh)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = (c_lo + q) * kKC + 8 * i + 2 * (lane & 3);
          if (col < h) {
            bf16* o = dx + (size_t)row * h + col;
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(dacc[q][4 * i], dacc[q][4 * i + 1]);
            *reinterpret_cast<__nv_bfloat162*>(o + 8 * (size_t)h) =
                __floats2bfloat162_rn(dacc[q][4 * i + 2], dacc[q][4 * i + 3]);
          }
        }
  }
  __syncwarp();
  cluster_sync();  // no CTA leaves while another may still use it
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

// ------------------------------------------------ tensor maps (host)

// a bf16 row-major [rows, cols] tensor read or written in boxes of
// [box_rows, 64] (64 bf16 = one 128-byte swizzle row), out-of-bounds
// elements read as zeros; 0, or the negative code of the C interface
int tensor_map(CUtensorMap* map, const void* p, int rows, int cols,
               int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(p), dim, stride, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}

}  // namespace

extern "C" {

// (logits | null, lse, tl) of padded operands: `grid` persistent CTAs,
// a ring of `stages`; part is [v_pad / 128, 3, n_pad] f32 scratch for
// the per-tile row state
int k2_fwd(const void* x, const void* w, const void* b, const void* t,
           void* logits, void* part, void* lse, void* tl, int n_pad, int h,
           int v_pad, int grid, int stages, long long smem, long long off_out,
           long long off_bar, void* stream) {
  if (!shape_ok(n_pad, h, v_pad) || grid <= 0 || stages <= 0 ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w, tm_l = {};
  int e = tensor_map(&tm_x, x, n_pad, h, kBM);
  if (!e) e = tensor_map(&tm_w, w, h, v_pad, kKC);
  if (!e && logits != nullptr) e = tensor_map(&tm_l, logits, n_pad, v_pad, 64);
  if (e) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = set_smem(k2_fwd_kernel, smem);
  if (e) return e;
  k2_fwd_kernel<<<grid, kPipeThreads, smem, s>>>(
      tm_x, tm_w, tm_l, static_cast<const float*>(b),
      static_cast<const int*>(t), static_cast<float*>(part),
      logits != nullptr, n_pad, h, v_pad, stages, off_out, off_bar);
  e = (int)cudaGetLastError();
  if (e) return e;
  k2_fwd_combine<<<(n_pad + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(part), v_pad / kFwdBN, n_pad,
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

// dw [h, v_pad] bf16 and db [v_pad] f32 of the recompute scheme: a grid
// of (v_pad / 64, h chunks of tiles_per_chunk 64-row tiles), a ring of
// `stages` (at least tiles_per_chunk + 1)
int k2_dw(const void* scale, const void* x, const void* w, const void* b,
          const void* t, const void* lse, void* dw, void* db, int n_pad,
          int h, int v_pad, int stages, int tiles_per_chunk, long long smem,
          long long off_d, long long off_ring, long long off_bar,
          void* stream) {
  if (!shape_ok(n_pad, h, v_pad) || tiles_per_chunk <= 0 ||
      tiles_per_chunk > kDwTilesMax || stages <= tiles_per_chunk ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w;
  int e = tensor_map(&tm_x, x, n_pad, h, kBM);
  if (!e) e = tensor_map(&tm_w, w, h, v_pad, kKC);
  if (e) return e;
  e = set_smem(k2_dw_kernel, smem);
  if (e) return e;
  const int kt = (h + kKC - 1) / kKC;
  const dim3 grid(v_pad / kDwBN, (kt + tiles_per_chunk - 1) / tiles_per_chunk);
  k2_dw_kernel<<<grid, kPipeThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_w, static_cast<const float*>(scale),
      static_cast<const float*>(b), static_cast<const int*>(t),
      static_cast<const float*>(lse), static_cast<bf16*>(dw),
      static_cast<float*>(db), n_pad, h, v_pad, stages, tiles_per_chunk,
      off_d, off_ring, off_bar);
  return (int)cudaGetLastError();
}

// dx [n_pad, h] bf16 of the recompute scheme: a grid of (n_pad / 128,
// cluster) launched as clusters of `cluster` CTAs along y, each CTA
// tiles_per_chunk 64-wide h tiles (the last CTA's chunk may be shorter),
// a ring of `stages` (at least 3: steps j - 1, j and j + 1 are held)
int k2_dx(const void* scale, const void* x, const void* w, const void* b,
          const void* t, const void* lse, void* dx, int n_pad, int h,
          int v_pad, int cluster, int tiles_per_chunk, int stages,
          long long smem, long long off_p, long long off_r, long long off_d,
          long long off_ring, long long off_bar, void* stream) {
  const int kt = (h + kKC - 1) / kKC;
  if (!shape_ok(n_pad, h, v_pad) || tiles_per_chunk <= 0 ||
      tiles_per_chunk > kDxTilesMax || cluster <= 0 ||
      cluster > kDxClusterMax || (cluster - 1) * tiles_per_chunk >= kt ||
      cluster * tiles_per_chunk < kt || stages < 3 || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w;
  int e = tensor_map(&tm_x, x, n_pad, h, kBM);
  if (!e) e = tensor_map(&tm_w, w, h, v_pad, kKC);
  if (e) return e;
  e = set_smem(k2_dx_kernel, smem);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_pad / kBM, cluster);
  cfg.blockDim = dim3(kPipeThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(
      &cfg, k2_dx_kernel, tm_x, tm_w, static_cast<const float*>(scale),
      static_cast<const float*>(b), static_cast<const int*>(t),
      static_cast<const float*>(lse), static_cast<bf16*>(dx), n_pad, h, v_pad,
      stages, tiles_per_chunk, off_p, off_r, off_d, off_ring, off_bar);
  if (e) return e;
  return (int)cudaGetLastError();
}

}  // extern "C"
