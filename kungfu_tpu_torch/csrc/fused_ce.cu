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
// fwd and dw: TMA-fed wgmma pipelines. One CTA is three warpgroups:
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
// - dx (wmma, the parent design): one CTA owns 32 rows and walks all
//   64-column W tiles, rebuilding each logits tile with `logits_tile`
//   over the whole hidden size staged in shared memory (rows padded by
//   16 bytes against bank conflicts); the [32, 768] f32 dx accumulator
//   lives in registers (12 wmma fragments per warp, 8 warps). A larger h
//   splits it over gridDim.y (chunks of 768 columns). Its row strides are
//   h + 8 (x), bv + 8 (W, d) and bv + 4 (f32 logits tile); it stages its
//   output through the f32 logits tile once the sweep is done.
// - padded vocab columns: their bias -1e30 makes exp(logit - lse) exactly
//   0, so they add nothing to the sums, d or db's meaning.
//
// Shared memory: the wrapper passes the byte offsets of each buffer and
// the total from the Python plan (`smem_layout`, the one formula). The
// pipelined kernels round their dynamic shared memory up to a 1024-byte
// boundary (the 128-byte swizzle repeats every 1024 bytes, and TMA and
// wgmma both apply it to address bits), for which the total holds 1 KB
// of slack.
//
// libcuda's cuTensorMapEncodeTiled is looked up once through the runtime
// (cudaGetDriverEntryPointByVersion, or cudaGetDriverEntryPoint before
// CUDA 12.5), so the library needs no -lcuda.
//
// C interface (bound with ctypes): every function launches on the
// caller's stream, allocates nothing and returns cudaGetLastError(), or
// a negative code when a tensor map cannot be encoded (-1: the encoder
// was not found; -1000 - CUresult: it refused the operand).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDxBM = 32, kDxBV = 64;
constexpr int kHChunk = 768;   // gradient cols a dx CTA holds
constexpr int kFragMax = 12;   // accumulator fragments per warp
constexpr int kRdCols = 128;   // vocab columns of one residual_d CTA
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

// the TMA/wgmma pipelines (fwd, dw)
constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kPipeThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBM = 128;                 // rows of a block (64 a warpgroup)
constexpr int kKC = 64;                  // K chunk: one 128-byte swizzle row
constexpr int kFwdBN = 128;              // vocab columns of a fwd tile
constexpr int kDwBN = 64;                // vocab columns of a dw strip
constexpr int kDwTilesMax = 6;           // 64-row h tiles of a dw chunk
constexpr int kXChunk = kBM * kKC * 2;   // x [128, 64] bf16: 16 KB
constexpr int kWBox = kKC * 64 * 2;      // W [64, 64] bf16: 8 KB
constexpr int kFwdStage = kXChunk + 2 * kWBox;  // 32 KB
constexpr int kOutTile = 2 * 64 * 64 * 2;       // a warpgroup's bf16 logits
constexpr int kMaxStages = 8;
constexpr uint32_t kSpinLimit = 1u << 26;  // mbarrier polls before a trap

static_assert((kDxBM / 16) * (kHChunk / 16) == kFragMax * kWarps,
              "dx accumulator tiles must fill kFragMax per warp");
static_assert(kDxBM * (kDxBV + 4) >= kWarps * 256,
              "the logits tile must hold the eight warps' output tiles");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

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

// ------------------------------------------- Hopper primitives (PTX)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// waits until the phase of parity `parity` has completed; a pipeline that
// stops (a lost arrival) traps after kSpinLimit polls instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == kSpinLimit) __trap();
  }
}

// the 2-D box at (c0 innermost, c1) of `map` into shared memory at dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the committed TMA stores have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// generic-proxy shared-memory writes become visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at p
// (1024-byte-aligned atoms): start address, leading and stride byte
// offsets in 16-byte units, layout type 1 (128B swizzle). K-major: the
// stride is 1024 bytes between 8-row groups (the leading offset is not
// read). M/N-major: the stride is 1024 bytes between 8-row K groups and
// the leading offset the distance between 64-column blocks. Adding n to
// the descriptor moves the start by 16 n bytes: +2 per 16-deep K step
// inside a K-major swizzle row, +128 per 16 K rows of an M/N-major tile.
__device__ __forceinline__ uint64_t sw128_desc(const void* p,
                                               uint32_t lead_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lead_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// byte offset of bf16 element (r, c) in a [rows, 64] tile with 128-byte
// rows under the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B):
// 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^ (r % 8)
__device__ __forceinline__ int sw128_off(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// D[64, 128] (+)= A[64, 16] . B[16, 128], bf16 in, f32 accumulators
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64, 64] (+)= A[64, 16] . B[16, 64], bf16 in, f32 accumulators
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// pins accumulator registers after wgmma_wait: the compiler may not move
// their reads above it
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

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

// ------------------------------------------------ tensor maps (host)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

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
