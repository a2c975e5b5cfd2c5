// R1: the HBM bandwidth probe, hand-written for Hopper (sm_90a). Replaces
// the Pallas TPU kernel `neg_kernel` of kungfu_tpu/benchmarks/roofline.py:237
// (launched by the pl.pallas_call at :240), the `pallas_stream` pattern of
// its bandwidth suite.
//
// Function: o = -x over n bf16 elements (the TPU kernel's operand is
// [rows, 1024] in (512, 1024) blocks; here any contiguous tensor).
//
// Bound on the H100: bytes. It reads x once and writes o once, 4 bytes an
// element, with one operation an element: 2 x 0.5 GiB at the suite's
// [262144, 1024] shape take 0.320 ms at 3.35 TB/s. Its whole job is to be
// the denominator of "at roofline", so it has to run near that.
//
// Design: a persistent streaming kernel fed by the TMA's 1-D bulk copies.
// The TPU's 512-row blocks exist for VMEM; here the tensor is cut into
// chunks of `chunk_bytes` and a few persistent CTAs an SM (8 KB chunks,
// rings of 12 stages, two CTAs an SM: ops/stream.py::r1_plan) take chunk
// after chunk from a counter in device memory, so a CTA on a faster SM
// takes more of them: a share fixed at the launch (a contiguous range or
// every grid-th chunk a CTA) ran 4-5 % slower on the H100, as the slowest
// SMs set the end. One producer thread copies each chunk it takes into a
// ring of `stages` shared buffers (cp.async.bulk, completing on the
// stage's full mbarrier), keeping stages - kStoreLag chunks of reads in
// flight; the consumer warps negate a stage in place with 16-byte shared
// loads and stores and arrive on its done barrier; the producer then
// writes the stage back with a bulk store and reuses it once all but the
// kStoreLag latest stores have read their stages. No thread issues a
// 16-byte global access on the bulk path. Everything past the last whole
// chunk (a partial chunk and the n % 8 elements past the last 16-byte
// vector) is negated by every CTA's consumers in the same launch, 16-byte
// vectors and then one element a thread.
//
// Each element is negated as torch.neg computes it on the card — through
// f32 and back with the same round-to-nearest conversion (c10's BFloat16
// `operator-`) — which flips the sign bit of every value, zeros and
// infinities included, and gives a NaN exactly the NaN torch.neg gives,
// so the kernel is bitwise equal to torch.neg.

#include "hopper.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
// stores that may still be reading their stages when a stage is refilled
// (ops/stream.py::R1_STORE_LAG)
constexpr int kStoreLag = 2;

__device__ __forceinline__ __nv_bfloat16 neg1(__nv_bfloat16 v) {
  return __float2bfloat16(-__bfloat162float(v));
}

__device__ __forceinline__ uint32_t neg2(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w);
  __nv_bfloat162 r;
  r.x = neg1(v.x);
  r.y = neg1(v.y);
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint4 neg8(uint4 v) {
  return make_uint4(neg2(v.x), neg2(v.y), neg2(v.z), neg2(v.w));
}

// elements [begin, n) of x negated into o by thread t of `threads`:
// whole 16-byte vectors (begin is a multiple of 8), then the n % 8 left
__device__ __forceinline__ void neg_tail(const __nv_bfloat16* __restrict__ x,
                                         __nv_bfloat16* __restrict__ o,
                                         long long begin, long long n,
                                         long long t, long long threads) {
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(o);
  const long long nvec = n / 8;
  for (long long v = begin / 8 + t; v < nvec; v += threads)
    ov[v] = neg8(xv[v]);
  const long long e = nvec * 8 + t;
  if (e < n) o[e] = neg1(x[e]);
}

// Chunk c is bytes [c * chunk_bytes, (c + 1) * chunk_bytes) of x and o,
// c < chunks; the CTAs take them in order from the counter tickets[0], so
// a CTA on a faster SM takes more of them. tickets[1] counts the CTAs that
// have drawn their last ticket; the last of them sets both back to 0 for
// the next launch. Elements [tail, n) are past the last whole chunk.
__global__ void __launch_bounds__(kThreads)
    r1_neg(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ o,
           long long n, int chunk_bytes, int stages, long long chunks,
           long long tail, int* __restrict__ tickets) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(stages) * chunk_bytes);
  uint64_t* done = full + stages;
  long long* job = reinterpret_cast<long long*>(done + stages);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&done[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane != 0) return;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(x);
    unsigned char* dst = reinterpret_cast<unsigned char*>(o);
    const auto ticket = [&] {
      return static_cast<long long>(atomicAdd(tickets, 1));
    };
    // ring slot k is stage k % stages; the slots hold this CTA's chunks in
    // the order it took them (job[stage]), then one end marker (job -1)
    long long next = ticket();
    int filled = 0, fs = 0;
    bool ended = false;
    const auto fill = [&] {
      if (next < chunks) {
        job[fs] = next;
        mbar_expect_tx(&full[fs], chunk_bytes);
        bulk_load(smem + static_cast<size_t>(fs) * chunk_bytes,
                  src + next * chunk_bytes, chunk_bytes, &full[fs]);
        next = ticket();
      } else {
        job[fs] = -1;
        mbar_arrive(&full[fs]);
        ended = true;
      }
      ++filled;
      if (++fs == stages) fs = 0;
    };
    while (!ended && filled < stages - kStoreLag) fill();
    int s = 0, ph = 0;
    for (int k = 0; !(ended && k == filled - 1); ++k) {
      mbar_wait(&done[s], ph);
      bulk_store(dst + job[s] * chunk_bytes,
                 smem + static_cast<size_t>(s) * chunk_bytes, chunk_bytes);
      bulk_commit();
      if (!ended) {
        // slot `filled` reuses the stage of slot k - kStoreLag, whose
        // store is older than the kStoreLag latest
        if (filled >= stages) bulk_wait_read<kStoreLag>();
        fill();
      }
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    __threadfence();  // this CTA's draws come before its count below
    if (atomicAdd(&tickets[1], 1) == static_cast<int>(gridDim.x) - 1) {
      atomicExch(&tickets[0], 0);
      atomicExch(&tickets[1], 0);
    }
    bulk_wait();
    return;
  }

  const int vecs = chunk_bytes / 16;
  for (int s = 0, ph = 0;;) {
    mbar_wait(&full[s], ph);
    if (job[s] < 0) break;
    uint4* v = reinterpret_cast<uint4*>(smem + static_cast<size_t>(s) *
                                                   chunk_bytes);
#pragma unroll 4
    for (int j = threadIdx.x; j < vecs; j += kConsumers) v[j] = neg8(v[j]);
    fence_proxy_async();  // the negated stage, visible to the bulk store
    __syncwarp();
    if (lane == 0) mbar_arrive(&done[s]);
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
  neg_tail(x, o, tail, n,
           static_cast<long long>(blockIdx.x) * kConsumers + threadIdx.x,
           static_cast<long long>(gridDim.x) * kConsumers);
}

}  // namespace

// x, o: n bf16 elements, 16-byte aligned; tickets: two ints on the card,
// 0 before the launch and after it, used by one launch at a time (one
// pair for each stream, ops/stream.py). The launch plan comes from
// ops/stream.py::r1_plan: `grid` CTAs, `chunks` chunks of `chunk_bytes` (a
// multiple of 16) through a ring of `stages` (more than kStoreLag) in
// `smem` bytes, the tail from element `tail` = chunks * chunk_bytes / 2.
// Returns cudaErrorInvalidValue for a plan the kernel does not take, else
// cudaGetLastError() after the launch (0 when n is 0).
extern "C" int r1_neg_bf16(const void* x, void* o, long long n, int grid,
                           int chunk_bytes, int stages, long long smem,
                           long long chunks, long long tail, void* tickets,
                           void* stream) {
  if (n <= 0) return 0;
  if (grid < 1 || chunk_bytes < 16 || chunk_bytes % 16 ||
      stages <= kStoreLag || chunks < 0 ||
      smem < static_cast<long long>(stages) * (chunk_bytes + 24) ||
      chunks * chunk_bytes != 2 * tail || tail > n ||
      chunks + grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      r1_neg, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  r1_neg<<<grid, kThreads, static_cast<size_t>(smem), st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(o),
      n, chunk_bytes, stages, chunks, tail, static_cast<int*>(tickets));
  return static_cast<int>(cudaGetLastError());
}
