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
// Design: the TPU's 512-row blocks exist for VMEM; here each thread walks
// a grid-stride loop of 16-byte vectors (8 bf16), four vectors in flight
// a step, with streaming (evict-first) loads and stores, over a grid of
// 8 blocks of 256 threads an SM; the n % 8 elements past the last vector
// go one a thread. Each element is negated as torch.neg computes it on
// the card — through f32 and back with the same round-to-nearest
// conversion (c10's BFloat16 `operator-`) — which flips the sign bit of
// every value, zeros and infinities included, and gives a NaN exactly the
// NaN torch.neg gives, so the kernel is bitwise equal to torch.neg.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

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

__global__ void __launch_bounds__(kThreads)
    r1_neg(const uint4* __restrict__ x, uint4* __restrict__ o,
           long long nvec, const __nv_bfloat16* __restrict__ xs,
           __nv_bfloat16* __restrict__ os, long long n) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = tid;
  for (; i + 3 * stride < nvec; i += 4 * stride) {
    const uint4 a = __ldcs(x + i);
    const uint4 b = __ldcs(x + i + stride);
    const uint4 c = __ldcs(x + i + 2 * stride);
    const uint4 d = __ldcs(x + i + 3 * stride);
    __stcs(o + i, neg8(a));
    __stcs(o + i + stride, neg8(b));
    __stcs(o + i + 2 * stride, neg8(c));
    __stcs(o + i + 3 * stride, neg8(d));
  }
  for (; i < nvec; i += stride) __stcs(o + i, neg8(__ldcs(x + i)));
  const long long t = nvec * 8 + tid;  // the ragged tail, < 8 elements
  if (t < n) os[t] = neg1(xs[t]);
}

}  // namespace

// x, o: n bf16 elements, 16-byte aligned; sms: the card's SM count.
// Returns cudaGetLastError() after the launch (0 when n is 0).
extern "C" int r1_neg_bf16(const void* x, void* o, long long n, int sms,
                           void* stream) {
  if (n <= 0) return 0;
  const long long nvec = n / 8;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  r1_neg<<<static_cast<int>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(o), nvec,
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(o),
      n);
  return static_cast<int>(cudaGetLastError());
}
