// Margin-aware quantized-KV retry read for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kv_retry/kernel.py::
// _kv_retry_kernel (entry kv_retry_pallas).  Per page p of E elements:
//
//   deq    = data_q[p] * scale[p]                      (float32)
//   rms    = sqrt(sum(deq^2) / E + 1e-12)
//   margin = 1 - (0.5 * scale[p]) / (tau * rms)
//   out[p] = margin >= 0 ? deq : backing[p]   (rounded to backing's dtype)
//
// Design.  One warp per page, eight pages to a block of 256 threads.
// Each lane reads four int8 values at a time (E a multiple of 4), sums
// the squares of their dequant, and the warp reduces with shuffles, so
// every lane holds the page's margin.  The warp then writes the dequant
// (the fast read) or copies the backing page (the retry).  The backing
// page is read only for pages that retry: that is the serving analogue
// of the paper's retry, and it is why the kernel can move fewer bytes
// than a select that reads both tiers.
//
// Bound.  Bytes: each int8 page and its scale are read once, each output
// page and margin written once, and a backing page read only where the
// page retries; the arithmetic is a few flops a byte.  The source is
// built with -fmad=false: squares and sums round separately, as the
// reference's operations do (its reduction order still differs, so
// margins agree to about an ulp, not bit for bit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPagesPerBlock = kThreads / 32;

__device__ __forceinline__ void store_deq(float* p, float a, float b,
                                          float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store_deq(__nv_bfloat16* p, float a, float b,
                                          float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Four elements copied bit for bit.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void copy4(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src) {
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_retry_kernel(const int8_t* __restrict__ data_q,
                const float* __restrict__ scale,
                const T* __restrict__ backing, T* __restrict__ out,
                float* __restrict__ margin, long long P, int E, float tau) {
  const int lane = threadIdx.x & 31;
  const long long page =
      (long long)blockIdx.x * kPagesPerBlock + (threadIdx.x >> 5);
  if (page >= P) return;
  const float s = scale[page];
  const int8_t* qp = data_q + page * E;

  float ss = 0.f;
  for (int e = lane * 4; e < E; e += 128) {
    const char4 c = *reinterpret_cast<const char4*>(qp + e);
    const float a = (float)c.x * s, b = (float)c.y * s;
    const float d = (float)c.z * s, f = (float)c.w * s;
    ss += a * a;
    ss += b * b;
    ss += d * d;
    ss += f * f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float rms = sqrtf(ss / (float)E + 1e-12f);
  const float mg = 1.0f - (0.5f * s) / (tau * rms);
  if (lane == 0) margin[page] = mg;

  T* op = out + page * E;
  if (mg >= 0.f) {
    for (int e = lane * 4; e < E; e += 128) {
      const char4 c = *reinterpret_cast<const char4*>(qp + e);
      store_deq(op + e, (float)c.x * s, (float)c.y * s, (float)c.z * s,
                (float)c.w * s);
    }
  } else {
    const T* bp = backing + page * E;
    for (int e = lane * 4; e < E; e += 128) copy4(op + e, bp + e);
  }
}

template <typename T>
int launch(const void* q, const void* s, const void* b, void* o, void* m,
           long long P, int E, float tau, cudaStream_t stream) {
  if (P == 0) return 0;
  const long long blocks = (P + kPagesPerBlock - 1) / kPagesPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kv_retry_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const T*>(b), static_cast<T*>(o), static_cast<float*>(m),
      P, E, tau);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of backing and out: 0 float32, 1 bfloat16.  Returns a
// cudaError_t (0 on success).
extern "C" int kv_retry_launch(const void* data_q, const void* scale,
                               const void* backing, void* out, void* margin,
                               long long P, int E, float tau, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || E % 4) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(data_q, scale, backing, out, margin, P, E, tau, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(data_q, scale, backing, out, margin, P, E,
                                 tau, st);
  return (int)cudaErrorInvalidValue;
}
