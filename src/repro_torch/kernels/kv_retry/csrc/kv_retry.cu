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
// Backing and out are float32, bfloat16 or int8.  int8 backing is the
// in-model int8 KV cache's (REPRO_KV_INT8=1): a fast page is written as
// trunc(deq), toward zero, as the reference's float-to-int8 convert
// does, and a retried page is copied; the margin is the same.  The
// vector kernel's lane then loads 16 bytes of the int8 page and 16 of
// the backing, and writes its 16 outputs with one 16-byte store.
//
// Bound.  Bytes: each int8 page and its scale are read once, each output
// page and margin written once, and a backing page read only where the
// page retries (the serving analogue of the paper's retry, and why the
// read can move fewer bytes than a select that reads both tiers); the
// arithmetic is a few flops a byte.  The source is built with
// -fmad=false: squares and sums round separately, as the reference's
// operations do (the reduction order differs, so margins agree to about
// an ulp, not bit for bit).
//
// Design (kv_retry_vec_kernel, page widths a multiple of 16 up to 512).
// A group of G lanes owns a page, G = E/16 rounded up to a power of two:
// each lane loads its 16 int8 values with one 16-byte load and keeps
// them in registers for both the sum of squares and the dequant, so the
// page is read once.  A lane sums its 16 squares in order, and the group
// adds its partial sums in a butterfly of log2(G) shuffles (lanes past
// E/16 add 0), so every lane holds the page's margin.  A thread issues
// the loads of kUnroll pages before it reduces any of them, and the
// blocks stride over the pages persistently (SMs x resident blocks, 8 a
// SM), so each SM keeps tens of KB of loads in flight: that is what the
// HBM rate needs (Little's law at HBM3's latency), and what one 4-byte
// load a lane per warp-sized page, the first design, lacked.  Each lane
// writes its 16 outputs with two (bfloat16) or four (float32) 16-byte
// streaming stores, or copies its 16 backing values where the page
// retries.  kv_retry_emulate in kernels/kv_retry/emulate.py restates
// this order.  tools/kv_ablation.cu holds the designs this one was
// measured against (1 and 4 pages in flight, a lane's values in two
// spread halves, and bulk copies through shared memory); on the H100 it
// reaches about 80% of the bytes bound on llama3.2-3b's decode leaf,
// where a copy_ of the leaf reaches 90% of the HBM rate.
//
// kv_retry_kernel is the first design, kept for widths that are a
// multiple of 4 but not of 16: one warp per page, four values a lane,
// the page read twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPagesPerBlock = kThreads / 32;
constexpr int kMaxVecWidth = 512;
constexpr int kUnroll = 2;   // pages in flight a thread, vector kernel

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

// int8 out: each value truncated toward zero (in int8's range).
__device__ __forceinline__ uint32_t pack_i8(float a, float b, float c,
                                            float d) {
  return ((uint32_t)__float2int_rz(a) & 0xffu) |
         (((uint32_t)__float2int_rz(b) & 0xffu) << 8) |
         (((uint32_t)__float2int_rz(c) & 0xffu) << 16) |
         (((uint32_t)__float2int_rz(d) & 0xffu) << 24);
}

__device__ __forceinline__ void store_deq(int8_t* p, float a, float b,
                                          float c, float d) {
  *reinterpret_cast<uint32_t*>(p) = pack_i8(a, b, c, d);
}

// Four elements copied bit for bit.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void copy4(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src) {
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
}

__device__ __forceinline__ void copy4(int8_t* dst, const int8_t* src) {
  *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
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

// -- the vector kernel ------------------------------------------------------

// 16 int8 values dequantized: byte j of word w is element 4w + j
// (little-endian), sign-extended by the arithmetic shift.
__device__ __forceinline__ void dequant4(int w, float s, float* v) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = (float)((int)((unsigned)w << (24 - 8 * j)) >> 24) * s;
}

__device__ __forceinline__ void dequant16(const int4 q, float s,
                                          float (&v)[16]) {
  dequant4(q.x, s, v);
  dequant4(q.y, s, v + 4);
  dequant4(q.z, s, v + 8);
  dequant4(q.w, s, v + 12);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// n values of v (a multiple of 8) at p in backing's dtype, by 16-byte
// streaming stores.
template <int n>
__device__ __forceinline__ void store_vals(float* p, const float* v) {
  float4* d = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int k = 0; k < n / 4; ++k)
    __stcs(d + k, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                              v[4 * k + 3]));
}

template <int n>
__device__ __forceinline__ void store_vals(__nv_bfloat16* p, const float* v) {
  int4* d = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int k = 0; k < n / 8; ++k)
    __stcs(d + k, make_int4((int)pack_bf16(v[8 * k], v[8 * k + 1]),
                            (int)pack_bf16(v[8 * k + 2], v[8 * k + 3]),
                            (int)pack_bf16(v[8 * k + 4], v[8 * k + 5]),
                            (int)pack_bf16(v[8 * k + 6], v[8 * k + 7])));
}

template <int n>
__device__ __forceinline__ void store_vals(int8_t* p, const float* v) {
  int4* d = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int k = 0; k < n / 16; ++k)
    __stcs(d + k, make_int4(
        (int)pack_i8(v[16 * k], v[16 * k + 1], v[16 * k + 2], v[16 * k + 3]),
        (int)pack_i8(v[16 * k + 4], v[16 * k + 5], v[16 * k + 6],
                     v[16 * k + 7]),
        (int)pack_i8(v[16 * k + 8], v[16 * k + 9], v[16 * k + 10],
                     v[16 * k + 11]),
        (int)pack_i8(v[16 * k + 12], v[16 * k + 13], v[16 * k + 14],
                     v[16 * k + 15])));
}

// n elements of backing (a multiple of 8; of 16 for int8) copied bit for
// bit.
template <int n, typename T>
__device__ __forceinline__ void copy_vals(T* dst, const T* src) {
  constexpr int kPieces = n * (int)sizeof(T) / 16;
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  int4 r[kPieces];
#pragma unroll
  for (int k = 0; k < kPieces; ++k) r[k] = __ldcs(s + k);
#pragma unroll
  for (int k = 0; k < kPieces; ++k) __stcs(d + k, r[k]);
}

__device__ __forceinline__ float sum_squares16(const float (&v)[16]) {
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) ss += v[j] * v[j];
  return ss;
}

// The margin of a page from each lane's sum of squares: the butterfly
// over the group's G lanes, then the formula.  Every lane of the warp
// must call it.
template <int G>
__device__ __forceinline__ float group_margin(float ss, float s, int E,
                                              float tau) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float rms = sqrtf(ss / (float)E + 1e-12f);
  return 1.0f - (0.5f * s) / (tau * rms);
}

// G lanes a page (a power of two, 1..32), U pages in flight a thread.
template <typename T, int G, int U>
__global__ void __launch_bounds__(kThreads)
kv_retry_vec_kernel(const int8_t* __restrict__ data_q,
                    const float* __restrict__ scale,
                    const T* __restrict__ backing, T* __restrict__ out,
                    float* __restrict__ margin, long long P, int E,
                    float tau) {
  constexpr int kGroups = kThreads / G;   // pages of a block, per slot
  constexpr int kTile = kGroups * U;      // pages of a block, per step
  const int li = threadIdx.x % G;
  const int gi = threadIdx.x / G;
  const bool active = li * 16 < E;
  const long long n_tiles = (P + kTile - 1) / kTile;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    long long page[U];
    int4 q[U];
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      page[u] = tile * kTile + u * kGroups + gi;
      q[u] = page[u] < P && active
                 ? __ldcs(reinterpret_cast<const int4*>(data_q + page[u] * E)
                          + li)
                 : make_int4(0, 0, 0, 0);
      s[u] = page[u] < P ? __ldcs(scale + page[u]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float v[16];
      dequant16(q[u], s[u], v);
      const float mg = group_margin<G>(sum_squares16(v), s[u], E, tau);
      if (page[u] >= P) continue;
      if (li == 0) __stcs(margin + page[u], mg);
      if (!active) continue;
      const long long at = page[u] * E + li * 16;
      if (mg >= 0.f)
        store_vals<16>(out + at, v);
      else
        copy_vals<16>(out + at, backing + at);
    }
  }
}

// Blocks of one kernel instance resident on the whole card.
template <typename K>
long long resident_blocks(K kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return (long long)sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T, int G, int U>
int launch_vec(const void* q, const void* s, const void* b, void* o, void* m,
               long long P, int E, float tau, cudaStream_t stream) {
  constexpr long long kTile = (long long)(kThreads / G) * U;
  static const long long resident =
      resident_blocks(kv_retry_vec_kernel<T, G, U>, kThreads, 0);
  const long long tiles = (P + kTile - 1) / kTile;
  const long long blocks = tiles < resident ? tiles : resident;
  kv_retry_vec_kernel<T, G, U><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const T*>(b), static_cast<T*>(o), static_cast<float*>(m),
      P, E, tau);
  return (int)cudaGetLastError();
}

// The vector kernel's instance for E's lanes a page.
template <typename T, int U>
int launch_vec_u(const void* q, const void* s, const void* b, void* o,
                 void* m, long long P, int E, float tau, cudaStream_t st) {
  const int chunks = E / 16;
  if (chunks <= 1) return launch_vec<T, 1, U>(q, s, b, o, m, P, E, tau, st);
  if (chunks <= 2) return launch_vec<T, 2, U>(q, s, b, o, m, P, E, tau, st);
  if (chunks <= 4) return launch_vec<T, 4, U>(q, s, b, o, m, P, E, tau, st);
  if (chunks <= 8) return launch_vec<T, 8, U>(q, s, b, o, m, P, E, tau, st);
  if (chunks <= 16) return launch_vec<T, 16, U>(q, s, b, o, m, P, E, tau, st);
  return launch_vec<T, 32, U>(q, s, b, o, m, P, E, tau, st);
}

// Whether the vector kernel takes these pages.
bool vec_ok(const void* q, const void* b, const void* o, int E) {
  return E % 16 == 0 && E <= kMaxVecWidth &&
         ((uintptr_t)q | (uintptr_t)b | (uintptr_t)o) % 16 == 0;
}

template <typename T>
int launch(const void* q, const void* s, const void* b, void* o, void* m,
           long long P, int E, float tau, int vector, cudaStream_t stream) {
  if (P == 0) return 0;
  if (vector) {
    if (!vec_ok(q, b, o, E)) return (int)cudaErrorInvalidValue;
    return launch_vec_u<T, kUnroll>(q, s, b, o, m, P, E, tau, stream);
  }
  const long long blocks = (P + kPagesPerBlock - 1) / kPagesPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kv_retry_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const T*>(b), static_cast<T*>(o), static_cast<float*>(m),
      P, E, tau);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of backing and out: 0 float32, 1 bfloat16, 2 int8.  vector 0
// launches the warp-per-page kernel (E a multiple of 4), 1 the vector
// kernel (E a multiple of 16 up to 512; the int8 pages, backing and out
// 16-byte aligned).
// Returns a cudaError_t (0 on success).
extern "C" int kv_retry_launch(const void* data_q, const void* scale,
                               const void* backing, void* out, void* margin,
                               long long P, int E, float tau, int dtype,
                               int vector, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || E % 4) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(data_q, scale, backing, out, margin, P, E, tau,
                         vector, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(data_q, scale, backing, out, margin, P, E,
                                 tau, vector, st);
  if (dtype == 2)
    return launch<int8_t>(data_q, scale, backing, out, margin, P, E, tau,
                          vector, st);
  return (int)cudaErrorInvalidValue;
}
