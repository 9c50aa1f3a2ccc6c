// Ablations of the KV retry read's vector kernel, for tools/kv_ablation.py
// (not a kernel of the port).  The port's source is included whole, so
// the variants here share its dequant, reduction and stores:
//
//   kv_retry_vec_kernel at 1 and 4 pages in flight a thread (the port
//     takes kUnroll = 2);
//   kv_retry_spread_kernel: a lane takes values 8 li .. 8 li + 7 and
//     8 G + 8 li .. of its page (E = 16 G), so that each 16-byte store
//     of a group is contiguous, from two 8-byte loads;
//   kv_retry_bulk_kernel: a persistent block a SM; one producer thread
//     keeps kBulkStages tiles of int8 pages and scales in flight by 1-D
//     bulk copies (cp.async.bulk, completed on an mbarrier) in a ring in
//     shared memory; 8 consumer warps dequantize from there into an
//     output tile in shared memory, which one thread writes back by a
//     bulk store; retried pages read their backing directly.
//
// All take the vector kernel's summation order, so their outputs and
// margins equal the port's bit for bit.

#include "../src/repro_torch/kernels/kv_retry/csrc/kv_retry.cu"
#include "hopper.cuh"

namespace {

template <typename T, int G, int U>
__global__ void __launch_bounds__(kThreads)
kv_retry_spread_kernel(const int8_t* __restrict__ data_q,
                       const float* __restrict__ scale,
                       const T* __restrict__ backing, T* __restrict__ out,
                       float* __restrict__ margin, long long P, int E,
                       float tau) {
  constexpr int kGroups = kThreads / G;
  constexpr int kTile = kGroups * U;
  const int li = threadIdx.x % G;
  const int gi = threadIdx.x / G;
  const long long n_tiles = (P + kTile - 1) / kTile;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    long long page[U];
    int4 q[U];
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      page[u] = tile * kTile + u * kGroups + gi;
      const bool ok = page[u] < P;
      const int2* qp = reinterpret_cast<const int2*>(data_q + page[u] * E);
      const int2 a = ok ? __ldcs(qp + li) : make_int2(0, 0);
      const int2 b = ok ? __ldcs(qp + G + li) : make_int2(0, 0);
      q[u] = make_int4(a.x, a.y, b.x, b.y);
      s[u] = ok ? __ldcs(scale + page[u]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float v[16];
      dequant16(q[u], s[u], v);
      const float mg = group_margin<G>(sum_squares16(v), s[u], E, tau);
      if (page[u] >= P) continue;
      if (li == 0) __stcs(margin + page[u], mg);
      const long long a = page[u] * E + li * 8, b = a + 8 * G;
      if (mg >= 0.f) {
        store_vals<8>(out + a, v);
        store_vals<8>(out + b, v + 8);
      } else {
        copy_vals<8>(out + a, backing + a);
        copy_vals<8>(out + b, backing + b);
      }
    }
  }
}

// 16 outputs, or 16 backing values copied, into shared memory.
__device__ __forceinline__ void smem_store16(float* p, const float* v) {
  float4* d = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

__device__ __forceinline__ void smem_store16(__nv_bfloat16* p,
                                             const float* v) {
  int4* d = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    d[k] = make_int4((int)pack_bf16(v[8 * k], v[8 * k + 1]),
                     (int)pack_bf16(v[8 * k + 2], v[8 * k + 3]),
                     (int)pack_bf16(v[8 * k + 4], v[8 * k + 5]),
                     (int)pack_bf16(v[8 * k + 6], v[8 * k + 7]));
}

template <typename T>
__device__ __forceinline__ void smem_copy16(T* dst, const T* src) {
  constexpr int kPieces = (int)sizeof(T);
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  int4 r[kPieces];
#pragma unroll
  for (int k = 0; k < kPieces; ++k) r[k] = __ldcs(s + k);
#pragma unroll
  for (int k = 0; k < kPieces; ++k) d[k] = r[k];
}

constexpr int kBulkTileBytes = 16384;   // int8 bytes of a tile
constexpr int kBulkStages = 4;
constexpr int kBulkConsumers = 256;
constexpr int kBulkThreads = kBulkConsumers + 32;

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
        "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kBulkConsumers) : "memory");
}

template <typename T, int E>
struct BulkLayout {
  static constexpr int kPages = kBulkTileBytes / E;
  static constexpr int kScale = kPages * 4;
  static constexpr int kOut = kPages * E * (int)sizeof(T);
  static constexpr int kOutAt = kBulkStages * (kBulkTileBytes + kScale);
  static constexpr int kBarAt = kOutAt + 2 * kOut;
  static constexpr int kBytes = kBarAt + 2 * kBulkStages * 8;
};

// A persistent block a SM: one producer thread keeps kBulkStages tiles of
// int8 pages and scales in flight by 1-D bulk copies (mbarrier
// completion); 8 consumer warps dequantize from shared memory into an
// output tile there, which one thread writes back by a bulk store.  The
// pages past the last whole tile are read directly by the last block.
template <typename T, int E>
__global__ void __launch_bounds__(kBulkThreads, 1)
kv_retry_bulk_kernel(const int8_t* __restrict__ data_q,
                     const float* __restrict__ scale,
                     const T* __restrict__ backing, T* __restrict__ out,
                     float* __restrict__ margin, long long P, float tau) {
  using L = BulkLayout<T, E>;
  constexpr int G = E / 16;
  constexpr int kSlots = kBulkConsumers / G;
  constexpr int kPasses = L::kPages / kSlots;
  extern __shared__ __align__(128) unsigned char smem[];
  const int8_t* sq = reinterpret_cast<const int8_t*>(smem);
  const float* ssc =
      reinterpret_cast<const float*>(smem + kBulkStages * kBulkTileBytes);
  T* so = reinterpret_cast<T*>(smem + L::kOutAt);
  const uint32_t full0 = hopper::smem_u32(smem + L::kBarAt);
  const uint32_t empty0 = full0 + 8 * kBulkStages;
  const long long n_tiles = P / L::kPages;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kBulkStages; ++st) {
      hopper::mbar_init(full0 + 8 * st, 1);
      hopper::mbar_init(empty0 + 8 * st, kBulkConsumers / 32);
    }
  }
  __syncthreads();
  if (threadIdx.x >= kBulkConsumers) {
    if (threadIdx.x != kBulkConsumers) return;
    int i = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
      const int st = i % kBulkStages;
      if (i >= kBulkStages)
        hopper::mbar_wait(empty0 + 8 * st, ((i / kBulkStages) - 1) & 1);
      hopper::mbar_expect_tx(full0 + 8 * st, kBulkTileBytes + L::kScale);
      bulk_load(hopper::smem_u32(sq + st * kBulkTileBytes),
                data_q + t * kBulkTileBytes, kBulkTileBytes, full0 + 8 * st);
      bulk_load(hopper::smem_u32(ssc + st * L::kPages),
                scale + t * L::kPages, L::kScale, full0 + 8 * st);
    }
    return;
  }
  const int li = threadIdx.x % G, gi = threadIdx.x / G;
  int i = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
    const int st = i % kBulkStages;
    T* to = so + (i & 1) * L::kPages * E;
    if (i >= 2) {
      if (threadIdx.x == 0) bulk_wait_read<1>();
      consumers_sync();
    }
    hopper::mbar_wait(full0 + 8 * st, (i / kBulkStages) & 1);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int lp = p * kSlots + gi;
      const int4 qv = *reinterpret_cast<const int4*>(
          sq + st * kBulkTileBytes + lp * E + li * 16);
      const float s = ssc[st * L::kPages + lp];
      float v[16];
      dequant16(qv, s, v);
      const float mg = group_margin<G>(sum_squares16(v), s, E, tau);
      const long long page = t * L::kPages + lp;
      if (li == 0) __stcs(margin + page, mg);
      if (mg >= 0.f)
        smem_store16(to + lp * E + li * 16, v);
      else
        smem_copy16(to + lp * E + li * 16, backing + page * E + li * 16);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(empty0 + 8 * st);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
    if (threadIdx.x == 0)
      bulk_store(out + t * L::kPages * E, hopper::smem_u32(to), L::kOut);
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  if (blockIdx.x != gridDim.x - 1) return;
  for (long long base = n_tiles * L::kPages; base < P; base += kSlots) {
    const long long page = base + gi;
    const bool ok = page < P;
    const int4 qv = ok ? __ldcs(reinterpret_cast<const int4*>(
                             data_q + page * E) + li)
                       : make_int4(0, 0, 0, 0);
    const float s = ok ? __ldcs(scale + page) : 0.f;
    float v[16];
    dequant16(qv, s, v);
    const float mg = group_margin<G>(sum_squares16(v), s, E, tau);
    if (!ok) continue;
    if (li == 0) __stcs(margin + page, mg);
    const long long at = page * E + li * 16;
    if (mg >= 0.f)
      store_vals<16>(out + at, v);
    else
      copy_vals<16>(out + at, backing + at);
  }
}

template <typename T, int G, int U>
int launch_spread(const void* q, const void* s, const void* b, void* o,
                  void* m, long long P, int E, float tau, cudaStream_t st) {
  constexpr long long kTile = (long long)(kThreads / G) * U;
  static const long long resident =
      resident_blocks(kv_retry_spread_kernel<T, G, U>, kThreads, 0);
  const long long tiles = (P + kTile - 1) / kTile;
  const long long blocks = tiles < resident ? tiles : resident;
  kv_retry_spread_kernel<T, G, U><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const T*>(b), static_cast<T*>(o), static_cast<float*>(m),
      P, E, tau);
  return (int)cudaGetLastError();
}

template <typename T, int E>
int launch_bulk(const void* q, const void* s, const void* b, void* o,
                void* m, long long P, float tau, cudaStream_t stream) {
  using L = BulkLayout<T, E>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kv_retry_bulk_kernel<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  static const long long resident = resident_blocks(
      kv_retry_bulk_kernel<T, E>, kBulkThreads, L::kBytes);
  const long long tiles = P / L::kPages;
  long long blocks = tiles < resident ? tiles : resident;
  if (blocks < 1) blocks = 1;
  kv_retry_bulk_kernel<T, E><<<(unsigned)blocks, kBulkThreads, L::kBytes,
                               stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const T*>(b), static_cast<T*>(o), static_cast<float*>(m),
      P, tau);
  return (int)cudaGetLastError();
}

template <typename T, int E>
int launch_variant(const void* q, const void* s, const void* b, void* o,
                   void* m, long long P, float tau, int variant,
                   cudaStream_t st) {
  constexpr int G = E / 16;
  switch (variant) {
    case 1: return launch_vec<T, G, 1>(q, s, b, o, m, P, E, tau, st);
    case 4: return launch_vec<T, G, 4>(q, s, b, o, m, P, E, tau, st);
    case 5: return launch_spread<T, G, kUnroll>(q, s, b, o, m, P, E, tau, st);
    case 6: return launch_bulk<T, E>(q, s, b, o, m, P, tau, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_ablation(const void* q, const void* s, const void* b, void* o,
                    void* m, long long P, int E, float tau, int variant,
                    cudaStream_t st) {
  if (P == 0) return 0;
  if (!vec_ok(q, b, o, E) || (uintptr_t)s % 16)
    return (int)cudaErrorInvalidValue;
  switch (E) {
    case 64: return launch_variant<T, 64>(q, s, b, o, m, P, tau, variant, st);
    case 128: return launch_variant<T, 128>(q, s, b, o, m, P, tau, variant, st);
    case 256: return launch_variant<T, 256>(q, s, b, o, m, P, tau, variant, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// As kv_retry_launch, for E 64, 128 or 256 and 16-byte aligned scales too:
// variant 1 and 4 the vector kernel with that many pages in flight a
// thread, 5 the spread halves, 6 the bulk kernel.
extern "C" int kv_ablation_launch(const void* data_q, const void* scale,
                                  const void* backing, void* out,
                                  void* margin, long long P, int E,
                                  float tau, int dtype, int variant,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ablation<float>(data_q, scale, backing, out, margin, P, E,
                                  tau, variant, st);
  if (dtype == 1)
    return launch_ablation<__nv_bfloat16>(data_q, scale, backing, out,
                                          margin, P, E, tau, variant, st);
  return (int)cudaErrorInvalidValue;
}
