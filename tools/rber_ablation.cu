// Ablations of the RBER kernel, for tools/rber_ablation.py (not a kernel
// of the port).  The port's source is included whole; the variants here
// compute the same expressions in the same order, so their tables equal
// the port's bit for bit:
//
//   rber_flat_kernel: one thread per (page, entry), as the port's
//     kernel, but found by a 32-bit division, with the levels staged in
//     shared memory (kSmemLevels) or loaded by each thread, and blocks
//     of kBlock threads;
//   rber_tile_kernel: a block takes a tile of TP consecutive pages and
//     all S entries, with the S x 7 levels in shared memory; a page's
//     256 / TP threads keep its 8 means and 8 sigmas in registers and
//     take every (256 / TP)-th entry; the tile's three page-type tables
//     go to shared memory and leave as three contiguous runs of TP x S
//     floats.

#include "../src/repro_torch/kernels/rber/csrc/rber.cu"

namespace {

__device__ __forceinline__ void rber_unit(const float* m, const float* sg,
                                          const float* L, float* o) {
#pragma unroll
  for (int b = 0; b < 7; ++b) {
    const float up = 0.5f * erfcf((L[b] - m[b]) / sg[b] * kInvSqrt2);
    const float dn = 0.5f * erfcf((m[b + 1] - L[b]) / sg[b + 1] * kInvSqrt2);
    const float e = (up + dn) * 0.125f;
    const int p = (b == 0 || b == 4) ? 0 : (b == 2 || b == 6) ? 2 : 1;
    o[p] = o[p] + e;
  }
}

constexpr int kSmemBytes = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
rber_tile_kernel(const float* __restrict__ mu,
                 const float* __restrict__ sigma,
                 const float* __restrict__ levels, float* __restrict__ out,
                 int N, int S, int TP) {
  extern __shared__ float smem[];
  float* lv = smem;                 // S x 7 read levels
  float* tile = smem + S * 7;       // 3 x TP x S
  for (int i = threadIdx.x; i < S * 7; i += kThreads) lv[i] = levels[i];
  const int J = kThreads / TP;      // threads a page
  const int pl = threadIdx.x / J, j = threadIdx.x % J;
  const long long n0 = (long long)blockIdx.x * TP;
  const int rows = (int)(N - n0 < TP ? N - n0 : TP);
  __syncthreads();
  if (pl < rows) {
    float m[8], sg[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      m[b] = __ldg(mu + (n0 + pl) * 8 + b);
      sg[b] = __ldg(sigma + (n0 + pl) * 8 + b);
    }
    for (int s = j; s < S; s += J) {
      float o[3] = {0.f, 0.f, 0.f};
      rber_unit(m, sg, lv + s * 7, o);
#pragma unroll
      for (int p = 0; p < 3; ++p) tile[(p * TP + pl) * S + s] = o[p];
    }
  }
  __syncthreads();
  const long long NS = (long long)N * S;
  const int run = rows * S;
  for (int p = 0; p < 3; ++p) {
    float* dst = out + p * NS + n0 * S;
    const float* src = tile + p * TP * S;
    for (int i = threadIdx.x; i < run; i += kThreads) __stcs(dst + i, src[i]);
  }
}

template <int kBlock, bool kSmemLevels>
__global__ void __launch_bounds__(kBlock)
rber_flat_kernel(const float* __restrict__ mu,
                 const float* __restrict__ sigma,
                 const float* __restrict__ levels, float* __restrict__ out,
                 int N, int S) {
  extern __shared__ float lv[];
  if (kSmemLevels) {
    for (int i = threadIdx.x; i < S * 7; i += kBlock) lv[i] = levels[i];
    __syncthreads();
  }
  const int NS = N * S;
  const int idx = blockIdx.x * kBlock + threadIdx.x;
  if (idx >= NS) return;
  const int n = idx / S;
  const int s = idx - n * S;
  float m[8], sg[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    m[b] = __ldg(mu + n * 8 + b);
    sg[b] = __ldg(sigma + n * 8 + b);
  }
  float o[3] = {0.f, 0.f, 0.f};
  rber_unit(m, sg, kSmemLevels ? lv + s * 7 : levels + s * 7, o);
  __stcs(out + idx, o[0]);
  __stcs(out + NS + idx, o[1]);
  __stcs(out + 2 * NS + idx, o[2]);
}

template <int kBlock, bool kSmemLevels>
int launch_flat(const float* mu, const float* sg, const float* lv, float* out,
                int N, int S, cudaStream_t st) {
  const long long NS = (long long)N * S;
  const unsigned blocks = (unsigned)((NS + kBlock - 1) / kBlock);
  rber_flat_kernel<kBlock, kSmemLevels>
      <<<blocks, kBlock, kSmemLevels ? S * 7 * sizeof(float) : 0, st>>>(
          mu, sg, lv, out, N, S);
  return (int)cudaGetLastError();
}

}  // namespace

// variant 1: flat, levels in shared memory, blocks of 256; 2: the same,
// blocks of 128; 3: flat, levels loaded by each thread, blocks of 256;
// 100 + TP: the tiled kernel at TP pages a tile.
extern "C" int rber_ablation_launch(const void* mu, const void* sigma,
                                    const void* levels, void* out, int N,
                                    int S, int variant, void* stream) {
  const float* m = static_cast<const float*>(mu);
  const float* sg = static_cast<const float*>(sigma);
  const float* lv = static_cast<const float*>(levels);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long NS = (long long)N * S;
  if (N <= 0 || S <= 0 || NS >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 1: return launch_flat<256, true>(m, sg, lv, o, N, S, st);
    case 2: return launch_flat<128, true>(m, sg, lv, o, N, S, st);
    case 3: return launch_flat<256, false>(m, sg, lv, o, N, S, st);
  }
  const int TP = variant - 100;
  if (TP < 1 || TP > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * (7 + 3 * TP) * sizeof(float);
  if (smem > (size_t)kSmemBytes) return (int)cudaErrorInvalidValue;
  rber_tile_kernel<<<(unsigned)((N + TP - 1) / TP), kThreads, smem, st>>>(
      m, sg, lv, o, N, S, TP);
  return (int)cudaGetLastError();
}
