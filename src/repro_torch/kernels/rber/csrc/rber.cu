// RBER table of a page population over a retry table, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rber/kernel.py::
// _rber_kernel (entry rber_pallas).  For page n (level means and sigmas
// mu, sigma: (N, 8)) and retry entry s (read levels: (S, 7)), boundary b
// contributes
//
//   e_b = (erfc((L_sb - mu_b) / sigma_b * 1/sqrt2) / 2
//          + erfc((mu_b+1 - L_sb) / sigma_b+1 * 1/sqrt2) / 2) * 0.125
//
// and each TLC page type adds the boundaries it senses to 0, in order:
// lsb {0, 4}, csb {1, 3, 5}, msb {2, 6}.  out is (3, N, S) float32.
//
// Design.  One thread per (n, s), in the reference's arithmetic order,
// with CUDA's erfcf; the masks partition the seven boundaries, so each
// boundary's term goes to one page type's sum.  Consecutive threads take
// consecutive entries s of one page, so the three stores of a warp are
// contiguous.
//
// Bound.  14 erfcf and 14 IEEE divisions a thread against 12 bytes
// written: bound by operations (the float32 pipes), not bytes.
// chip_smoke.py counts them from the SASS of the probes below: about
// 1 100 float32 operations a thread (an FFMA two), 0.0138 ms at the
// characterization's size (20 480 pages x 41 entries).  On the H100 the
// kernel takes 0.029 ms alone, 47% of that: half the float instructions
// of erfcf are not fused multiply-adds, so the issue slots, not the
// flops, hold it (about 750 float instructions a thread, some 19 us at
// one instruction a lane a clock).  tools/rber_ablation.cu holds the
// designs measured against it, none faster: a 32-bit index, the levels
// in shared memory, and tiles of pages x all entries with a page's
// means and sigmas in registers across its entries.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.7071067811865475f;

__global__ void __launch_bounds__(kThreads)
rber_kernel(const float* __restrict__ mu, const float* __restrict__ sigma,
            const float* __restrict__ levels, float* __restrict__ out,
            int N, int S) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long NS = (long long)N * S;
  if (idx >= NS) return;
  const int n = (int)(idx / S);
  const int s = (int)(idx - (long long)n * S);
  const float* m = mu + (size_t)n * 8;
  const float* sg = sigma + (size_t)n * 8;
  const float* lv = levels + (size_t)s * 7;
  float o[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int b = 0; b < 7; ++b) {
    const float L = lv[b];
    const float up = 0.5f * erfcf((L - m[b]) / sg[b] * kInvSqrt2);
    const float dn = 0.5f * erfcf((m[b + 1] - L) / sg[b + 1] * kInvSqrt2);
    const float e = (up + dn) * 0.125f;
    const int p = (b == 0 || b == 4) ? 0 : (b == 2 || b == 6) ? 2 : 1;
    o[p] = o[p] + e;
  }
  out[idx] = o[0];
  out[NS + idx] = o[1];
  out[2 * NS + idx] = o[2];
}

}  // namespace

// Probes, never launched: the SASS of one erfcf and of one IEEE float32
// division, each counted against rber_probe_base (the same loads, add
// and store) by chip_smoke.py to count the operations in the bound.
extern "C" __global__ void rber_probe_base(const float* x, float* y) {
  y[threadIdx.x] = x[threadIdx.x] + x[threadIdx.x + 32];
}

extern "C" __global__ void rber_probe_erfc(const float* x, float* y) {
  y[threadIdx.x] = erfcf(x[threadIdx.x]) + x[threadIdx.x + 32];
}

extern "C" __global__ void rber_probe_div(const float* x, float* y) {
  y[threadIdx.x] = x[threadIdx.x] / x[threadIdx.x + 32];
}

// Returns a cudaError_t (0 on success).
extern "C" int rber_launch(const void* mu, const void* sigma,
                           const void* levels, void* out, int N, int S,
                           void* stream) {
  if (N < 0 || S < 0) return (int)cudaErrorInvalidValue;
  const long long NS = (long long)N * S;
  if (NS == 0) return 0;
  const long long blocks = (NS + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rber_kernel<<<(unsigned)blocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(sigma),
      static_cast<const float*>(levels), static_cast<float*>(out), N, S);
  return (int)cudaGetLastError();
}
