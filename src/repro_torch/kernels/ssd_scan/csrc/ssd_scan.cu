// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py::
// _ssd_kernel (entry ssd_scan_fwd).  It computes what that kernel
// computes, not block for block.  Per row bh and chunk of L tokens, in
// float32:
//
//   cum    = cumsum(dA)                       (dA = dt * A, <= 0)
//   w      = tril((C . B^T) * exp(clip(cum_i - cum_j, -60, 0)))
//   y      = w . (x * dt) + (C . H) * exp(clip(cum, -60, 0))
//   H     <- H * exp(clip(total, -60, 0)) + B^T . ((x * dt) * seg)
//
// with total = cum[L - 1] and seg = exp(clip(total - cum, -60, 0)).  The
// y of a chunk reads H from before that chunk's update.  Tokens at or
// past T read as zero with dt = dA = 0, which is the reference's padding
// of T to a multiple of L: they are inert.  y is written in x's dtype, H
// as float32 (BH, ds, hd).
//
// x is (BH, T, hd); B and C are (BG, T, ds), shared by the G = BH / BG
// heads of a batch row: row bh reads row bh / G, so the per-head copies
// the reference's adapter broadcasts are never made.  dt and dA are
// float32.  cum is taken in one order everywhere: one warp, a sequential
// run of ceil(L / 32) values per lane, then a shuffle scan of the lanes'
// sums; the plain version's chunk_cumsum restates it, since two orders
// round |cum| (hundreds, late in a chunk) differently.
//
// Bound.  The work is 2 L(L+1)/2 ds flops per batch row and chunk (the
// scores) plus 2 L(L+1)/2 hd + 4 L ds hd per head, against about
// (2 hd + 2 ds / G + 8) T bytes per row.  At the Mamba-2 widths (hd 64,
// ds 128, L 256, G 24) that is ~200 flops a byte: bound by bytes on the
// tensor cores (989 TFLOP/s bf16), by operations on the float32 pipes
// (67 TFLOP/s).  Two paths, chosen by dtype and shape (ops.py says which):
//
// bfloat16, hd 64, ds 64 or 128, chunks of at most 256 tokens that are a
// multiple of 64 long (or one chunk): the tensor-core path, four
// kernels, cut as Dao & Gu cut the SSD scan for GPUs (arXiv:2405.21060,
// section 7): the chunks' quadratic work in parallel, only the state
// carried in order.
//   Rounding decides what runs where.  y is held element by element to
//   one bf16 ulp of the plain version plus 2^-8 of its row's rms.  On a
//   left-padded prompt (mamba2-130m's long set) C and B are nearly
//   orthogonal: the scores and C_q . H_{c-1} cancel, and a row's rms
//   falls to ~1e-8.  There y stays inside the rule only if the scores,
//   S and C . H round as the plain version's float32 products do.  On
//   the card those products are cuBLAS's SGEMM, which at these shapes
//   sums over k with one fused multiply-add after another, from 0: the
//   chains below take that order (phase 9 of chip_smoke.py reads H's
//   ratio as 0, bit for bit).  The order is cuBLAS's choice, not
//   plain.py's: a torch build whose SGEMM splits k, or sums it in
//   another order, can fail phase 9 on those rows while this kernel
//   stays correct.  Over the 24 launches of
//   that prefill (tools/ssd_rounding.py): the scores summed as wgmma sums
//   them (its float32 accumulation truncates) miss by 4.9x the
//   tolerance, S from three bf16 parts and an exact C . H by 2.0x, C . H
//   from two bf16 parts of H by 24x; the float32 products stay at 0.92.
//   w' . x does not cancel so: it alone goes to the tensor cores.
//   1. chunk states, one block a (row, chunk, 64 state rows), float32
//      SIMT, the chunks in parallel: cum by the warp scan
//      (written out for kernel 4), seg, (x * dt) * seg, and S_c = B^T .
//      that as a chain of fused multiply-adds over the tokens.
//   2. ssd_pass_kernel, one thread a (row, state element), serial over
//      the chunks: H <- H * g + S_c, each chunk's incoming H written
//      out, and the last H (skipped with one chunk, where H is S).
//   3. scores, one block a (batch row, chunk, query tile, key tile at
//      or below it), float32 SIMT: the 64 x 64 scores C_q . B_k^T,
//      shared by the row's heads (B and C are), written in the chunk
//      scan's register-fragment order.  Kernels 1 and 3 are one launch,
//      ssd_state_scores_kernel, whose blocks take either.
//   4. ssd_scan_tc_kernel, one block of two warpgroups a (batch row,
//      chunk, 64-query tile, group of heads), longest query tiles first:
//      its scores in registers, their key tiles split between the two
//      warpgroups; then for each head its x tiles (TMA) and incoming
//      state (one bulk copy) into a two-stage ring, the next head's
//      loads in flight during this one's work.  Each warpgroup forms
//      w' = scores * exp(clip(cum_i - cum_j)) * dt_j for its key tiles,
//      the mask key <= query written explicitly, as two bf16 parts in
//      the register-A fragment (w' rounded to bf16 alone fails the
//      element-wise bf16 rule, as B4's p does) and multiplies them by
//      wgmma into the exact bf16 x, each 16-key step's products in
//      flight while the next step's w' is formed.  The carried-state
//      term C_q . H_{c-1} is a float32 chain on the SIMT pipes; y = (the
//      two warpgroups' parts) + (C . H) * exp(clip(cum_i)), in the plain
//      version's order, stored in bf16.  Decays of w' use __expf
//      (relative error ~2e-6, inside the rule even on those rows); the
//      rest uses expf.
//   Nothing is summed with atomics: two launches give equal bits.
//
// float32 (and bf16 shapes outside the rule above): ssd_scan_kernel,
// the first port's SIMT kernel.  One block of 256 threads per row bh
// walks its chunks in order and keeps H (ds x hd float32) in shared
// memory.  A chunk's L x L score matrix does not fit, so the chunk is
// cut into 64-token tiles, as flash attention cuts keys: for each
// 64-row query tile, C's tile is loaded, its carried-state term C . H is
// computed, and then for each key tile at or below the diagonal the
// 64 x 64 scores are formed in registers, masked (key <= query, written
// explicitly), decayed, put in shared memory and multiplied into the
// query tile's accumulator with the key tile's x * dt.  After every
// query tile of the chunk, the state update walks the key tiles once
// more with (x * dt) * seg.  Every product is a scalar float32 fmaf
// (kept fused under the shared -fmad=false); one block a row leaves SMs
// idle at 96 rows, and the scores are recomputed by every head.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may use
constexpr float kClip = -60.f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// exp(clip(v, -60, 0)), clip as jnp.clip: min(max(v, lo), hi).
__device__ __forceinline__ float clip_exp(float v) {
  return expf(fminf(fmaxf(v, kClip), 0.f));
}

// Inclusive cumulative sum of cum[0 .. L) in place, by one warp: a
// sequential run of ceil(L / 32) values per lane, a shuffle scan of the
// runs' sums, then each run again from its exclusive offset.  Both paths
// take this order, and the plain version's chunk_cumsum restates it.
__device__ __forceinline__ void warp_cumsum(float* cum, int L, int lane) {
  const int per = (L + 31) / 32;
  const int beg = min(L, lane * per);
  const int end = min(L, beg + per);
  float sum = 0.f;
  for (int t = beg; t < end; ++t) sum += cum[t];
  float incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.f;
  for (int t = beg; t < end; ++t) {
    run += cum[t];
    cum[t] = run;
  }
}

// fma of a scalar into four lanes.
__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Rows [r0, r0 + 64) of a (rows, width) matrix into shared memory as
// float32 with row stride ``stride``; rows at or past r0 + n_valid are
// zero.  width is a multiple of 4.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* src,
                                          int width, int r0, int n_valid) {
  const int vec = width / 4;
  for (int idx = threadIdx.x; idx < kTile * vec; idx += kThreads) {
    const int r = idx / vec;
    const int c = (idx - r * vec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) v = load4(src + (size_t)(r0 + r) * width + c);
    store4(dst + r * stride + c, v);
  }
}

// Rows [r0, r0 + 64) of x as float32 times dt (and then times seg, when
// seg is given), row stride HD + 4; rows at or past r0 + n_valid are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_x(float* dst, const T* src, int r0,
                                       int n_valid, const float* dts,
                                       const float* seg) {
  constexpr int kVec = HD / 4;
  for (int idx = threadIdx.x; idx < kTile * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx - r * kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) {
      v = load4(src + (size_t)(r0 + r) * HD + c);
      const float d = dts[r0 + r];
      v.x *= d;
      v.y *= d;
      v.z *= d;
      v.w *= d;
      if (seg != nullptr) {
        const float s = seg[r0 + r];
        v.x *= s;
        v.y *= s;
        v.z *= s;
        v.w *= s;
      }
    }
    store4(dst + r * (HD + 4) + c, v);
  }
}

size_t smem_bytes(int hd, int ds, int L) {
  return sizeof(float) *
         ((size_t)ds * hd + 2 * (size_t)kTile * (ds + 4) +
          (size_t)kTile * (kTile + 4) + (size_t)kTile * (hd + 4) +
          4 * (size_t)L);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ dA, T* __restrict__ y,
                float* __restrict__ Hout, int T_, int ds, int G, int L,
                int nc) {
  constexpr int CG = HD / 4;           // float4 column groups of a row
  constexpr int RT = kThreads / CG;    // threads down the rows
  constexpr int R = kTile / RT;        // y rows a thread owns
  extern __shared__ float smem[];
  const int cs = ds + 4;
  float* Hs = smem;                          // (ds, HD)
  float* Cs = Hs + ds * HD;                  // (64, ds + 4)
  float* Bs = Cs + kTile * cs;               // (64, ds + 4)
  float* Ws = Bs + kTile * cs;               // (64, 64 + 4)
  float* Xs = Ws + kTile * (kTile + 4);      // (64, HD + 4)
  float* dts = Xs + kTile * (HD + 4);        // (L,) each
  float* cum = dts + L;
  float* ecum = cum + L;
  float* seg = ecum + L;

  const int bh = blockIdx.x;
  const T* xb = x + (size_t)bh * T_ * HD;
  const T* Bb = Bm + (size_t)(bh / G) * T_ * ds;
  const T* Cb = Cm + (size_t)(bh / G) * T_ * ds;
  const float* dtb = dt + (size_t)bh * T_;
  const float* dab = dA + (size_t)bh * T_;
  T* yb = y + (size_t)bh * T_ * HD;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;             // scores: query rows ty + 16 i
  const int tx = tid & 15;             //         key rows tx + 16 j
  const int cg = tid % CG;             // y and H: columns cg*4 .. cg*4 + 3
  const int rt = tid / CG;             //          rows rt + RT i
  const int lane = tid & 31;

  for (int i = tid; i < ds * HD; i += kThreads) Hs[i] = 0.f;
  const int n_tiles = (L + kTile - 1) / kTile;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    const int n_chunk = min(L, T_ - t0);     // real tokens of this chunk
    const T* xc = xb + (size_t)t0 * HD;
    const T* Bc = Bb + (size_t)t0 * ds;
    const T* Cc = Cb + (size_t)t0 * ds;
    __syncthreads();                   // the last chunk's reads are done
    for (int t = tid; t < L; t += kThreads) {
      const bool ok = t < n_chunk;
      dts[t] = ok ? dtb[t0 + t] : 0.f;
      cum[t] = ok ? dab[t0 + t] : 0.f;
    }
    __syncthreads();
    if (tid < 32) warp_cumsum(cum, L, lane);
    __syncthreads();
    const float total = cum[L - 1];
    for (int t = tid; t < L; t += kThreads) {
      ecum[t] = clip_exp(cum[t]);
      seg[t] = clip_exp(total - cum[t]);
    }

    // y, one 64-row query tile at a time, from the state before the chunk.
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      const int nq = min(kTile, n_chunk - q0);
      if (nq <= 0) break;              // the rest of the chunk is padding
      __syncthreads();                 // Cs is free; ecum and seg written
      load_rows(Cs, cs, Cc, ds, q0, nq);
      __syncthreads();

      float4 ch[R], acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        ch[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int d = 0; d < ds; d += 4) {          // C . H
        float4 ca[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
          ca[i] = *reinterpret_cast<const float4*>(Cs + (rt + RT * i) * cs + d);
#pragma unroll
        for (int dq = 0; dq < 4; ++dq) {
          const float4 hv =
              *reinterpret_cast<const float4*>(Hs + (d + dq) * HD + cg * 4);
#pragma unroll
          for (int i = 0; i < R; ++i) fma4(ch[i], at(ca[i], dq), hv);
        }
      }

      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kTile;
        const int nk = min(kTile, n_chunk - k0);
        load_rows(Bs, cs, Bc, ds, k0, nk);
        load_x<T, HD>(Xs, xc, k0, nk, dts, nullptr);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int d = 0; d < ds; d += 4) {        // scores = C . B^T
          float4 qa[4], ka[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qa[i] = *reinterpret_cast<const float4*>(Cs + (ty + 16 * i) * cs + d);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ka[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * cs + d);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
              s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
              s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
              s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj = k0 + tx + 16 * j;
            // The upper triangle is masked here, not left to the clip.
            const float w = (qi < L && kj <= qi)
                                ? s[i][j] * clip_exp(cum[qi] - cum[kj])
                                : 0.f;
            Ws[(ty + 16 * i) * (kTile + 4) + tx + 16 * j] = w;
          }
        }
        __syncthreads();

        for (int jj = 0; jj < kTile; jj += 4) {  // acc += w . (x * dt)
          float4 wa[R];
#pragma unroll
          for (int i = 0; i < R; ++i)
            wa[i] = *reinterpret_cast<const float4*>(
                Ws + (rt + RT * i) * (kTile + 4) + jj);
#pragma unroll
          for (int jq = 0; jq < 4; ++jq) {
            const float4 xv = *reinterpret_cast<const float4*>(
                Xs + (jj + jq) * (HD + 4) + cg * 4);
#pragma unroll
            for (int i = 0; i < R; ++i) fma4(acc[i], at(wa[i], jq), xv);
          }
        }
        __syncthreads();               // Bs, Xs and Ws are free again
      }

#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = rt + RT * i;
        if (r >= nq) continue;
        const float e = ecum[q0 + r];
        const float4 a = acc[i], h = ch[i];
        store4(yb + (size_t)(t0 + q0 + r) * HD + cg * 4,
               make_float4(a.x + h.x * e, a.y + h.y * e, a.z + h.z * e,
                           a.w + h.w * e));
      }
    }

    // H <- H * exp(total) + B^T . ((x * dt) * seg), one key tile at a time.
    const float g = clip_exp(total);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kTile;
      const int nk = min(kTile, n_chunk - k0);
      if (nk <= 0 && kt > 0) break;
      __syncthreads();                 // Bs and Xs are free
      load_rows(Bs, cs, Bc, ds, k0, nk);
      load_x<T, HD>(Xs, xc, k0, nk, dts, seg);
      __syncthreads();
      for (int d = rt; d < ds; d += RT) {
        float4 h = *reinterpret_cast<const float4*>(Hs + d * HD + cg * 4);
        if (kt == 0) {
          h.x *= g;
          h.y *= g;
          h.z *= g;
          h.w *= g;
        }
        for (int j = 0; j < kTile; ++j) {
          const float4 xv =
              *reinterpret_cast<const float4*>(Xs + j * (HD + 4) + cg * 4);
          fma4(h, Bs[j * cs + d], xv);
        }
        store4(Hs + d * HD + cg * 4, h);
      }
    }
  }

  __syncthreads();
  float* hb = Hout + (size_t)bh * ds * HD;
  for (int i = tid; i < ds * HD; i += kThreads) hb[i] = Hs[i];
}

template <typename T, int HD>
int launch(const void* x, const void* Bm, const void* Cm, const void* dt,
           const void* dA, void* y, void* H, int BH, int T_, int ds, int G,
           int L, cudaStream_t stream) {
  const size_t smem = smem_bytes(HD, ds, L);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ssd_scan_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = (T_ + L - 1) / L;
  kernel<<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(dt),
      static_cast<const float*>(dA), static_cast<T*>(y),
      static_cast<float*>(H), T_, ds, G, L, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* x, const void* Bm, const void* Cm,
              const void* dt, const void* dA, void* y, void* H, int BH,
              int T_, int ds, int G, int L, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(x, Bm, Cm, dt, dA, y, H, BH, T_, ds, G, L, stream);
    case 32:
      return launch<T, 32>(x, Bm, Cm, dt, dA, y, H, BH, T_, ds, G, L, stream);
    case 64:
      return launch<T, 64>(x, Bm, Cm, dt, dA, y, H, BH, T_, ds, G, L, stream);
    case 128:
      return launch<T, 128>(x, Bm, Cm, dt, dA, y, H, BH, T_, ds, G, L, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------
// bfloat16: the tensor-core path.

namespace tc {

using namespace hopper;

constexpr int kMaxL = 256;      // longest chunk
constexpr int kHD = 64;         // head dim of the path: one 128-byte row

// `bytes` contiguous bytes (a multiple of 16) into shared memory,
// completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Four bytes from global to shared memory, asynchronously; zeros where
// `valid` is false (the source is then not read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Sixteen bytes from global to shared memory, asynchronously; zeros
// where `valid` is false (the source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The m64n64k16 bf16 -> f32 wgmma forms, operand lists written out.
// Fragment layout of the f32 accumulator: d[4i + 2h + j] is row
// 16 * warp + lane / 4 + 8h, column 8i + 2 (lane % 4) + j.  The
// register-A fragment of a 16-column step: a[2m + h] holds columns
// 8m + 2 (lane % 4) + {0, 1} of row 16 * warp + lane / 4 + 8h, the lower
// column in the lower half.
#define SSD_ACC32                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31])
#define SSD_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// D (+)= A . B, A (64 x 16) from registers, B (16 x 64) MN-major in
// shared memory; D is overwritten where scale_d is 0.
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SSD_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef SSD_ACC32
#undef SSD_D32

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as two bf16 parts: hi = bf16(v), lo = bf16(v - hi); v - hi is
// exact in f32, and hi + lo is within 2^-17 of v.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// exp(clip(v, -60, 0)) by ex2.approx: for y's decays only.
__device__ __forceinline__ float clip_exp_fast(float v) {
  return __expf(fminf(fmaxf(v, kClip), 0.f));
}

__device__ __forceinline__ uint32_t align1024(uint32_t a) {
  return (a + 1023u) & ~1023u;
}

// ----- 1, 2. chunk states and state passing -----------------------------

template <int DS>
struct StateCfg {
  static constexpr int THREADS = 256;
  static constexpr int B_BYTES = kMaxL * 64 * 2;      // 64 state rows of B
  static constexpr int XS_BYTES = kMaxL * kHD * 4;    // (x * dt) * seg
  static constexpr int SMEM = B_BYTES + XS_BYTES + 3 * kMaxL * 4;
};

// Block (row bh, chunk c, state rows d0 .. d0 + 63), 256 threads: cum
// by the warp scan (written out by the first of a chunk's blocks), seg,
// xs = (x * dt) * seg, and the chunk's state S = B^T . xs as one fused
// multiply-add after another over the tokens from 0 — the plain
// version's roundings, in float32 — into S (BH, nc, DS, 64).  Thread:
// rows d0 + 4 dg .. + 3, columns 4 ng .. + 3, so a warp reads 16 rows of
// B and two column groups of xs, broadcast.
template <int DS>
__device__ __forceinline__ void chunk_state_block(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ Bm,
    const float* __restrict__ dt, const float* __restrict__ dA,
    float* __restrict__ cum_out, float* __restrict__ S, int T_, int G, int L,
    int nc, int blk, uint8_t* smem_raw) {
  using C = StateCfg<DS>;
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw + C::B_BYTES);
  float* cum = xs + kMaxL * kHD;
  float* dts = cum + kMaxL;
  float* seg = dts + kMaxL;

  constexpr int NDB = DS / 64;
  const int d0 = 64 * (blk % NDB);
  const int c = (blk / NDB) % nc;
  const int bh = blk / (NDB * nc);
  const int t0 = c * L;
  const int n_chunk = min(L, T_ - t0);     // real tokens of this chunk
  const int tid = threadIdx.x, lane = tid % 32;
  const int dg = tid % 16, ng = tid / 16;
  const __nv_bfloat16* xb = x + ((size_t)bh * T_ + t0) * kHD;
  const __nv_bfloat16* Bb = Bm + ((size_t)(bh / G) * T_ + t0) * DS + d0;

  for (int idx = tid; idx < n_chunk * 8; idx += C::THREADS) {
    const int j = idx / 8, v = idx % 8;
    cp_async16(smem_u32(Bs + j * 64 + 8 * v), Bb + (size_t)j * DS + 8 * v,
               true);
  }
  cp_async_commit();
  for (int t = tid; t < L; t += C::THREADS) {
    const bool ok = t < n_chunk;
    dts[t] = ok ? dt[(size_t)bh * T_ + t0 + t] : 0.f;
    cum[t] = ok ? dA[(size_t)bh * T_ + t0 + t] : 0.f;
  }
  __syncthreads();
  if (tid < 32) warp_cumsum(cum, L, lane);
  __syncthreads();
  const float total = cum[L - 1];
  for (int t = tid; t < L; t += C::THREADS) {
    seg[t] = clip_exp(total - cum[t]);
    if (d0 == 0) cum_out[((size_t)bh * nc + c) * L + t] = cum[t];
  }
  __syncthreads();
  for (int idx = tid; idx < n_chunk * 8; idx += C::THREADS) {
    const int j = idx / 8, v = idx % 8;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(xb + (size_t)j * kHD + 8 * v);
    const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float dj = dts[j], sj = seg[j];
    float* dst = xs + j * kHD + 8 * v;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(pr[k]);
      dst[2 * k] = (f.x * dj) * sj;
      dst[2 * k + 1] = (f.y * dj) * sj;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  float sacc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) sacc[i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < n_chunk; ++j) {
    const uint2 braw = *reinterpret_cast<const uint2*>(Bs + j * 64 + 4 * dg);
    const float2 b01 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&braw.x));
    const float2 b23 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&braw.y));
    const float4 xv = *reinterpret_cast<const float4*>(xs + j * kHD + 4 * ng);
    const float bv[4] = {b01.x, b01.y, b23.x, b23.y};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      sacc[4 * a] = fmaf(bv[a], xv.x, sacc[4 * a]);
      sacc[4 * a + 1] = fmaf(bv[a], xv.y, sacc[4 * a + 1]);
      sacc[4 * a + 2] = fmaf(bv[a], xv.z, sacc[4 * a + 2]);
      sacc[4 * a + 3] = fmaf(bv[a], xv.w, sacc[4 * a + 3]);
    }
  }
  float* so = S + (((size_t)bh * nc + c) * DS + d0 + 4 * dg) * kHD + 4 * ng;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(so + a * kHD) =
        make_float4(sacc[4 * a], sacc[4 * a + 1], sacc[4 * a + 2],
                    sacc[4 * a + 3]);
}

// One thread a (row, state element), serial over the chunks:
// H <- H * exp(clip(total_c)) + S_c, two roundings (-fmad=false) as the
// plain version takes them.  Each chunk's incoming state goes to Hp
// (BH, nc - 1, DS, 64), the last H to Hout.
__global__ void __launch_bounds__(256)
ssd_pass_kernel(const float* __restrict__ S, const float* __restrict__ cum,
                float* __restrict__ Hp, float* __restrict__ Hout,
                int n_elem, int BH, int nc, int L) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)BH * n_elem) return;
  const int bh = (int)(gid / n_elem);
  const int e = (int)(gid - (long long)bh * n_elem);
  const float* cb = cum + (size_t)bh * nc * L;
  float h = 0.f;
  for (int c = 0; c < nc; ++c) {
    if (c > 0) Hp[((size_t)bh * (nc - 1) + c - 1) * n_elem + e] = h;
    h = h * clip_exp(cb[(size_t)c * L + L - 1]) +
        S[((size_t)bh * nc + c) * n_elem + e];
  }
  Hout[gid] = h;
}

// ----- 3. scores --------------------------------------------------------

// Tile pairs (query tile qt, key tile kt <= qt) of a chunk, numbered
// qt (qt + 1) / 2 + kt.
__device__ __forceinline__ int pair_index(int qt, int kt) {
  return qt * (qt + 1) / 2 + kt;
}

constexpr int kFrag = 128 * 32;   // floats of a 64 x 64 tile of scores

// Block (batch row bg, chunk c, tile pair), 256 threads: the 64 x 64
// scores C_q . B_k^T in float32, one fused multiply-add after another
// over the state dimension from 0, as the plain version's product rounds
// them (the tensor cores' accumulation truncates, and scores that cancel
// on padded rows then miss the bf16 rule downstream by 4.9x).  A row's
// heads share them.  Written in the
// order the chunk scan's warpgroup threads hold them: thread 32 w + l
// takes rows 16 w + l / 4 + 8 h and keys 8 i + 2 (l % 4) + j at
// 4 i + 2 h + j of its 32.  Thread here: rows 4 rg .. + 3, keys 4 kg ..
// + 3, from transposed tiles, so a warp reads 16 rows of C and two key
// groups of B, broadcast.
template <int DS>
__device__ __forceinline__ void scores_block(
    const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
    float* __restrict__ strip, int T_, int L, int nc, int n_pairs, int blk,
    uint8_t* smem_raw) {
  __nv_bfloat16(*ct)[64] = reinterpret_cast<__nv_bfloat16(*)[64]>(smem_raw);
  __nv_bfloat16(*bt)[64] = ct + DS;
  const int pr = blk % n_pairs;
  const int c = (blk / n_pairs) % nc;
  const int bg = blk / (n_pairs * nc);
  int qt = 0;
  while (pair_index(qt + 1, 0) <= pr) ++qt;
  const int kt = pr - pair_index(qt, 0);
  const int tid = threadIdx.x;

  // Rows past T read as zero, as the plain version pads them.
  constexpr int kVec = DS / 8;
  for (int idx = tid; idx < 2 * 64 * kVec; idx += 256) {
    const int which = idx / (64 * kVec);          // 0 C, 1 B
    const int r = (idx / kVec) % 64;
    const int v = idx % kVec;
    const int row = c * L + 64 * (which ? kt : qt) + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < T_)
      val = *reinterpret_cast<const uint4*>(
          (which ? Bm : Cm) + ((size_t)bg * T_ + row) * DS + 8 * v);
    const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&val);
    __nv_bfloat16(*dst)[64] = which ? bt : ct;
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[8 * v + k][r] = pv[k];
  }
  __syncthreads();

  const int rg = tid % 16, kg = tid / 16;
  float sc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DS; ++d) {
    const uint2 craw = *reinterpret_cast<const uint2*>(&ct[d][4 * rg]);
    const uint2 braw = *reinterpret_cast<const uint2*>(&bt[d][4 * kg]);
    const float2 c01 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&craw.x));
    const float2 c23 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&craw.y));
    const float2 b01 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&braw.x));
    const float2 b23 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&braw.y));
    const float cv[4] = {c01.x, c01.y, c23.x, c23.y};
    const float bv[4] = {b01.x, b01.y, b23.x, b23.y};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        sc[4 * a + b] = fmaf(cv[a], bv[b], sc[4 * a + b]);
  }
  float* out = strip + ((size_t)(bg * nc + c) * n_pairs + pr) * kFrag;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = 4 * rg + a, k = 4 * kg + b;
      const int lane = 4 * (r % 8) + (k % 8) / 2;
      const int thread = 32 * (r / 16) + lane;
      out[thread * 32 + 4 * (k / 8) + 2 * ((r % 16) / 8) + k % 2] =
          sc[4 * a + b];
    }
}

// Kernels 1 and 3 in one launch, so that the scores' blocks fill the SMs
// the chunk states leave free: blocks below n_state take a (row, chunk,
// state rows), the rest a (batch row, chunk, tile pair).
template <int DS>
__global__ void __launch_bounds__(256, 2)
ssd_state_scores_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ Bm,
                        const __nv_bfloat16* __restrict__ Cm,
                        const float* __restrict__ dt,
                        const float* __restrict__ dA,
                        float* __restrict__ cum_out, float* __restrict__ S,
                        float* __restrict__ strip, int T_, int G, int L,
                        int nc, int n_state, int n_pairs) {
  extern __shared__ uint8_t smem_raw[];
  if ((int)blockIdx.x < n_state)
    chunk_state_block<DS>(x, Bm, dt, dA, cum_out, S, T_, G, L, nc,
                          blockIdx.x, smem_raw);
  else
    scores_block<DS>(Bm, Cm, strip, T_, L, nc, n_pairs,
                     blockIdx.x - n_state, smem_raw);
}

// ----- 4. chunk scan --------------------------------------------------

template <int DS>
struct ScanCfg {
  static constexpr int THREADS = 256;              // two warpgroups
  static constexpr int X_BYTES = kMaxL * 128;      // x: 256 rows x 64
  static constexpr int H_BYTES = DS * kHD * 4;     // H_{c-1}, float32
  static constexpr int STAGE = X_BYTES + H_BYTES;
  static constexpr int CT_BYTES = DS * 64 * 4;     // C's tile, transposed
  static constexpr int YSTRIDE = kHD + 4;          // f32 a row of a y part
  static constexpr int Y_BYTES = 64 * YSTRIDE * 4;
  static constexpr int SMEM = 2 * STAGE + CT_BYTES + 2 * Y_BYTES + 1024;
};

struct ScanArgs {
  const __nv_bfloat16* Cm;
  const float* dt;
  const float* cum;
  const float* Hp;
  const float* strip;
  __nv_bfloat16* y;
  int T_, BG, G, L, nc, n_qt, n_hg, hpg, n_pairs;
};

// What both warpgroups of a chunk-scan block share.
struct ScanCtx {
  const CUtensorMap* map_x;
  const ScanArgs* a;
  float (*cum_s)[kMaxL];
  float (*dt_s)[kMaxL];
  uint8_t* base;               // the generic address of s_st
  float* ct;                   // C's query tile, transposed, float32
  float* ypart[2];             // each warpgroup's part of y, row-major
  uint32_t s_st, bar_x0;
  int c, bg, h_beg, nh, t0, n_chunk;
};

// The key tiles warpgroup W takes of a query tile with NKT key tiles at
// or below it: the first half to warpgroup 0, the rest (with the
// diagonal, from NKT 2 on) to warpgroup 1.
template <int NKT, int W>
struct KeySplit {
  static constexpr int HALF = (NKT + 1) / 2;
  static constexpr int BEG = W ? HALF : 0;
  static constexpr int N = (W ? NKT : HALF) - BEG;
};

__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <int DS>
__device__ __forceinline__ uint32_t stage_x(const ScanCtx& x, int s) {
  return x.s_st + s * ScanCfg<DS>::STAGE;
}

// Thread 0: head k's x tiles and, past the first chunk, its incoming
// state into stage k & 1.
template <int DS, int NKT>
__device__ __forceinline__ void issue_head(const ScanCtx& x, int k) {
  using C = ScanCfg<DS>;
  const int s = k & 1;
  const int bh = x.bg * x.a->G + x.h_beg + k;
  const uint32_t bar = x.bar_x0 + 8 * s;
  const uint32_t st = stage_x<DS>(x, s);
  mbar_expect_tx(bar, NKT * 8192 + (x.c > 0 ? C::H_BYTES : 0));
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt)
    tma_load(st + kt * 8192, x.map_x, 0, x.t0 + 64 * kt, bh, bar);
  if (x.c > 0)
    bulk_load(st + C::X_BYTES,
              x.a->Hp + ((size_t)bh * (x.a->nc - 1) + x.c - 1) * DS * kHD,
              C::H_BYTES, bar);
}

// Every thread of the block: head k's cum and dt, zero past the chunk's
// tokens.
template <int NKT>
__device__ __forceinline__ void copy_scalars(const ScanCtx& x, int k) {
  const int s = k & 1;
  const int bh = x.bg * x.a->G + x.h_beg + k;
  const float* cb = x.a->cum + (size_t)bh * x.a->nc * x.a->L + x.t0;
  const float* db = x.a->dt + (size_t)bh * x.a->T_ + x.t0;
  for (int t = threadIdx.x; t < 64 * NKT; t += 256) {
    const bool ok = t < x.n_chunk;
    cp_async4(smem_u32(&x.cum_s[s][t]), ok ? cb + t : cb, ok);
    cp_async4(smem_u32(&x.dt_s[s][t]), ok ? db + t : db, ok);
  }
  cp_async_commit();
}

// Warpgroup W of a block on query tile NKT - 1: its key tiles of the
// scores (kernel 2's, shared by the group's heads), kept in registers,
// then for every head of the group its part of w' . x, left in
// ypart[W]; then with the other warpgroup, the carried-state term and
// the store.  Tile counts are compile-time, so every wgmma and fragment
// index is static and only the diagonal tile carries the mask.
template <int DS, int NKT, int W>
__device__ __forceinline__ void scan_warpgroup(const ScanCtx& x) {
  using C = ScanCfg<DS>;
  using K = KeySplit<NKT, W>;
  const int tid = threadIdx.x;
  const int wt = tid % 128, wwarp = wt / 32, lane = tid % 32;
  const int q0 = 64 * (NKT - 1);

  // This warpgroup's key tiles of the scores: tile BEG + t in
  // sc[32 t .. 32 t + 31], the accumulator fragment's order.
  float sc[32 * (K::N > 0 ? K::N : 1)];
#pragma unroll
  for (int t = 0; t < K::N; ++t) {
    const float4* src = reinterpret_cast<const float4*>(
        x.a->strip +
        ((size_t)(x.bg * x.a->nc + x.c) * x.a->n_pairs +
         pair_index(NKT - 1, K::BEG + t)) * kFrag + wt * 32);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = src[q];
      sc[32 * t + 4 * q] = v.x;
      sc[32 * t + 4 * q + 1] = v.y;
      sc[32 * t + 4 * q + 2] = v.z;
      sc[32 * t + 4 * q + 3] = v.w;
    }
  }

  const int qr = q0 + 16 * wwarp + lane / 4;   // rows qr and qr + 8
  const int rg = tid % 16, cg = tid / 16;      // C . H: rows rg + 16 a
  for (int k = 0; k < x.nh; ++k) {
    const int s = k & 1;
    cp_async_wait_all();
    pair_sync();            // head k's scalars landed; stage s ^ 1 free
    if (k + 1 < x.nh) {
      if (tid == 0) issue_head<DS, NKT>(x, k + 1);
      copy_scalars<NKT>(x, k + 1);
    }
    const float* cs = x.cum_s[s];
    const float* dts = x.dt_s[s];
    const float cq[2] = {cs[qr], cs[qr + 8]};
    const uint32_t st_x = stage_x<DS>(x, s);
    mbar_wait(x.bar_x0 + 8 * s, (k >> 1) & 1);

    float acc[32];
    if constexpr (K::N > 0) {
      // acc = w' . x over 16-key steps st (key tile BEG + st / 4): w' in
      // two bf16 parts fr[.][0..3] and fr[.][4..7], formed without
      // branches, x MN-major from the stage; the first product
      // overwrites acc.
      uint32_t fr[2][8];
      auto build = [&](int st, uint32_t* f) {
        const int kt = K::BEG + st / 4;
        const bool diag = kt == NKT - 1;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 2 * (st % 4) + m;
            const int idx = 32 * (st / 4) + 4 * i + 2 * h;
            const int kp = 64 * kt + 8 * i + 2 * (lane % 4);
            const int qp = qr + 8 * h;
            float v[2];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const float w = sc[idx + jj] *
                              clip_exp_fast(cq[h] - cs[kp + jj]) *
                              dts[kp + jj];
              v[jj] = (!diag || kp + jj <= qp) ? w : 0.f;
            }
            split2(v[0], v[1], f[2 * m + h], f[4 + 2 * m + h]);
          }
      };
#pragma unroll
      for (int st = 0; st < 4 * K::N; ++st) {
        build(st, fr[st & 1]);
        wgmma_fence();
        const uint64_t db = desc_b128(st_x + (K::BEG * 4 + st) * 2048,
                                      kMaxL * 128, 1024);
        mma_rs(acc, fr[st & 1], db, st > 0);
        mma_rs(acc, fr[st & 1] + 4, db, 1);
        wgmma_commit();
        wgmma_wait<1>();
        if (st > 0) fence_regs<8>(fr[(st - 1) & 1]);
      }
      wgmma_wait<0>();
      fence_regs<32>(acc);
      fence_regs<8>(fr[0]);
      fence_regs<8>(fr[1]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
    // This warpgroup's part of w' . x, row-major.
    float* yp = x.ypart[W];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            yp + (16 * wwarp + lane / 4 + 8 * h) * C::YSTRIDE + 8 * i +
            2 * (lane % 4)) = make_float2(acc[4 * i + 2 * h],
                                          acc[4 * i + 2 * h + 1]);

    // The carried-state term C_q . H_{c-1} in float32 on the SIMT pipes,
    // one fused multiply-add after another over the state dimension from
    // 0, as the plain version's product rounds it: where the term
    // cancels (left-padded prompts), only that order stays inside the
    // bf16 rule.  Thread: rows rg + 16 a,
    // columns 4 cg .. + 3 (ch[4 a + b]); a warp reads 16 rows of C's
    // transposed tile and two column groups of H, broadcast.
    float ch[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) ch[i] = 0.f;
    if (x.c > 0) {
      const float* Hs = reinterpret_cast<const float*>(
          x.base + (st_x + C::X_BYTES - x.s_st));
#pragma unroll 4
      for (int d = 0; d < DS; ++d) {
        const float4 c4 =
            *reinterpret_cast<const float4*>(x.ct + d * 64 + 4 * rg);
        const float4 hv = *reinterpret_cast<const float4*>(Hs + d * kHD +
                                                           4 * cg);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ch[4 * a] = fmaf(cv[a], hv.x, ch[4 * a]);
          ch[4 * a + 1] = fmaf(cv[a], hv.y, ch[4 * a + 1]);
          ch[4 * a + 2] = fmaf(cv[a], hv.z, ch[4 * a + 2]);
          ch[4 * a + 3] = fmaf(cv[a], hv.w, ch[4 * a + 3]);
        }
      }
    }
    pair_sync();            // both parts of w' . x written

    // y = (warpgroup 0's part + warpgroup 1's) + (C . H) * exp(clip(cum)),
    // in the plain version's order (-fmad=false keeps the product and the
    // sum apart).
    const int bh = x.bg * x.a->G + x.h_beg + k;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = rg + 16 * a;
      if (q0 + r >= x.n_chunk) continue;
      const float e = clip_exp(cs[q0 + r]);
      const float4 p0 = *reinterpret_cast<const float4*>(
          x.ypart[0] + r * C::YSTRIDE + 4 * cg);
      const float4 p1 = *reinterpret_cast<const float4*>(
          x.ypart[1] + r * C::YSTRIDE + 4 * cg);
      const uint32_t lo = pack_bf16(__floats2bfloat162_rn(
          (p0.x + p1.x) + ch[4 * a] * e, (p0.y + p1.y) + ch[4 * a + 1] * e));
      const uint32_t hi = pack_bf16(__floats2bfloat162_rn(
          (p0.z + p1.z) + ch[4 * a + 2] * e,
          (p0.w + p1.w) + ch[4 * a + 3] * e));
      *reinterpret_cast<uint2*>(
          x.a->y + ((size_t)bh * x.a->T_ + x.t0 + q0 + r) * kHD + 4 * cg) =
          make_uint2(lo, hi);
    }
  }
}

template <int DS, int NKT>
__device__ __forceinline__ void scan_block(ScanCtx& x) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(x.bar_x0, 1);
    mbar_init(x.bar_x0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) issue_head<DS, NKT>(x, 0);
  if (x.c > 0) {
    // C's query tile, transposed for the float32 C . H: row r at column
    // 4 (r % 16) + r / 16 of each state row, so that a thread's rows
    // rg + 16 a sit side by side; rows past T read as zero.
    const int r0 = x.t0 + 64 * (NKT - 1);
    const __nv_bfloat16* cb = x.a->Cm + ((size_t)x.bg * x.a->T_ + r0) * DS;
    constexpr int kVec = DS / 8;
    for (int idx = tid; idx < 64 * kVec; idx += ScanCfg<DS>::THREADS) {
      const int r = idx / kVec;
      const int v = idx - r * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < x.a->T_)
        val = *reinterpret_cast<const uint4*>(cb + (size_t)r * DS + 8 * v);
      const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&val);
      const int col = 4 * (r % 16) + r / 16;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        x.ct[(8 * v + k) * 64 + col] = __bfloat162float(pv[k]);
    }
  }
  copy_scalars<NKT>(x, 0);
  if (tid < 128)
    scan_warpgroup<DS, NKT, 0>(x);
  else
    scan_warpgroup<DS, NKT, 1>(x);
}

// Block (64-query tile qt, chunk c, batch row bg, head group hg), two
// warpgroups; the longest query tiles first.  Shared memory: two stages
// of (x tiles, H_{c-1}) — x 128-byte swizzled by TMA in atoms of 8 rows,
// 1024-byte aligned, as wgmma reads it — C's tile transposed, and the
// two warpgroups' parts of y.
template <int DS>
__global__ void __launch_bounds__(256, 1)
ssd_scan_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                   const ScanArgs a) {
  using C = ScanCfg<DS>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ float cum_s[2][kMaxL];
  __shared__ float dt_s[2][kMaxL];
  const int per_qt = a.nc * a.BG * a.n_hg;
  const int qt = a.n_qt - 1 - (int)blockIdx.x / per_qt;
  int rem = (int)blockIdx.x % per_qt;
  const int hg = rem % a.n_hg;
  rem /= a.n_hg;
  ScanCtx x;
  x.bg = rem % a.BG;
  x.c = rem / a.BG;
  x.h_beg = hg * a.hpg;
  x.nh = min(a.G, x.h_beg + a.hpg) - x.h_beg;
  x.t0 = x.c * a.L;
  x.n_chunk = min(a.L, a.T_ - x.t0);
  if (64 * qt >= x.n_chunk || x.nh <= 0) return;   // padding only
  x.map_x = &map_x;
  x.a = &a;
  x.cum_s = cum_s;
  x.dt_s = dt_s;
  x.s_st = align1024(smem_u32(smem_raw));
  x.base = smem_raw + (x.s_st - smem_u32(smem_raw));
  uint8_t* tail = x.base + 2 * C::STAGE;
  x.ct = reinterpret_cast<float*>(tail);
  x.ypart[0] = reinterpret_cast<float*>(tail + C::CT_BYTES);
  x.ypart[1] = reinterpret_cast<float*>(tail + C::CT_BYTES + C::Y_BYTES);
  x.bar_x0 = smem_u32(&bars[0]);
  switch (qt) {
    case 0: scan_block<DS, 1>(x); break;
    case 1: scan_block<DS, 2>(x); break;
    case 2: scan_block<DS, 3>(x); break;
    default: scan_block<DS, 4>(x); break;
  }
}

// The kernels of `stages` (bit 0 the chunk states, bit 1 the state
// passing, bit 2 the scores, bit 3 the chunk scan; the chunk states and
// the scores share one launch), each launch checked as it is made.  With
// one chunk the chunk states write H (0 * g + S is S) and the state
// passing is skipped.
template <int DS>
int launch(const void* x, const void* Bm, const void* Cm, const void* dt,
           const void* dA, void* y, void* H, void* S, void* Hp, void* cum,
           void* strip, int BH, int T_, int G, int L, int n_hg, int stages,
           cudaStream_t stream) {
  const int nc = (T_ + L - 1) / L;
  const int n_qt = ((L + 63) & ~63) / 64;
  const int n_pairs = n_qt * (n_qt + 1) / 2;
  const int BG = BH / G;
  CUtensorMap mx;
  const int err = make_map(&mx, x, kHD, T_, BH, 64);
  if (err) return err;
  // Opt in to the kernels' shared memory once a device.
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    e = cudaFuncSetAttribute(ssd_state_scores_kernel<DS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             StateCfg<DS>::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_scan_tc_kernel<DS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ScanCfg<DS>::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(Bm);
  const auto* cb = static_cast<const __nv_bfloat16*>(Cm);
  const int n_state = (stages & 1) ? BH * nc * (DS / 64) : 0;
  const int n_score = (stages & 4) ? BG * nc * n_pairs : 0;
  if (n_state + n_score > 0) {
    ssd_state_scores_kernel<DS><<<n_state + n_score, StateCfg<DS>::THREADS,
                                  StateCfg<DS>::SMEM, stream>>>(
        xb, bb, cb, static_cast<const float*>(dt),
        static_cast<const float*>(dA), static_cast<float*>(cum),
        static_cast<float*>(nc > 1 ? S : H), static_cast<float*>(strip), T_,
        G, L, nc, n_state, n_pairs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if ((stages & 2) && nc > 1) {
    const long long n = (long long)BH * DS * kHD;
    ssd_pass_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(S), static_cast<const float*>(cum),
        static_cast<float*>(Hp), static_cast<float*>(H), DS * kHD, BH, nc,
        L);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (stages & 8) {
    const ScanArgs sa{cb,
                      static_cast<const float*>(dt),
                      static_cast<const float*>(cum),
                      static_cast<const float*>(Hp),
                      static_cast<const float*>(strip),
                      static_cast<__nv_bfloat16*>(y), T_, BG, G, L, nc, n_qt,
                      n_hg, (G + n_hg - 1) / n_hg, n_pairs};
    ssd_scan_tc_kernel<DS><<<n_qt * nc * BG * n_hg, ScanCfg<DS>::THREADS,
                             ScanCfg<DS>::SMEM, stream>>>(mx, sa);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace tc

}  // namespace

// Shared memory one block needs at these widths, in bytes (the kernel
// takes at most 232448).
extern "C" long long ssd_scan_smem_bytes(int hd, int ds, int L) {
  return (long long)smem_bytes(hd, ds, L);
}

// dtype of x, B, C and y: 0 float32, 1 bfloat16.  G = BH / BG heads share
// a row of B and C.  L is the chunk length, min(chunk, T).  Returns a
// cudaError_t (0 on success).
extern "C" int ssd_scan_launch(const void* x, const void* Bm, const void* Cm,
                               const void* dt, const void* dA, void* y,
                               void* H, int BH, int T_, int hd, int ds, int G,
                               int L, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || T_ <= 0) return 0;
  if (G <= 0 || BH % G || ds <= 0 || ds % 4 || L <= 0 || L > T_)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_hd<float>(hd, x, Bm, Cm, dt, dA, y, H, BH, T_, ds, G, L, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, x, Bm, Cm, dt, dA, y, H, BH, T_, ds,
                                    G, L, st);
  return (int)cudaErrorInvalidValue;
}

// bfloat16 x, B, C and y (16-byte aligned, contiguous) at hd 64, ds 64
// or 128, L at most 256 and a multiple of 64 unless it is T: the
// tensor-core path.  S (BH, nc, ds, 64), Hp (BH, nc - 1, ds, 64), cum
// (BH, nc * L) and the scores (BG, nc, n_pairs, 128 * 32) with n_pairs =
// n_qt (n_qt + 1) / 2, all f32, are the caller's scratch (S and Hp
// unread with one chunk); n_hg splits a batch row's G heads into that
// many groups, one block each; stages picks the kernels (15: all four,
// in order).  Returns a cudaError_t (0 on success), the first kernel's
// that failed.
extern "C" int ssd_scan_tc_launch(const void* x, const void* Bm,
                                  const void* Cm, const void* dt,
                                  const void* dA, void* y, void* H, void* S,
                                  void* Hp, void* cum, void* strip, int BH,
                                  int T_, int hd, int ds, int G, int L,
                                  int n_hg, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || T_ <= 0) return 0;
  if (hd != tc::kHD || G <= 0 || BH % G || L <= 0 || L > T_ ||
      L > tc::kMaxL || (L % 64 && L != T_) || n_hg < 1 || n_hg > G)
    return (int)cudaErrorInvalidValue;
  if (ds == 64)
    return tc::launch<64>(x, Bm, Cm, dt, dA, y, H, S, Hp, cum, strip, BH,
                          T_, G, L, n_hg, stages, st);
  if (ds == 128)
    return tc::launch<128>(x, Bm, Cm, dt, dA, y, H, S, Hp, cum, strip, BH,
                           T_, G, L, n_hg, stages, st);
  return (int)cudaErrorInvalidValue;
}
