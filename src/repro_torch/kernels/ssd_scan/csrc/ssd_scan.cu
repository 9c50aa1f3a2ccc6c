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
// the reference's adapter broadcasts are never made.  x, B and C are
// float32 or bfloat16 and are widened to float32 on their way into
// shared memory; dt and dA are float32.
//
// Design.  One block of 256 threads per row bh walks its chunks in
// order and keeps H (ds x hd float32, 32 KB at ds 128, hd 64) in shared
// memory.  A chunk's L x L score matrix (256 KB in float32 at L 256)
// does not fit, so the chunk is cut into 64-token tiles, as flash
// attention cuts keys: for each 64-row query tile, C's tile is loaded,
// its carried-state term C . H is computed, and then for each key tile
// at or below the diagonal the 64 x 64 scores are formed in registers,
// masked (key <= query, written explicitly), decayed, put in shared
// memory and multiplied into the query tile's accumulator with the key
// tile's x * dt.  After every query tile of the chunk, the state update
// walks the key tiles once more with (x * dt) * seg.  cum is one warp's
// scan (a sequential run per lane, then a shuffle scan of the lanes'
// sums); the plain version's chunk_cumsum takes the same order, so the
// two round |cum| (hundreds, late in a chunk) alike.
//
// Bound.  The work is 2 L(L+1)/2 (ds + hd) + 4 L ds hd flops per row
// and chunk against about (2 hd + 2 ds / G + 2) T values of traffic per
// row: near the H100's bf16 ridge at the Mamba-2 widths.  This first
// kernel runs scalar float32 fused multiply-adds from shared memory
// (written as fmaf, so they stay fused under the shared -fmad=false),
// not tensor-core products, and one block per row leaves some SMs idle
// at 96 rows; it sits far above its bound.  Scores shared by the heads
// of a row, and wgmma tiles, are the later work that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    if (tid < 32) {                    // inclusive scan of cum, in place
      const int per = (L + 31) / 32;
      const int beg = min(L, lane * per);
      const int end = min(L, beg + per);
      float s = 0.f;
      for (int t = beg; t < end; ++t) s += cum[t];
      float incl = s;
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
