// Forward flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py::_fa_kernel (entry flash_attention_fwd).  It computes what
// that kernel computes, not block for block:
//
//   s = (q . k) * hd^-0.5, then tanh softcap, then the mask
//       (key < kv_valid; causal: key <= query; window: query - key < W);
//   online softmax in float32: m, l and acc per query row;
//   masked entries give p = 0 (a row with no visible key outputs 0);
//   out = acc / max(l, 1e-30), in q's dtype.
//
// q is (BH, T, hd), k and v (BK, S, hd); query row bh reads kv row
// bh / G with G = BH / BK (GQA).  Inputs are float32 or bfloat16 and are
// widened to float32 on their way into shared memory; every product and
// sum is float32, P.V included (the reference kernel casts its tiles to
// float32 the same way).
//
// Design.  One block of 256 threads takes one (bh, 64-query tile).  It
// keeps the query tile in shared memory and streams 64-key tiles of K,
// then V, through one shared buffer.  Thread (ty, tx) of a 16 x 16 grid
// owns query rows ty + 16 i (i < 4): it computes the scores of those rows
// against keys tx + 16 j (j < 4), and the output columns tx*4 + 64 g
// (g < hd/64, four each) of the same rows; a row's max and sum are
// reduced across its 16 threads with warp shuffles.  Tiles that hold no
// visible key for any row of the block are never loaded: those above
// the causal diagonal, left of the window, or at or past kv_valid.
//
// Bound.  At the serving path's prefill shapes (hd 128, causal, T in the
// thousands) the work is 4*T*S*hd/2 flops per head against O(T*hd)
// bytes: it is bound by operations.  This first kernel runs them as
// scalar float32 fused multiply-adds from shared memory (written as
// fmaf, so they stay fused under the shared -fmad=false), not on the
// tensor cores, so it sits well above the bf16 tensor-core bound; a
// wgmma/TMA pipeline is the later work that closes that gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

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

// Rows [row0, row0 + 64) of a (rows, HD) matrix into shared memory as
// float32 with row stride HD + 4; rows at or past n_rows are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows) {
  constexpr int kVec = HD / 4;
  for (int idx = threadIdx.x; idx < 64 * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx - r * kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) val = load4(src + (size_t)(row0 + r) * HD + c);
    store4(dst + r * (HD + 4) + c, val);
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int T_, int S,
              int G, int n_qt, int causal, int has_window, int window,
              int kv_valid, float scale, int has_cap, float cap) {
  constexpr int NC = HD / 64;          // float4 output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // (64, HD + 4)
  float* KVs = Qs + kBQ * (HD + 4);    // (64, HD + 4): K, then V
  float* Ps = KVs + kBK * (HD + 4);    // (64, 64 + 4)

  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * kBQ;
  const T* qb = q + (size_t)bh * T_ * HD;
  const T* kb = k + (size_t)(bh / G) * S * HD;
  const T* vb = v + (size_t)(bh / G) * S * HD;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  load_tile<T, HD>(Qs, qb, q0, T_);

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NC; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Key tiles holding a visible key for some row of this query tile.
  int k_end = kv_valid;
  if (causal) k_end = min(k_end, q0 + kBQ);
  int k_beg = 0;
  if (has_window) k_beg = max(0, q0 - window + 1);
  const int t_beg = k_beg / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  for (int t = t_beg; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                   // last tile's P.V reads are done
    load_tile<T, HD>(KVs, kb, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * (HD + 4) + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * (HD + 4) + d);
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

    // Scale, softcap, mask; online-softmax update of each owned row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float mb = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (has_cap) x = cap * tanhf(x / cap);
        ok[j] = kpos < kv_valid && (!causal || kpos <= qpos) &&
                (!has_window || qpos - kpos < window);
        s[i][j] = ok[j] ? x : kNeg;
        mb = fmaxf(mb, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mb));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (kBK + 4) + tx + 16 * j] = p;
        rs += p;
      }
      const float c = expf(m[i] - m_new);
      l[i] = l[i] * c + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        acc[i][g].x *= c;
        acc[i][g].y *= c;
        acc[i][g].z *= c;
        acc[i][g].w *= c;
      }
    }
    __syncthreads();                   // P written; K reads are done
    load_tile<T, HD>(KVs, vb, k0, S);
    __syncthreads();

#pragma unroll 2
    for (int jj = 0; jj < kBK; jj += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * (kBK + 4) + jj);
#pragma unroll
      for (int jq = 0; jq < 4; ++jq) {
        const float* vrow = KVs + (jj + jq) * (HD + 4) + tx * 4;
#pragma unroll
        for (int g = 0; g < NC; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 64 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jq == 0 ? pa[i].x : jq == 1 ? pa[i].y
                          : jq == 2 ? pa[i].z : pa[i].w;
            acc[i][g].x = fmaf(p, vv.x, acc[i][g].x);
            acc[i][g].y = fmaf(p, vv.y, acc[i][g].y);
            acc[i][g].z = fmaf(p, vv.z, acc[i][g].z);
            acc[i][g].w = fmaf(p, vv.w, acc[i][g].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T_) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * T_ + row) * HD + tx * 4;
#pragma unroll
    for (int g = 0; g < NC; ++g) {
      const float4 a = acc[i][g];
      store4(orow + 64 * g,
             make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int T_, int S, int BK, int causal, int has_window, int window,
           int kv_valid, float scale, int has_cap, float cap,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)(kBQ + kBK) * (HD + 4) + (size_t)kBQ * (kBK + 4));
  auto kernel = fa_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (T_ + kBQ - 1) / kBQ;
  const long long blocks = (long long)BH * n_qt;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), T_, S, BH / BK, n_qt,
      causal, has_window, window, kv_valid, scale, has_cap, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int BH, int T_, int S, int BK, int causal, int has_window,
              int window, int kv_valid, float scale, int has_cap, float cap,
              cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, BH, T_, S, BK, causal, has_window,
                           window, kv_valid, scale, has_cap, cap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, BH, T_, S, BK, causal, has_window,
                            window, kv_valid, scale, has_cap, cap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, BH, T_, S, BK, causal, has_window,
                            window, kv_valid, scale, has_cap, cap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int fa_fwd_launch(const void* q, const void* k, const void* v,
                             void* o, int BH, int T_, int S, int BK, int hd,
                             int dtype, int causal, int has_window,
                             int window, int kv_valid, float scale,
                             int has_cap, float cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BK <= 0 || BH % BK) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, BH, T_, S, BK, causal,
                            has_window, window, kv_valid, scale, has_cap,
                            cap, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, BH, T_, S, BK, causal,
                                    has_window, window, kv_valid, scale,
                                    has_cap, cap, st);
  return (int)cudaErrorInvalidValue;
}
