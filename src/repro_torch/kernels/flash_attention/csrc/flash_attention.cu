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
// bh / G with G = BH / BK (GQA).  Two kernels, chosen by dtype:
//
// bfloat16: fa_tc_kernel, on the tensor cores.  Bound: at the serving
// path's prefill shapes (hd 128, causal, T in the thousands) the work is
// 4*T*S*hd/2 flops per head against O(T*hd) bytes, so it is bound by
// operations, and only the tensor cores (989 TFLOP/s in bf16, against
// 67 TFLOP/s on the float32 pipes) come near that bound.  Design:
//   * a block owns 64*NWG query rows of one query head: NWG consumer
//     warpgroups of 64 rows each (2 at hd 64 and 128, 1 at hd 256), and
//     one producer warpgroup (with two consumers it hands registers to
//     them by setmaxnreg: 24 a thread for it, 240 for each consumer).
//     One head a block, not a GQA group: a group's K and V tiles are
//     read once from device memory and then from L2 (50 MB holds every
//     kv row of a llama prefill), since the blocks of a group's G heads
//     and one query tile have neighbouring indices; and a block's rows
//     stay one head, so no G is special.  The longest query tiles of
//     the causal diagonal go first;
//   * the producer issues TMA loads (3-D tensor maps (hd, rows, batch),
//     so a ragged kv row zero-fills instead of reading the next row) of
//     Q once and of bf16 K and V tiles of BKV keys (128 at hd 64; 64 at
//     hd 128, where 128-key tiles spill registers, and at hd 256) into a
//     3-stage ring in 128B-swizzled shared memory, a swizzle atom being
//     64 columns wide; each tile completes on its own mbarrier, and the
//     consumers free a stage on a third;
//   * S = Q K^T by wgmma m64nBKVk16, bf16 x bf16 -> f32, both operands
//     K-major from shared memory: the products are exact in f32, only
//     the order of the sums differs from the reference;
//   * the online softmax runs in registers in f32, in the reference's
//     order (scale, softcap, mask, m_new, p = expf(s - m_new), c, then
//     l = l c + sum p), with the mask compiled only into the path of
//     tiles that cross the causal diagonal, the window's edge or
//     kv_valid, and tiles with no visible key for the block never
//     loaded;
//   * P.V takes P from registers split in two, P_hi = bf16(p) and
//     P_lo = bf16(p - P_hi), as two wgmma (V an MN-major operand from
//     shared memory) into one f32 accumulator: p in bf16 alone misses
//     the reference's f32 P.V by twice the element-wise bf16 tolerance,
//     the split stays well inside it, at 1.5x the reference's
//     operations; l sums the f32 p;
//   * a tile's S and softmax run while the previous tile's P.V is in
//     flight (wgmma.wait_group 1), so the tensor cores and the softmax
//     overlap within a warpgroup as well as across the two;
//   * the epilogue writes acc / max(l, 1e-30) in bf16, rows below T.
//   The elementwise softmax, not the tensor cores, bounds it at the
//   prefill shape: without any wgmma a launch still takes most of its
//   time.  cuTensorMapEncodeTiled, a libcuda function, is taken through
//   cudaGetDriverEntryPoint(ByVersion), so the library links nothing
//   beyond the runtime.
//
// float32, and bfloat16 at hd 16 and 32: fa_fwd_kernel, the first port's
// SIMT kernel, kept for float32 inputs (the card's small-width serving
// checks) and for the reduced configs' narrow heads (hd 16), where a
// wgmma tile of 64 columns would be mostly padding and speed is not at
// stake.  One block of 256 threads takes one (bh, 64-query tile), keeps
// the query tile in shared memory as float32 (bfloat16 widened exactly)
// and streams 64-key tiles of K, then V, through one buffer; every
// product is a scalar float32 fmaf (kept fused under the shared
// -fmad=false), so it runs on the float32 pipes, and P.V keeps p in
// float32 as the plain version does.  A thread owns 4 query rows and, of
// the head's columns, 4 adjacent ones in each 64-column group, or hd / 16
// below 64 (Cols).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------
// float32: the SIMT kernel.

namespace simt {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

// Output columns of a thread: in each of NG groups of 64 columns, W
// adjacent ones at 64 g + tx W (tx the thread's column index, 0..15).
// W is 4 at hd 64, 128 and 256 (NG = hd / 64), hd / 16 below 64 (NG 1).
template <int HD>
struct Cols {
  static constexpr int W = HD >= 64 ? 4 : HD / 16;
  static constexpr int NG = HD >= 64 ? HD / 64 : 1;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four bfloat16 values (8 bytes) widened to float32, exactly.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// W values of a row, rounded to T (round to nearest even for bfloat16).
template <int W>
__device__ __forceinline__ void store_w(float* p, const float* v) {
  if constexpr (W == 4) {
    store4(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) p[c] = v[c];
  }
}

template <int W>
__device__ __forceinline__ void store_w(__nv_bfloat16* p, const float* v) {
#pragma unroll
  for (int c = 0; c < W; ++c) p[c] = __float2bfloat16_rn(v[c]);
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
              int kv_valid, float scale, int has_cap, float cap, int q_off) {
  constexpr int W = Cols<HD>::W;
  constexpr int NG = Cols<HD>::NG;
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
  float acc[4][NG][W];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < W; ++c) acc[i][g][c] = 0.f;
  }

  // Key tiles holding a visible key for some row of this query tile,
  // whose rows sit at positions q_off + q0 on.
  const int p0 = q_off + q0;
  int k_end = kv_valid;
  if (causal) k_end = min(k_end, p0 + kBQ);
  int k_beg = 0;
  if (has_window) k_beg = max(0, p0 - window + 1);
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
      const int qpos = p0 + ty + 16 * i;
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
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int cc = 0; cc < W; ++cc) acc[i][g][cc] *= c;
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
        const float* vrow = KVs + (jj + jq) * (HD + 4) + tx * W;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float vv[W];
          if constexpr (W == 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(vrow + 64 * g);
            vv[0] = v4.x;
            vv[1] = v4.y;
            vv[2] = v4.z;
            vv[3] = v4.w;
          } else {
#pragma unroll
            for (int c = 0; c < W; ++c) vv[c] = vrow[64 * g + c];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jq == 0 ? pa[i].x : jq == 1 ? pa[i].y
                          : jq == 2 ? pa[i].z : pa[i].w;
#pragma unroll
            for (int c = 0; c < W; ++c)
              acc[i][g][c] = fmaf(p, vv[c], acc[i][g][c]);
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
    T* orow = o + ((size_t)bh * T_ + row) * HD + tx * W;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float out[W];
#pragma unroll
      for (int c = 0; c < W; ++c) out[c] = acc[i][g][c] / den;
      store_w<W>(orow + 64 * g, out);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int T_, int S, int BK, int causal, int has_window, int window,
           int kv_valid, float scale, int has_cap, float cap, int q_off,
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
      causal, has_window, window, kv_valid, scale, has_cap, cap, q_off);
  return (int)cudaGetLastError();
}

// The float32 instances take hd 16, 32, 64, 128 and 256; the bfloat16
// ones hd 16 and 32 (wider bfloat16 heads take the tensor-core kernel).
template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int BH, int T_, int S, int BK, int causal, int has_window,
              int window, int kv_valid, float scale, int has_cap, float cap,
              int q_off, cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, BH, T_, S, BK, causal, has_window,
                           window, kv_valid, scale, has_cap, cap, q_off, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, BH, T_, S, BK, causal, has_window,
                           window, kv_valid, scale, has_cap, cap, q_off, stream);
    default:
      break;
  }
  if constexpr (kF32) {
    switch (hd) {
      case 64:
        return launch<T, 64>(q, k, v, o, BH, T_, S, BK, causal, has_window,
                             window, kv_valid, scale, has_cap, cap, q_off, stream);
      case 128:
        return launch<T, 128>(q, k, v, o, BH, T_, S, BK, causal, has_window,
                              window, kv_valid, scale, has_cap, cap, q_off, stream);
      case 256:
        return launch<T, 256>(q, k, v, o, BH, T_, S, BK, causal, has_window,
                              window, kv_valid, scale, has_cap, cap, q_off, stream);
      default:
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
}


}  // namespace simt

// ---------------------------------------------------------------------
// bfloat16: the tensor-core kernel.

namespace tc {

using namespace hopper;

// The wgmma instructions, with their operand lists written out: the
// accumulator fragment (N / 2 f32 a thread), the descriptors, and for
// the register-A form the four .b32 registers of P's fragment.  Fragment
// layout of an f32 accumulator: d[4i + 2h + j] is row
// 16 * warp + lane / 4 + 8h, column 8i + 2 (lane % 4) + j.

// S (64 x 64) = Q (64 x 16, K-major) . K^T (16 x 64, K-major), bf16 -> f32,
// plus S where scale_d is not 0.
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (64 x 128) = Q (64 x 16, K-major) . K^T (16 x 128, K-major), bf16 -> f32,
// plus S where scale_d is not 0.
__device__ __forceinline__ void mma_ss_n128(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 64) += P (64 x 16, registers) . V (16 x 64, MN-major), bf16 -> f32.
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128) += P (64 x 16, registers) . V (16 x 128, MN-major), bf16 -> f32.
__device__ __forceinline__ void mma_rs_n128(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 256) += P (64 x 16, registers) . V (16 x 256, MN-major), bf16 -> f32.
__device__ __forceinline__ void mma_rs_n256(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db,
                                       int scale_d) {
  static_assert(N == 64 || N == 128, "S tile width");
  if constexpr (N == 64) mma_ss_n64(d, da, db, scale_d);
  else mma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "head dim");
  if constexpr (N == 64) mma_rs_n64(d, a, db);
  else if constexpr (N == 128) mma_rs_n128(d, a, db);
  else mma_rs_n256(d, a, db);
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD, int BKV, int NWG>
struct Cfg {
  static constexpr int BQ = 64 * NWG;             // query rows a block
  static constexpr int NP = HD / 64;              // 64-column panels
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;   // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int STAGES = 3;                // the K/V ring
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE + 1024;   // + align
  static constexpr int THREADS = 128 * (NWG + 1);
};

// Shared memory: Q as NP panels of (BQ rows x 64 columns), then each
// stage's K and V as NP panels of (BKV rows x 64 columns); a row of a
// panel is 128 bytes, swizzled in atoms of 8 rows (1024 bytes), every
// panel 1024-byte aligned.
template <int HD, int BKV, int NWG>
__global__ void __launch_bounds__(Cfg<HD, BKV, NWG>::THREADS, 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             __nv_bfloat16* __restrict__ o, int T_, int BH, int G, int n_qt,
             int causal, int has_window, int window, int kv_valid,
             float scale, int has_cap, float cap, int q_off) {
  using C = Cfg<HD, BKV, NWG>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * C::STAGES];

  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_k = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto bar_v = [&](int s) { return smem_u32(&bars[1 + C::STAGES + s]); };
  auto bar_free = [&](int s) {
    return smem_u32(&bars[1 + 2 * C::STAGES + s]);
  };
  auto s_k = [&](int s) { return s_q + C::Q_BYTES + s * C::STAGE; };

  // Query tiles in reverse order (the causal diagonal's longest first);
  // the G heads of one kv row side by side.
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * C::BQ;

  // Key tiles holding a visible key for some row of this block, whose
  // rows sit at positions q_off + q0 on.
  int k_end = kv_valid;
  if (causal) k_end = min(k_end, q_off + q0 + C::BQ);
  const int k_beg = has_window ? max(0, q_off + q0 - window + 1) : 0;
  const int t_beg = k_beg / BKV;
  const int n_tiles = max(0, (k_end + BKV - 1) / BKV - t_beg);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_free(s), 4 * NWG);     // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp >= 4 * NWG) {
    // Producer warpgroup: it gives up registers for the consumers, and
    // one thread issues every TMA load.
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::NP; ++p)
        tma_load(s_q + p * C::BQ * 128, &map_q, 64 * p, q0, bh, bar_q);
      const int kv_row = bh / G;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES;
        mbar_wait(bar_free(s), ((i / C::STAGES) & 1) ^ 1);
        const int k0 = (t_beg + i) * BKV;
        const uint32_t sk = s_k(s), sv = sk + C::KV_BYTES;
        mbar_expect_tx(bar_k(s), C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::NP; ++p)
          tma_load(sk + p * BKV * 128, &map_k, 64 * p, k0, kv_row, bar_k(s));
        mbar_expect_tx(bar_v(s), C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::NP; ++p)
          tma_load(sv + p * BKV * 128, &map_v, 64 * p, k0, kv_row, bar_v(s));
      }
    }
  } else {
    // Consumer warpgroup wg: query rows qa .. qa + 63; this thread holds
    // rows row0 and row0 + 8 of them.
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4;
    const int qa = q0 + 64 * wg;
    const int row0 = qa + 16 * (warp % 4) + lane / 4;
    const int col = 2 * (lane % 4);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    uint32_t p_hi[BKV / 4], p_lo[BKV / 4];

    // O += P_hi V + P_lo V for the tile in stage s (its V landed),
    // issued and committed, not waited for: V (keys x hd) is the MN-major
    // B operand; a step of 16 keys is 2048 bytes, the next 64 columns the
    // next panel.
    auto issue_pv = [&](int s) {
      wgmma_fence();
      const uint32_t sv = s_k(s) + C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t dv = desc_b128(sv + kk * 16 * 128, BKV * 128, 1024);
        mma_rs<HD>(acc, p_hi + 4 * kk, dv);
        mma_rs<HD>(acc, p_lo + 4 * kk, dv);
      }
      wgmma_commit();
    };
    // After the P.V of stage s completed: its registers may be read and
    // reused, and the stage is free.
    auto retire_pv = [&](int s) {
      fence_regs<HD / 2>(acc);
      fence_regs<BKV / 4>(p_hi);
      fence_regs<BKV / 4>(p_lo);
      if (lane == 0) mbar_arrive(bar_free(s));
    };

    // S = Q K^T for tile it (its K landed), issued and committed: HD / 16
    // steps of 16 columns; a step advances 32 bytes inside a 128-byte
    // swizzled row, or moves to the next panel.
    auto issue_s = [&](int it, float* sc) {
      const int s = it % C::STAGES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        mma_ss<BKV>(sc,
                    desc_b128(s_q + (kk / 4) * C::BQ * 128 + wg * 64 * 128 +
                              off, 16, 1024),
                    desc_b128(s_k(s) + (kk / 4) * BKV * 128 + off, 16, 1024),
                    kk > 0);
      }
      wgmma_commit();
    };

    // Online softmax of tile it on its scores sc (p replaces s): scale,
    // softcap, mask (only on tiles that cross an edge: `masked` is a
    // compile-time flag, so other tiles run no mask code); the row maxima
    // and sums in four partial chains each; m and l updated, and c, the
    // factor of the rows' earlier sums, returned.
    auto softmax_tile = [&](int k0, float* sc, float* c, auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      auto visible = [&](int idx) {
        const int kpos = k0 + 8 * (idx / 4) + col + (idx % 2);
        const int qpos = q_off + row0 + 8 * ((idx / 2) % 2);
        return kpos < kv_valid && (!causal || kpos <= qpos) &&
               (!has_window || qpos - kpos < window);
      };
      float part[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[h][j] = kNeg;
#pragma unroll
      for (int idx = 0; idx < BKV / 2; ++idx) sc[idx] *= scale;
      if (has_cap) {
#pragma unroll
        for (int idx = 0; idx < BKV / 2; ++idx)
          sc[idx] = cap * tanhf(sc[idx] / cap);
      }
#pragma unroll
      for (int idx = 0; idx < BKV / 2; ++idx) {
        if constexpr (kMasked) {
          if (!visible(idx)) sc[idx] = kNeg;
        }
        float& pm = part[(idx / 2) % 2][(idx / 4) % 4];
        pm = fmaxf(pm, sc[idx]);
      }
      float m_new[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = fmaxf(fmaxf(part[h][0], part[h][1]),
                         fmaxf(part[h][2], part[h][3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new[h] = fmaxf(m[h], mx);
#pragma unroll
        for (int j = 0; j < 4; ++j) part[h][j] = 0.f;
      }
#pragma unroll
      for (int idx = 0; idx < BKV / 2; ++idx) {
        float p = expf(sc[idx] - m_new[(idx / 2) % 2]);
        if constexpr (kMasked) {
          if (!visible(idx)) p = 0.f;
        }
        sc[idx] = p;
        part[(idx / 2) % 2][(idx / 4) % 4] += p;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float rs = (part[h][0] + part[h][1]) + (part[h][2] + part[h][3]);
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        c[h] = expf(m[h] - m_new[h]);
        l[h] = l[h] * c[h] + rs;
        m[h] = m_new[h];
      }
    };
    auto softmax = [&](int it, float* sc, float* c) {
      const int k0 = (t_beg + it) * BKV;
      const int pa = q_off + qa;       // the position of row qa
      if (k0 + BKV > kv_valid || (causal && k0 + BKV - 1 > pa) ||
          (has_window && pa + 63 - k0 >= window))
        softmax_tile(k0, sc, c, Flag<true>{});
      else
        softmax_tile(k0, sc, c, Flag<false>{});
    };

    // P split into bf16 hi and lo parts, in the register-A fragment of a
    // 16-key step kk: chunks 2kk and 2kk + 1 of the accumulator.
    auto split_p = [&](const float* sc) {
#pragma unroll
      for (int r = 0; r < BKV / 4; ++r) {
        const float a = sc[2 * r], b = sc[2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[r] = pack_bf16(hi);
        p_lo[r] = pack_bf16(__floats2bfloat162_rn(a - hf.x, b - hf.y));
      }
    };

    mbar_wait(bar_q, 0);
    if (n_tiles > 0) {
      float c[2];
      {
        float sc[BKV / 2];
        mbar_wait(bar_k(0), 0);
        issue_s(0, sc);
        wgmma_wait<0>();
        fence_regs<BKV / 2>(sc);
        softmax(0, sc, c);               // acc is 0: nothing to rescale
        split_p(sc);
      }
      // Tile it's S = Q K^T and softmax run while tile it - 1's P.V is in
      // flight on the tensor cores; both tiles' barriers are waited for
      // before either product is issued.
      for (int it = 1; it < n_tiles; ++it) {
        const int sp = (it - 1) % C::STAGES;
        float sc[BKV / 2];
        mbar_wait(bar_v(sp), ((it - 1) / C::STAGES) & 1);
        mbar_wait(bar_k(it % C::STAGES), (it / C::STAGES) & 1);
        issue_s(it, sc);
        issue_pv(sp);
        wgmma_wait<1>();                 // S done; P.V may still run
        fence_regs<BKV / 2>(sc);
        softmax(it, sc, c);
        wgmma_wait<0>();
        retire_pv(sp);
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= c[(i / 2) % 2];
        split_p(sc);
      }
      const int s = (n_tiles - 1) % C::STAGES;
      mbar_wait(bar_v(s), ((n_tiles - 1) / C::STAGES) & 1);
      issue_pv(s);
      wgmma_wait<0>();
      retire_pv(s);
    }

    // Epilogue: rows below T, acc / max(l, 1e-30) in bf16.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= T_) continue;
      const float den = fmaxf(l[h], 1e-30f);
      __nv_bfloat16* orow = o + ((size_t)bh * T_ + row) * HD + col;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i + 2 * h] / den,
                                  acc[4 * i + 2 * h + 1] / den);
    }
  }
}

template <int HD, int BKV, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int T_, int S, int BK, int causal, int has_window, int window,
           int kv_valid, float scale, int has_cap, float cap, int q_off,
           cudaStream_t stream) {
  using C = Cfg<HD, BKV, NWG>;
  const int n_qt = (T_ + C::BQ - 1) / C::BQ;
  const long long blocks = (long long)BH * n_qt;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, HD, T_, BH, C::BQ);
  if (!err) err = make_map(&mk, k, HD, S, BK, BKV);
  if (!err) err = make_map(&mv, v, HD, S, BK, BKV);
  if (err) return err;
  auto kernel = fa_tc_kernel<HD, BKV, NWG>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), T_, BH, BH / BK, n_qt,
      causal, has_window, window, kv_valid, scale, has_cap, cap, q_off);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// float32 q, k, v, o: the SIMT kernel.  Returns a cudaError_t (0 on
// success).
extern "C" int fa_fwd_f32_launch(const void* q, const void* k, const void* v,
                                 void* o, int BH, int T_, int S, int BK,
                                 int hd, int causal, int has_window,
                                 int window, int kv_valid, float scale,
                                 int has_cap, float cap, int q_off,
                                 void* stream) {
  if (BK <= 0 || BH % BK || q_off < 0) return (int)cudaErrorInvalidValue;
  return simt::launch_hd<float>(hd, q, k, v, o, BH, T_, S, BK, causal,
                                has_window, window, kv_valid, scale, has_cap,
                                cap, q_off, static_cast<cudaStream_t>(stream));
}

// bfloat16 q, k, v, o at hd 16 or 32 (contiguous, 16-byte aligned): the
// SIMT kernel.  Returns a cudaError_t (0 on success).
extern "C" int fa_fwd_simt_bf16_launch(const void* q, const void* k,
                                       const void* v, void* o, int BH,
                                       int T_, int S, int BK, int hd,
                                       int causal, int has_window,
                                       int window, int kv_valid, float scale,
                                       int has_cap, float cap, int q_off,
                                       void* stream) {
  if (BK <= 0 || BH % BK || q_off < 0) return (int)cudaErrorInvalidValue;
  return simt::launch_hd<__nv_bfloat16>(
      hd, q, k, v, o, BH, T_, S, BK, causal, has_window, window, kv_valid,
      scale, has_cap, cap, q_off, static_cast<cudaStream_t>(stream));
}

// bfloat16 q, k, v, o (16-byte aligned, contiguous): the tensor-core
// kernel.  Returns a cudaError_t (0 on success).
extern "C" int fa_fwd_tc_launch(const void* q, const void* k, const void* v,
                                void* o, int BH, int T_, int S, int BK,
                                int hd, int causal, int has_window,
                                int window, int kv_valid, float scale,
                                int has_cap, float cap, int q_off,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BK <= 0 || BH % BK || q_off < 0) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return tc::launch<64, 128, 2>(q, k, v, o, BH, T_, S, BK, causal,
                                    has_window, window, kv_valid, scale,
                                    has_cap, cap, q_off, st);
    case 128:
      return tc::launch<128, 64, 2>(q, k, v, o, BH, T_, S, BK, causal,
                                    has_window, window, kv_valid, scale,
                                    has_cap, cap, q_off, st);
    case 256:
      return tc::launch<256, 64, 1>(q, k, v, o, BH, T_, S, BK, causal,
                                    has_window, window, kv_valid, scale,
                                    has_cap, cap, q_off, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
