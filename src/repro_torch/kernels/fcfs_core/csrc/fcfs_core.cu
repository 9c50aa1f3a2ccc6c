// Open-loop shard core of the SSD simulator, one lane per block.
//
// Replaces repro/kernels/fcfs_core/kernel.py::_core_kernel (the Pallas
// lockstep kernel of the JAX package).  A lane is one channel shard of
// one simulation cell (fused sweeps stack cells on lanes).  Each lane is
// a serial discrete-event loop: every iteration retires one admission,
// sense, release or write-transfer landing, in (time, seq) order with
// the admission cursor winning ties.  Lanes never communicate, so one
// thread runs its lane to completion and stops at the lane's first idle
// step — the later steps of the lockstep formulation are no-ops there.
//
// What bounds it on the H100: the serial per-lane dependency chain
// (steps of the longest lane x the latency of one step), not bytes or
// floating-point operations.  A launch costs its longest lane as long
// as every lane is resident, so the wrapper stacks all lanes of a sweep
// into one launch and the design keeps the latency of one step low:
//   * each lane runs alone in its block, so lanes taking different
//     branches never serialize each other inside a warp;
//   * the event choice is a tree of depth 3 (4 past 8 dies) over the die
//     slots, not a scan of one compare after another: the choice was
//     most of a step's latency;
//   * everything the step chain reads lives in the block's shared
//     memory: the die-state rows (DieState), a compressed op table of
//     20 bytes a row (arrival, grant delta, and one packed word of kind,
//     hp, die and attempts; ops.pack_ops), the per-die FIFO rings and
//     the ACQ ring of in-flight write transfers.  The block's threads
//     copy the table in with cp.async before thread 0 runs the loop;
//   * the running op's class (read or not) is kept in DieState at
//     grant, so a release reads no op row, and the next admission time
//     is held in a register, so the admission compare never waits;
//   * ring capacities are powers of two (host-computed bounds, so a
//     ring never overwrites a live entry): a slot is a mask, not a
//     division;
//   * completion times go straight into fin[L, MAXP+1], in place of the
//     reference's per-step log and host scatter.
// A lane whose table and rings exceed the block's shared memory runs the
// same code with them in global memory (the `placement` argument; the
// wrapper chooses from the shapes).  fcfs_chain_probe_launch times the
// floor of that chain: the dependent f64 max and adds one retired step
// carries from event to event.
//
// Bit-identity: the float work is only max and + on doubles, written in
// the reference's association order (kernel.py:199,227,231-235,338), and
// the file is built with -fmad=false and without fast math.  The event
// choice keeps the reference's tie-breaks: least time, then least seq,
// die slots before the ACQ head (kernel.py:153-158; the tree keeps the
// lower slot of each pair on ties, so it picks the die the reference's
// scan picks, and finite slots never tie: their seqs are distinct);
// admissions win ties
// (:163); seq counts one per write admission, grant and sense
// continuation (:382-383); the aged-priority pop compares the bypass
// count with a bound that may be +inf (:279-285).  Attempts are packed
// as an integer and converted back to an exact double.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// largest local die count a lane may hold (checked by the wrapper)
constexpr int kMaxDies = 16;
constexpr int kThreads = 128;
// placement bits: what lives in shared memory (the rest in global).  The
// wrapper launches both bits or neither; one bit alone is the ablation
// of tools/fcfs_ablation.py.
constexpr int kOpsInSmem = 1, kRingsInSmem = 2;

// Packed op word (ops.pack_ops): bits 0-1 kind (0 read, 1 write,
// 2 erase, 3 pad), bit 2 hp, bits 3-6 local die, bits 7-30 attempts.
__device__ __forceinline__ int pk_kind(int p) { return p & 3; }
__device__ __forceinline__ int pk_hp(int p) { return (p >> 2) & 1; }
__device__ __forceinline__ int pk_die(int p) { return (p >> 3) & 15; }
__device__ __forceinline__ double pk_att(int p) { return (double)(p >> 7); }

// Per-die state of one lane (static shared memory).  Ring counters
// count pushes and pops of one lane, at most MAXP < 2^31.
struct DieState {
  double ev_t[kMaxDies], ev_seq[kMaxDies], held[kMaxDies], rem[kMaxDies];
  double a_act[kMaxDies], tr_act[kMaxDies], tot[kMaxDies], busy[kMaxDies];
  double byp[kMaxDies];
  int ev_op[kMaxDies], ev_kind[kMaxDies], nr[kMaxDies], is_free[kMaxDies];
  int qh[kMaxDies], qt[kMaxDies], qh2[kMaxDies], qt2[kMaxDies];
};

// Byte offsets of the dynamic shared memory for one placement: the ACQ
// ring (capw x [done, seq, op] f64), the op table (arrival f64, grant
// delta f64, packed word i32, MAXP rows each), the FIFO rings
// (n_dies x capq x (prio ? 2 : 1) i32).  Every offset is 8-aligned.
struct Layout {
  long long acq, arr, gdt, pk, fifo, bytes;
};

__host__ __device__ inline Layout layout(int maxp, int n_dies, int capq,
                                         int capw, int prio, int place) {
  Layout y{0, 0, 0, 0, 0, 0};
  long long off = 0;
  if (place & kRingsInSmem) {
    y.acq = off;
    off += 24LL * capw;
  }
  if (place & kOpsInSmem) {
    y.arr = off;
    off += 8LL * maxp;
    y.gdt = off;
    off += 8LL * maxp;
    y.pk = off;
    off += 4LL * maxp;
  }
  if (place & kRingsInSmem) {
    y.fifo = off;
    off += 4LL * n_dies * capq * (prio ? 2 : 1);
  }
  y.bytes = off;
  return y;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(kBytes)
               : "memory");
}

// kPlace: the placement bits; kSlots: die slots the event choice
// compares (8 or 16, at least n_dies; slots past n_dies stay at +inf).
template <int kPlace, int kSlots>
__global__ void __launch_bounds__(kThreads) fcfs_core_kernel(
    const double* __restrict__ g_arr, const double* __restrict__ g_gdt,
    const int* __restrict__ g_pk, int maxp, int n_dies,
    const double* __restrict__ timing, long long steps, int capq, int capw,
    int prio, int* __restrict__ g_fifo, double* __restrict__ g_acq,
    double* __restrict__ fin, double* __restrict__ diestat,
    double* __restrict__ lane_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ DieState s;
  const int l = blockIdx.x;                     // one lane per block
  const int qw = prio ? 2 * capq : capq;
  const Layout y = layout(maxp, n_dies, capq, capw, prio, kPlace);
  const long long row0 = (long long)l * maxp;

  const double* __restrict__ arr =
      (kPlace & kOpsInSmem) ? (const double*)(smem + y.arr) : g_arr + row0;
  const double* __restrict__ gdt =
      (kPlace & kOpsInSmem) ? (const double*)(smem + y.gdt) : g_gdt + row0;
  const int* __restrict__ pk =
      (kPlace & kOpsInSmem) ? (const int*)(smem + y.pk) : g_pk + row0;
  double* __restrict__ aq = (kPlace & kRingsInSmem)
                                ? (double*)(smem + y.acq)
                                : g_acq + (long long)l * capw * 3;
  int* __restrict__ fq = (kPlace & kRingsInSmem)
                             ? (int*)(smem + y.fifo)
                             : g_fifo + (long long)l * n_dies * qw;

  if (kPlace & kOpsInSmem) {                    // the whole block copies
    for (int i = threadIdx.x; i < maxp; i += kThreads) {
      cp_async<8>((void*)(arr + i), g_arr + row0 + i);
      cp_async<8>((void*)(gdt + i), g_gdt + row0 + i);
      cp_async<4>((void*)(pk + i), g_pk + row0 + i);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x != 0) return;                 // thread 0 runs the lane

  const double inf = CUDART_INF;
  const double tdma = timing[l * 4 + 0];
  const double tecc = timing[l * 4 + 1];
  const double bound = timing[l * 4 + 2];
  const bool pipelined = timing[l * 4 + 3] != 0.0;
  const int qm = capq - 1, wm = capw - 1;       // powers of two

  for (int d = n_dies; d < kSlots; ++d) {
    s.ev_t[d] = inf;
    s.ev_seq[d] = inf;
  }
  for (int d = 0; d < n_dies; ++d) {
    s.ev_t[d] = inf;
    s.ev_seq[d] = 0.0;
    s.held[d] = s.rem[d] = s.a_act[d] = s.tr_act[d] = 0.0;
    s.tot[d] = s.busy[d] = s.byp[d] = 0.0;
    s.ev_op[d] = s.ev_kind[d] = s.nr[d] = 0;
    s.is_free[d] = 1;
    s.qh[d] = s.qt[d] = s.qh2[d] = s.qt2[d] = 0;
  }
  double* __restrict__ fn = fin + (long long)l * (maxp + 1);
  double chb = 0.0, ch_tot = 0.0, n_ev = 0.0, seqc = 0.0;
  int ai = 0, aq_head = 0, aq_tail = 0;
  double adm_t = maxp > 0 ? arr[0] : inf;       // next admission's time

  auto q_has = [&](int d) {
    return s.qt[d] > s.qh[d] || s.qt2[d] > s.qh2[d];
  };
  auto q_push = [&](int d, int o, int p) {
    int* ring = fq + d * qw;
    if (prio && !pk_hp(p)) {
      ring[capq + (s.qt2[d] & qm)] = o;
      s.qt2[d] += 1;
    } else {
      ring[s.qt[d] & qm] = o;
      s.qt[d] += 1;
    }
  };
  // AgedHostPrioQueue.pop_next: the low ring when the hi ring is empty
  // or the low head has waited out `bound` bypasses; else the hi ring,
  // counting a bypass iff low work waits.  Any low pop resets the count.
  auto q_pop = [&](int d) {
    const int* ring = fq + d * qw;
    const bool hi_ne = s.qt[d] > s.qh[d];
    const bool lo_ne = s.qt2[d] > s.qh2[d];
    const bool pop_lo = prio && (!hi_ne || (lo_ne && s.byp[d] >= bound));
    if (pop_lo) {
      s.byp[d] = 0.0;
      const int o = ring[capq + (s.qh2[d] & qm)];
      s.qh2[d] += 1;
      return o;
    }
    if (prio && lo_ne) s.byp[d] += 1.0;
    const int o = ring[s.qh[d] & qm];
    s.qh[d] += 1;
    return o;
  };
  auto grant = [&](int d, int o, int p, double tm) {
    const double dt = gdt[o];
    s.held[d] = tm;
    s.is_free[d] = 0;
    s.ev_op[d] = o;
    s.ev_seq[d] = seqc;
    s.ev_t[d] = tm + dt;                        // tm + tR, or tm + dur
    if (pk_kind(p) == 0) {
      const double att = pk_att(p);
      s.ev_kind[d] = 0;
      s.nr[d] = 0;
      s.rem[d] = pipelined ? 0.0 : att;
      s.a_act[d] = att;
      s.tr_act[d] = dt;
    } else {                                    // write program or erase
      s.ev_kind[d] = 1;
      s.nr[d] = 1;
    }
    seqc += 1.0;
  };
  auto take_die = [&](int o, int p, double tm) {
    const int d = pk_die(p);
    if (s.is_free[d] && !q_has(d)) {
      grant(d, o, p, tm);
    } else {
      q_push(d, o, p);
    }
  };

  for (long long step = 0; step < steps; ++step) {
    // candidate: least (time, seq) over the die slots, by a tree of
    // adjacent pairs, then the ACQ head
    double tt[kSlots], qq[kSlots];
    int ww[kSlots];
#pragma unroll
    for (int d = 0; d < kSlots; ++d) {
      tt[d] = s.ev_t[d];
      qq[d] = s.ev_seq[d];
      ww[d] = d;
    }
#pragma unroll
    for (int h = 1; h < kSlots; h *= 2) {
#pragma unroll
      for (int d = 0; d < kSlots; d += 2 * h) {
        const bool right =
            (tt[d + h] < tt[d]) | ((tt[d + h] == tt[d]) & (qq[d + h] < qq[d]));
        if (right) {
          tt[d] = tt[d + h];
          qq[d] = qq[d + h];
          ww[d] = ww[d + h];
        }
      }
    }
    double tmin = tt[0], smin = qq[0];
    int widx = ww[0];
    if (aq_head < aq_tail) {
      const double* slot = aq + (aq_head & wm) * 3;
      const bool acq =
          (slot[0] < tmin) | ((slot[0] == tmin) & (slot[1] < smin));
      if (acq) {
        tmin = slot[0];
        smin = slot[1];
        widx = n_dies;
      }
    }
    if (adm_t == inf && tmin == inf) break;     // lane idle from here on

    if (adm_t <= tmin) {                        // admission wins ties
      const int o = ai++;
      const double tm = adm_t;
      const int p = pk[o];
      adm_t = ai < maxp ? arr[ai] : inf;
      if (pk_kind(p) == 1) {                    // write: channel transfer
        const double done = (chb > tm ? chb : tm) + tdma;
        chb = done;
        ch_tot += tdma;
        double* slot = aq + (aq_tail & wm) * 3;
        slot[0] = done;
        slot[1] = seqc;
        slot[2] = (double)o;
        aq_tail += 1;
        seqc += 1.0;
      } else {                                  // read or erase: the die
        take_die(o, p, tm);
      }
      continue;
    }

    n_ev += 1.0;
    if (widx == n_dies) {                       // write transfer landed
      const double* slot = aq + (aq_head & wm) * 3;
      const double tm = slot[0];
      const int o = (int)slot[2];
      aq_head += 1;
      take_die(o, pk[o], tm);
      continue;
    }

    const int d = widx;
    const double tm = tmin;
    const int o = s.ev_op[d];
    if (s.ev_kind[d] == 0) {                    // sense done / pipelined copy
      const double done = (chb > tm ? chb : tm) + tdma;
      chb = done;
      ch_tot += tdma;
      if (!pipelined) {
        const double r = s.rem[d] - 1.0;
        if (r != 0.0) {
          s.rem[d] = r;
          s.ev_t[d] = (done + tecc) + s.tr_act[d];
        } else {
          fn[o] = done + tecc;
          s.ev_t[d] = done;
          s.ev_kind[d] = 1;
        }
      } else {
        const double i = s.rem[d];
        if (i + 1.0 < s.a_act[d]) {
          s.rem[d] = i + 1.0;
          double tnext = tm + s.tr_act[d];
          if (done > tnext) tnext = done;
          s.ev_t[d] = tnext;
        } else {
          fn[o] = done + tecc;
          s.ev_t[d] = s.a_act[d] > 1.0 ? tm + s.tr_act[d] : tm;
          s.ev_kind[d] = 1;
        }
      }
      s.ev_seq[d] = seqc;
      seqc += 1.0;
    } else {                                    // release
      s.tot[d] += tm - s.held[d];
      s.busy[d] = tm;
      if (s.nr[d]) fn[o] = tm;
      if (q_has(d)) {
        const int o2 = q_pop(d);
        grant(d, o2, pk[o2], tm);
      } else {
        s.is_free[d] = 1;
        s.ev_t[d] = inf;
      }
    }
  }

  for (int d = 0; d < n_dies; ++d) {
    diestat[((long long)l * n_dies + d) * 2 + 0] = s.tot[d];
    diestat[((long long)l * n_dies + d) * 2 + 1] = s.busy[d];
  }
  lane_out[l * 4 + 0] = chb;
  lane_out[l * 4 + 1] = ch_tot;
  lane_out[l * 4 + 2] = n_ev;
  lane_out[l * 4 + 3] = seqc;
}

// The floor of one step's dependency chain: the channel collapse
// done = max(chb, t) + tdma feeds the next event time t = done + tecc,
// which the next step's choice compares.  One thread runs `steps` such
// links; the arguments come from the caller, so nothing folds.
__global__ void __launch_bounds__(1) fcfs_chain_probe_kernel(
    long long steps, double tdma, double tecc, double* __restrict__ out) {
  double chb = 0.0, t = 0.0;
  for (long long i = 0; i < steps; ++i) {
    const double done = (chb > t ? chb : t) + tdma;
    chb = done;
    t = done + tecc;
  }
  out[0] = chb;
  out[1] = t;
}

typedef void (*KernelFn)(const double*, const double*, const int*, int, int,
                         const double*, long long, int, int, int, int*,
                         double*, double*, double*, double*);

template <int kSlots>
KernelFn kernel_of(int place) {
  switch (place) {
    case 0: return fcfs_core_kernel<0, kSlots>;
    case kOpsInSmem: return fcfs_core_kernel<kOpsInSmem, kSlots>;
    case kRingsInSmem: return fcfs_core_kernel<kRingsInSmem, kSlots>;
    case kOpsInSmem | kRingsInSmem:
      return fcfs_core_kernel<kOpsInSmem | kRingsInSmem, kSlots>;
    default: return nullptr;
  }
}

// The instance for a lane of n_dies dies (1..kMaxDies) at `place`.
KernelFn kernel_of(int place, int n_dies) {
  return n_dies <= 8 ? kernel_of<8>(place) : kernel_of<kMaxDies>(place);
}

bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// Dynamic shared memory a block may take: the opt-in limit less the
// static DieState.
int smem_budget(int device, long long* out) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  *out = (long long)optin - (long long)sizeof(DieState);
  return 0;
}

}  // namespace

// Dynamic shared-memory bytes of one block for `placement` (bit 0: the
// op table in shared memory, bit 1: the rings).  ops.smem_bytes is the
// same formula; the card tests hold the two equal.
extern "C" long long fcfs_core_smem_bytes(int maxp, int n_dies, int capq,
                                          int capw, int prio,
                                          int placement) {
  return layout(maxp, n_dies, capq, capw, prio, placement).bytes;
}

// *out = the dynamic shared memory a block may take on `device`.
extern "C" int fcfs_core_smem_budget(int device, long long* out) {
  return smem_budget(device, out);
}

// *out = blocks of `placement`'s kernel for n_dies dies resident at once
// on `device` with `bytes` of dynamic shared memory each: blocks per SM
// x SMs.
extern "C" int fcfs_core_resident_blocks(int device, int placement,
                                         int n_dies, long long bytes,
                                         int* out) {
  KernelFn fn = n_dies >= 1 && n_dies <= kMaxDies
                    ? kernel_of(placement, n_dies)
                    : nullptr;
  long long budget = 0;
  int e = smem_budget(device, &budget);
  if (e != 0) return e;
  if (fn == nullptr || bytes < 0 || bytes > budget) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t c = cudaSetDevice(device);
  if (c == cudaSuccess) {
    c = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  }
  int per_sm = 0, sms = 0;
  if (c == cudaSuccess) {
    c = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      (size_t)bytes);
  }
  if (c == cudaSuccess) {
    c = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (c != cudaSuccess) return (int)c;
  *out = per_sm * sms;
  return 0;
}

// C interface for ctypes.  All pointers are device pointers of
// contiguous tensors: the packed table arr, gdt (L, maxp) f64 and pk
// (L, maxp) i32 (ops.pack_ops), timing (L, 4) f64 [tdma, tecc,
// age_bound, pipelined], fin (L, maxp + 1) f64 zero-filled, diestat
// (L, n_dies, 2) f64, lane (L, 4) f64.  The rings live in shared memory
// where `placement` has bit 1, else in the global scratch fifo
// (L, n_dies, capq * (prio ? 2 : 1)) i32 and acq (L, capw, 3) f64.
// capq and capw must be powers of two.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments the kernel does not take, without launching; it does not
// synchronize.
extern "C" int fcfs_core_launch(const double* arr, const double* gdt,
                                const int* pk, int L, int maxp, int n_dies,
                                const double* timing, long long steps,
                                int capq, int capw, int prio, int placement,
                                int* fifo, double* acq, double* fin,
                                double* diestat, double* lane, void* stream) {
  if (n_dies < 1 || n_dies > kMaxDies || !pow2(capq) || !pow2(capw) ||
      maxp < 1) {
    return (int)cudaErrorInvalidValue;
  }
  KernelFn fn = kernel_of(placement, n_dies);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const long long bytes =
      layout(maxp, n_dies, capq, capw, prio, placement).bytes;
  if (bytes > 0) {
    int device = 0;
    long long budget = 0;
    cudaError_t c = cudaGetDevice(&device);
    if (c != cudaSuccess) return (int)c;
    int e = smem_budget(device, &budget);
    if (e != 0) return e;
    if (bytes > budget) return (int)cudaErrorInvalidValue;
    c = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (c != cudaSuccess) return (int)c;
  }
  if (L > 0) {
    fn<<<L, kThreads, (size_t)bytes, (cudaStream_t)stream>>>(
        arr, gdt, pk, maxp, n_dies, timing, steps, capq, capw, prio, fifo,
        acq, fin, diestat, lane);
  }
  return (int)cudaGetLastError();
}

// Launches the chain probe on `stream` (out: 2 f64 on the device, the
// caller times it) and returns cudaGetLastError().
extern "C" int fcfs_chain_probe_launch(long long steps, double tdma,
                                       double tecc, double* out,
                                       void* stream) {
  fcfs_chain_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(steps, tdma,
                                                            tecc, out);
  return (int)cudaGetLastError();
}
