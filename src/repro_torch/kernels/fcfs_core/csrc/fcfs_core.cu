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
//   * a lane of up to 16 dies chooses its event by a tree of depth 3
//     (4 past 8 dies) over the die slots in registers, not a scan of one
//     compare after another: the choice was most of a step's latency.
//     A wider lane (32 or 64 slots, or any count past 64) spreads its
//     slots over the 32 threads of warp 0, each reduces its own slots in
//     slot order, and a butterfly of shuffles over (time, seq, slot)
//     finds the least; thread 0 then retires the step alone and a
//     __syncwarp orders its writes before the next choice;
//   * everything the step chain reads lives in the block's shared
//     memory: the die-state rows (Dies; static, sized by the instance's
//     slots, or beside the rings past 64 dies), a compressed op table of
//     24 bytes a row (arrival, grant delta, one packed word of kind, hp
//     and attempts, and the die; ops.pack_ops), the per-die FIFO rings
//     and the ACQ ring of in-flight write transfers.  The block's
//     threads copy the table in with cp.async before the loop;
//   * the running op's class (read or not) is kept in the die state at
//     grant, so a release reads no op row, and the next admission time
//     is held in a register, so the admission compare never waits;
//   * ring capacities are powers of two (host-computed bounds, so a
//     ring never overwrites a live entry): a slot is a mask, not a
//     division;
//   * completion times go straight into fin[L, MAXP+1], in place of the
//     reference's per-step log and host scatter.
// A lane whose table and rings exceed the block's shared memory runs the
// same code with them in global memory (the `placement` argument; the
// wrapper chooses from the shapes); past 64 dies the die state goes with
// the rings.  fcfs_chain_probe_launch times the floor of that chain: the
// dependent f64 max and adds one retired step carries from event to
// event.
//
// Bit-identity: the float work is only max and + on doubles, written in
// the reference's association order (kernel.py:199,227,231-235,338), and
// the file is built with -fmad=false and without fast math.  The event
// choice keeps the reference's tie-breaks: least time, then least seq,
// then the lower die slot, die slots before the ACQ head
// (kernel.py:153-158; the tree keeps the lower slot of each pair on
// ties, the warp's reduction compares the slot last, so both pick the
// die the reference's argmax picks); admissions win ties
// (:163); seq counts one per write admission, grant and sense
// continuation (:382-383); the aged-priority pop compares the bypass
// count with a bound that may be +inf (:279-285).  Attempts are packed
// as an integer and converted back to an exact double.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// placement bits: what lives in shared memory (the rest in global).  The
// wrapper launches both bits or neither; one bit alone is the ablation
// of tools/fcfs_ablation.py.
constexpr int kOpsInSmem = 1, kRingsInSmem = 2;
// Bytes of one die's state: 9 f64 and 8 i32 fields.
constexpr int kDieBytes = 104;

// Die slots of the instance that runs a lane of n_dies dies: 8, 16, 32
// or 64, its die state in static shared memory; 0 past 64 dies, the
// generic instance, whose die state sits beside the rings (ops.die_slots).
__host__ __device__ inline int slots_of(int n_dies) {
  return n_dies <= 8 ? 8 : n_dies <= 16 ? 16 : n_dies <= 32 ? 32
       : n_dies <= 64 ? 64 : 0;
}

// Packed op word (ops.pack_ops): bits 0-1 kind (0 read, 1 write,
// 2 erase, 3 pad), bit 2 hp, bits 3-26 attempts.  The local die is a
// column of its own (i32), so a lane may hold any number of dies.
__device__ __forceinline__ int pk_kind(int p) { return p & 3; }
__device__ __forceinline__ int pk_hp(int p) { return (p >> 2) & 1; }
__device__ __forceinline__ double pk_att(int p) { return (double)(p >> 3); }

// Per-die state of one lane: each field a row of n slots, the nine f64
// rows first, then the eight i32 rows (kDieBytes a slot).  Ring counters
// count pushes and pops of one lane, at most MAXP < 2^31.
struct Dies {
  double *ev_t, *ev_seq, *held, *rem, *a_act, *tr_act, *tot, *busy, *byp;
  int *ev_op, *ev_kind, *nr, *is_free, *qh, *qt, *qh2, *qt2;
};

__device__ __forceinline__ Dies dies_at(double* d, int n) {
  int* i = (int*)(d + 9 * n);
  return Dies{d,         d + n,     d + 2 * n, d + 3 * n, d + 4 * n,
              d + 5 * n, d + 6 * n, d + 7 * n, d + 8 * n, i,
              i + n,     i + 2 * n, i + 3 * n, i + 4 * n, i + 5 * n,
              i + 6 * n, i + 7 * n};
}

// Byte offsets of the dynamic shared memory for one placement: the
// generic instance's die state (n_dies x kDieBytes), the ACQ ring
// (capw x [done, seq, op] f64), the op table (arrival f64, grant delta
// f64, packed word i32, die i32; MAXP rows each), the FIFO rings
// (n_dies x capq x (prio ? 2 : 1) i32).  Every offset is 8-aligned up to
// the i32 columns.
struct Layout {
  long long dies, acq, arr, gdt, pk, dk, fifo, bytes;
};

__host__ __device__ inline Layout layout(int maxp, int n_dies, int capq,
                                         int capw, int prio, int place) {
  Layout y{0, 0, 0, 0, 0, 0, 0, 0};
  long long off = 0;
  if (place & kRingsInSmem) {
    if (slots_of(n_dies) == 0) {
      y.dies = off;
      off += (long long)kDieBytes * n_dies;
    }
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
    y.dk = off;
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
// compares (8, 16, 32 or 64, at least n_dies; slots past n_dies stay at
// +inf), or 0 for the generic instance (n_dies slots, die state in
// dynamic shared memory with the rings, else in g_dies).
template <int kPlace, int kSlots>
__global__ void __launch_bounds__(kThreads) fcfs_core_kernel(
    const double* __restrict__ g_arr, const double* __restrict__ g_gdt,
    const int* __restrict__ g_pk, const int* __restrict__ g_dk, int maxp,
    int n_dies, const double* __restrict__ timing, long long steps,
    int capq, int capw, int prio, int* __restrict__ g_fifo,
    double* __restrict__ g_acq, double* __restrict__ g_dies,
    double* __restrict__ fin, double* __restrict__ diestat,
    double* __restrict__ lane_out) {
  // past 16 slots warp 0 shares the event choice; thread 0 retires steps
  constexpr bool kWarp = kSlots == 0 || kSlots > 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = blockIdx.x;                     // one lane per block
  const int qw = prio ? 2 * capq : capq;
  const Layout y = layout(maxp, n_dies, capq, capw, prio, kPlace);
  const long long row0 = (long long)l * maxp;
  const int nslot = kSlots > 0 ? kSlots : n_dies;

  Dies s;
  if constexpr (kSlots > 0) {
    __shared__ __align__(8) double die_rows[kSlots * kDieBytes / 8];
    s = dies_at(die_rows, kSlots);
  } else {
    s = dies_at((kPlace & kRingsInSmem)
                    ? (double*)(smem + y.dies)
                    : g_dies + (long long)l * (kDieBytes / 8) * n_dies,
                n_dies);
  }
  const double* __restrict__ arr =
      (kPlace & kOpsInSmem) ? (const double*)(smem + y.arr) : g_arr + row0;
  const double* __restrict__ gdt =
      (kPlace & kOpsInSmem) ? (const double*)(smem + y.gdt) : g_gdt + row0;
  const int* __restrict__ pk =
      (kPlace & kOpsInSmem) ? (const int*)(smem + y.pk) : g_pk + row0;
  const int* __restrict__ dk =
      (kPlace & kOpsInSmem) ? (const int*)(smem + y.dk) : g_dk + row0;
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
      cp_async<4>((void*)(dk + i), g_dk + row0 + i);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();
  const int tid = threadIdx.x;
  constexpr int kRunners = kWarp ? 32 : 1;      // threads of the loop
  if (tid >= kRunners) return;

  const double inf = CUDART_INF;
  const double tdma = timing[l * 4 + 0];
  const double tecc = timing[l * 4 + 1];
  const double bound = timing[l * 4 + 2];
  const bool pipelined = timing[l * 4 + 3] != 0.0;
  const int qm = capq - 1, wm = capw - 1;       // powers of two

  for (int d = n_dies + tid; d < nslot; d += kRunners) {
    s.ev_t[d] = inf;
    s.ev_seq[d] = inf;
  }
  for (int d = tid; d < n_dies; d += kRunners) {
    s.ev_t[d] = inf;
    s.ev_seq[d] = 0.0;
    s.held[d] = s.rem[d] = s.a_act[d] = s.tr_act[d] = 0.0;
    s.tot[d] = s.busy[d] = s.byp[d] = 0.0;
    s.ev_op[d] = s.ev_kind[d] = s.nr[d] = 0;
    s.is_free[d] = 1;
    s.qh[d] = s.qt[d] = s.qh2[d] = s.qt2[d] = 0;
  }
  if (kWarp) __syncwarp();
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
    const int d = dk[o];
    if (s.is_free[d] && !q_has(d)) {
      grant(d, o, p, tm);
    } else {
      q_push(d, o, p);
    }
  };

  // Retires one step, given the least (time, seq) over the die slots
  // and its slot: the ACQ head's compare, then the admission or the
  // event.  Returns false once the lane is idle.
  auto retire = [&](double tmin, double smin, int widx) {
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
    if (adm_t == inf && tmin == inf) return false;  // idle from here on

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
      return true;
    }

    n_ev += 1.0;
    if (widx == n_dies) {                       // write transfer landed
      const double* slot = aq + (aq_head & wm) * 3;
      const double tm = slot[0];
      const int o = (int)slot[2];
      aq_head += 1;
      take_die(o, pk[o], tm);
      return true;
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
    return true;
  };

  for (long long step = 0; step < steps; ++step) {
    if constexpr (!kWarp) {
      // candidate: least (time, seq) over the die slots, by a tree of
      // adjacent pairs
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
          const bool right = (tt[d + h] < tt[d]) |
                             ((tt[d + h] == tt[d]) & (qq[d + h] < qq[d]));
          if (right) {
            tt[d] = tt[d + h];
            qq[d] = qq[d + h];
            ww[d] = ww[d + h];
          }
        }
      }
      if (!retire(tt[0], qq[0], ww[0])) break;
    } else {
      // candidate: each thread's slots tid, tid + 32, ... in slot order,
      // then a butterfly over (time, seq, slot); every thread ends with
      // the least
      double t = inf, q = inf;
      int w = 0x7fffffff;
      for (int d = tid; d < nslot; d += 32) {
        const double td = s.ev_t[d], qd = s.ev_seq[d];
        if ((td < t) | ((td == t) & (qd < q))) {
          t = td;
          q = qd;
          w = d;
        }
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        const double t2 = __shfl_xor_sync(0xffffffffu, t, m);
        const double q2 = __shfl_xor_sync(0xffffffffu, q, m);
        const int w2 = __shfl_xor_sync(0xffffffffu, w, m);
        if ((t2 < t) | ((t2 == t) & ((q2 < q) | ((q2 == q) & (w2 < w))))) {
          t = t2;
          q = q2;
          w = w2;
        }
      }
      int go = 1;
      if (tid == 0) go = retire(t, q, w);
      __syncwarp();                             // thread 0's writes first
      if (!__shfl_sync(0xffffffffu, go, 0)) break;
    }
  }

  for (int d = tid; d < n_dies; d += kRunners) {
    diestat[((long long)l * n_dies + d) * 2 + 0] = s.tot[d];
    diestat[((long long)l * n_dies + d) * 2 + 1] = s.busy[d];
  }
  if (tid == 0) {
    lane_out[l * 4 + 0] = chb;
    lane_out[l * 4 + 1] = ch_tot;
    lane_out[l * 4 + 2] = n_ev;
    lane_out[l * 4 + 3] = seqc;
  }
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

typedef void (*KernelFn)(const double*, const double*, const int*,
                         const int*, int, int, const double*, long long, int,
                         int, int, int*, double*, double*, double*, double*,
                         double*);

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

// The instance for a lane of n_dies dies (at least 1) at `place`.
KernelFn kernel_of(int place, int n_dies) {
  switch (slots_of(n_dies)) {
    case 8: return kernel_of<8>(place);
    case 16: return kernel_of<16>(place);
    case 32: return kernel_of<32>(place);
    case 64: return kernel_of<64>(place);
    default: return kernel_of<0>(place);
  }
}

bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// The static shared memory of n_dies' instance (its die state).
int static_smem(int n_dies, long long* out) {
  cudaFuncAttributes a;
  cudaError_t e =
      cudaFuncGetAttributes(&a, kernel_of(kOpsInSmem | kRingsInSmem, n_dies));
  if (e != cudaSuccess) return (int)e;
  *out = (long long)a.sharedSizeBytes;
  return 0;
}

// Dynamic shared memory a block of n_dies' instance may take: the
// opt-in limit less the instance's static die state.
int smem_budget(int device, int n_dies, long long* out) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  long long fixed = 0;
  int f = static_smem(n_dies, &fixed);
  if (f != 0) return f;
  *out = (long long)optin - fixed;
  return 0;
}

}  // namespace

// Dynamic shared-memory bytes of one block for `placement` (bit 0: the
// op table in shared memory, bit 1: the rings and, past 64 dies, the die
// state).  ops.smem_bytes is the same formula; the card tests hold the
// two equal.
extern "C" long long fcfs_core_smem_bytes(int maxp, int n_dies, int capq,
                                          int capw, int prio,
                                          int placement) {
  return layout(maxp, n_dies, capq, capw, prio, placement).bytes;
}

// *out = the static shared memory of the instance for n_dies dies
// (ops.static_smem_bytes: kDieBytes x its slots, 0 past 64 dies).
extern "C" int fcfs_core_static_smem(int n_dies, long long* out) {
  if (n_dies < 1) return (int)cudaErrorInvalidValue;
  return static_smem(n_dies, out);
}

// *out = the dynamic shared memory a block for n_dies dies may take on
// `device`.
extern "C" int fcfs_core_smem_budget(int device, int n_dies,
                                     long long* out) {
  if (n_dies < 1) return (int)cudaErrorInvalidValue;
  return smem_budget(device, n_dies, out);
}

// *out = blocks of `placement`'s kernel for n_dies dies resident at once
// on `device` with `bytes` of dynamic shared memory each: blocks per SM
// x SMs.
extern "C" int fcfs_core_resident_blocks(int device, int placement,
                                         int n_dies, long long bytes,
                                         int* out) {
  KernelFn fn = n_dies >= 1 ? kernel_of(placement, n_dies) : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t c = cudaSetDevice(device);
  if (c != cudaSuccess) return (int)c;
  long long budget = 0;
  int e = smem_budget(device, n_dies, &budget);
  if (e != 0) return e;
  if (bytes < 0 || bytes > budget) return (int)cudaErrorInvalidValue;
  c = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
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
// contiguous tensors: the packed table arr, gdt (L, maxp) f64, pk and dk
// (L, maxp) i32 (ops.pack_ops), timing (L, 4) f64 [tdma, tecc,
// age_bound, pipelined], fin (L, maxp + 1) f64 zero-filled, diestat
// (L, n_dies, 2) f64, lane (L, 4) f64.  The rings live in shared memory
// where `placement` has bit 1, else in the global scratch fifo
// (L, n_dies, capq * (prio ? 2 : 1)) i32 and acq (L, capw, 3) f64; past
// 64 dies the die state goes with them, else in the scratch dies
// (L, 13 * n_dies) f64.  capq and capw must be powers of two.  Launches
// on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take, without
// launching; it does not synchronize.
extern "C" int fcfs_core_launch(const double* arr, const double* gdt,
                                const int* pk, const int* dk, int L,
                                int maxp, int n_dies, const double* timing,
                                long long steps, int capq, int capw,
                                int prio, int placement, int* fifo,
                                double* acq, double* dies, double* fin,
                                double* diestat, double* lane,
                                void* stream) {
  if (n_dies < 1 || !pow2(capq) || !pow2(capw) || maxp < 1) {
    return (int)cudaErrorInvalidValue;
  }
  KernelFn fn = kernel_of(placement, n_dies);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (!(placement & kRingsInSmem) &&
      (fifo == nullptr || acq == nullptr ||
       (slots_of(n_dies) == 0 && dies == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long bytes =
      layout(maxp, n_dies, capq, capw, prio, placement).bytes;
  if (bytes > 0) {
    int device = 0;
    long long budget = 0;
    cudaError_t c = cudaGetDevice(&device);
    if (c != cudaSuccess) return (int)c;
    int e = smem_budget(device, n_dies, &budget);
    if (e != 0) return e;
    if (bytes > budget) return (int)cudaErrorInvalidValue;
    c = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (c != cudaSuccess) return (int)c;
  }
  if (L > 0) {
    fn<<<L, kThreads, (size_t)bytes, (cudaStream_t)stream>>>(
        arr, gdt, pk, dk, maxp, n_dies, timing, steps, capq, capw, prio,
        fifo, acq, dies, fin, diestat, lane);
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
