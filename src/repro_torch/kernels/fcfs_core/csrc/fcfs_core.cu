// Open-loop shard core of the SSD simulator, one CUDA thread per lane.
//
// Replaces repro/kernels/fcfs_core/kernel.py::_core_kernel (the Pallas
// lockstep kernel of the JAX package).  A lane is one channel shard of
// one simulation cell (fused sweeps stack cells on lanes).  Each lane is
// a serial discrete-event loop: every iteration retires one admission,
// sense, release or write-transfer landing, in (time, seq) order with
// the admission cursor winning ties.  Lanes never communicate, so a
// thread runs its lane to completion and stops at the lane's first idle
// step — the later steps of the lockstep formulation are no-ops there.
//
// What bounds it on the H100: the serial per-lane dependency chain
// (steps of the longest lane x the latency of one step), not bytes or
// floating-point operations.  With L <= 64 lanes the card is nearly
// idle; the design keeps the per-step latency low instead:
//   * each lane runs alone in a block of one thread, so lanes taking
//     different branches never serialize each other inside a warp;
//   * the die-state rows of the lane live in the block's shared memory
//     (DieState), never in local or global memory;
//   * the per-die FIFO rings and the ACQ ring of in-flight write
//     transfers live in global scratch the wrapper allocates (capacities
//     are host-computed bounds, so a ring never overwrites a live entry);
//   * completion times go straight into fin[L, MAXP+1], in place of the
//     reference's per-step log and host scatter.
// fcfs_chain_probe_launch times the floor of that chain: the dependent
// f64 max and adds one retired step carries from event to event.
//
// Bit-identity: the float work is only max and + on doubles, written in
// the reference's association order (kernel.py:199,227,231-235,338), and
// the file is built with -fmad=false and without fast math.  The event
// choice keeps the reference's tie-breaks: least time, then least seq,
// die slots before the ACQ head (kernel.py:153-158); admissions win ties
// (:163); seq counts one per write admission, grant and sense
// continuation (:382-383); the aged-priority pop compares the bypass
// count with a bound that may be +inf (:279-285).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// augmented op-table columns (ops.augment_ops)
constexpr int kCols = 10;
constexpr int kArr = 0, kKind = 1, kDie = 2, kDur = 3, kAtt = 4, kTr = 5,
              kHp = 6;
// largest local die count a lane may hold (checked by the wrapper)
constexpr int kMaxDies = 16;

// Per-die state of one lane (one block's shared memory, 1600 bytes).
// Ring counters count pushes and pops of one lane, at most MAXP < 2^31.
struct DieState {
  double ev_t[kMaxDies], ev_seq[kMaxDies], held[kMaxDies], rem[kMaxDies];
  double a_act[kMaxDies], tr_act[kMaxDies], tot[kMaxDies], busy[kMaxDies];
  double byp[kMaxDies];
  int ev_op[kMaxDies], ev_kind[kMaxDies], is_free[kMaxDies];
  int qh[kMaxDies], qt[kMaxDies], qh2[kMaxDies], qt2[kMaxDies];
};

struct Lane {
  DieState& s;           // this lane's die rows (shared memory)
  const double* op;      // this lane's (MAXP, 10) op rows
  int* fq;               // this lane's (D, Q) FIFO rings of op ids
  int capq, qw, prio;
  double seqc;

  __device__ __forceinline__ double col(long long o, int c) const {
    return op[o * kCols + c];
  }

  __device__ __forceinline__ bool q_has(int d) const {
    return s.qt[d] > s.qh[d] || s.qt2[d] > s.qh2[d];
  }

  __device__ __forceinline__ void q_push(int d, long long o) {
    int* ring = fq + (long long)d * qw;
    if (prio && col(o, kHp) != 1.0) {
      ring[capq + s.qt2[d] % capq] = (int)o;
      s.qt2[d] += 1;
    } else {
      ring[s.qt[d] % capq] = (int)o;
      s.qt[d] += 1;
    }
  }

  // AgedHostPrioQueue.pop_next: the low ring when the hi ring is empty
  // or the low head has waited out `bound` bypasses; else the hi ring,
  // counting a bypass iff low work waits.  Any low pop resets the count.
  __device__ __forceinline__ long long q_pop(int d, double bound) {
    const int* ring = fq + (long long)d * qw;
    const bool hi_ne = s.qt[d] > s.qh[d];
    const bool lo_ne = s.qt2[d] > s.qh2[d];
    const bool pop_lo = prio && (!hi_ne || (lo_ne && s.byp[d] >= bound));
    if (pop_lo) {
      s.byp[d] = 0.0;
      const long long o = ring[capq + s.qh2[d] % capq];
      s.qh2[d] += 1;
      return o;
    }
    if (prio && lo_ne) s.byp[d] += 1.0;
    const long long o = ring[s.qh[d] % capq];
    s.qh[d] += 1;
    return o;
  }

  __device__ __forceinline__ void grant(int d, long long o, double tm,
                                        int pipelined) {
    s.held[d] = tm;
    s.is_free[d] = 0;
    s.ev_op[d] = (int)o;
    s.ev_seq[d] = seqc;
    if (col(o, kKind) == 0.0) {
      s.ev_t[d] = tm + col(o, kTr);
      s.ev_kind[d] = 0;
      s.rem[d] = pipelined ? 0.0 : col(o, kAtt);
      s.a_act[d] = col(o, kAtt);
      s.tr_act[d] = col(o, kTr);
    } else {  // write program or erase
      s.ev_t[d] = tm + col(o, kDur);
      s.ev_kind[d] = 1;
    }
    seqc += 1.0;
  }
};

__global__ void __launch_bounds__(1) fcfs_core_kernel(
    const double* __restrict__ ops, int L, int maxp, int n_dies,
    const double* __restrict__ timing, long long steps, int capq, int capw,
    int pipelined, int prio, int* __restrict__ fifo,
    double* __restrict__ acq, double* __restrict__ fin,
    double* __restrict__ diestat, double* __restrict__ lane_out) {
  const int l = blockIdx.x;                     // one lane per block
  const double inf = CUDART_INF;
  const double tdma = timing[l * 3 + 0];
  const double tecc = timing[l * 3 + 1];
  const double bound = timing[l * 3 + 2];

  __shared__ DieState s;
  const int qw = prio ? 2 * capq : capq;
  Lane ln{s, ops + (long long)l * maxp * kCols,
          fifo + (long long)l * n_dies * qw, capq, qw, prio, 0.0};
  for (int d = 0; d < n_dies; ++d) {
    s.ev_t[d] = inf;
    s.ev_seq[d] = 0.0;
    s.held[d] = s.rem[d] = s.a_act[d] = s.tr_act[d] = 0.0;
    s.tot[d] = s.busy[d] = s.byp[d] = 0.0;
    s.ev_op[d] = s.ev_kind[d] = 0;
    s.is_free[d] = 1;
    s.qh[d] = s.qt[d] = s.qh2[d] = s.qt2[d] = 0;
  }
  double* aq = acq + (long long)l * capw * 3;   // [done, seq, op] slots
  double* fn = fin + (long long)l * (maxp + 1);
  double chb = 0.0, ch_tot = 0.0, n_ev = 0.0;
  long long ai = 0, aq_head = 0, aq_tail = 0;

  for (long long step = 0; step < steps; ++step) {
    // candidate: least (time, seq) over the die slots, then the ACQ head
    double tmin = inf, smin = inf;
    int widx = -1;
    for (int d = 0; d < n_dies; ++d) {
      if (s.ev_t[d] < tmin || (s.ev_t[d] == tmin && s.ev_seq[d] < smin)) {
        tmin = s.ev_t[d];
        smin = s.ev_seq[d];
        widx = d;
      }
    }
    if (aq_head < aq_tail) {
      const double* slot = aq + (aq_head % capw) * 3;
      if (slot[0] < tmin || (slot[0] == tmin && slot[1] < smin)) {
        tmin = slot[0];
        smin = slot[1];
        widx = n_dies;
      }
    }
    const double adm_t = ai < maxp ? ln.col(ai, kArr) : inf;
    if (adm_t == inf && tmin == inf) break;   // lane idle from here on

    if (adm_t <= tmin) {                      // admission wins ties
      const long long o = ai++;
      const double tm = adm_t;
      if (ln.col(o, kKind) == 1.0) {          // write: channel transfer now
        const double done = (chb > tm ? chb : tm) + tdma;
        chb = done;
        ch_tot += tdma;
        double* slot = aq + (aq_tail % capw) * 3;
        slot[0] = done;
        slot[1] = ln.seqc;
        slot[2] = (double)o;
        aq_tail += 1;
        ln.seqc += 1.0;
      } else {                                // read or erase: take the die
        const int d = (int)ln.col(o, kDie);
        if (s.is_free[d] && !ln.q_has(d)) {
          ln.grant(d, o, tm, pipelined);
        } else {
          ln.q_push(d, o);
        }
      }
      continue;
    }

    n_ev += 1.0;
    if (widx == n_dies) {                     // write transfer landed
      const double* slot = aq + (aq_head % capw) * 3;
      const double tm = slot[0];
      const long long o = (long long)slot[2];
      aq_head += 1;
      const int d = (int)ln.col(o, kDie);
      if (s.is_free[d] && !ln.q_has(d)) {
        ln.grant(d, o, tm, pipelined);
      } else {
        ln.q_push(d, o);
      }
      continue;
    }

    const int d = widx;
    const double tm = s.ev_t[d];
    const long long o = s.ev_op[d];
    if (s.ev_kind[d] == 0) {                  // sense done / pipelined copy
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
      s.ev_seq[d] = ln.seqc;
      ln.seqc += 1.0;
    } else {                                  // release
      s.tot[d] += tm - s.held[d];
      s.busy[d] = tm;
      if (ln.col(o, kKind) != 0.0) fn[o] = tm;
      if (ln.q_has(d)) {
        const long long o2 = ln.q_pop(d, bound);
        ln.grant(d, o2, tm, pipelined);
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
  lane_out[l * 4 + 3] = ln.seqc;
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

}  // namespace

// C interface for ctypes.  All pointers are device pointers of
// contiguous tensors: ops (L, maxp, 10) f64, timing (L, 3) f64, fifo
// scratch (L, n_dies, capq * (prio ? 2 : 1)) i32, acq scratch
// (L, capw, 3) f64, fin (L, maxp + 1) f64 zero-filled, diestat
// (L, n_dies, 2) f64, lane (L, 4) f64.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); it does not synchronize.
extern "C" int fcfs_core_launch(const double* ops, int L, int maxp,
                                int n_dies, const double* timing,
                                long long steps, int capq, int capw,
                                int pipelined, int prio, int* fifo,
                                double* acq, double* fin, double* diestat,
                                double* lane, void* stream) {
  if (n_dies < 1 || n_dies > kMaxDies || capq < 1 || capw < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (L > 0) {
    fcfs_core_kernel<<<L, 1, 0, (cudaStream_t)stream>>>(
        ops, L, maxp, n_dies, timing, steps, capq, capw, pipelined, prio,
        fifo, acq, fin, diestat, lane);
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
