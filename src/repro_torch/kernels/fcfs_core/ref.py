"""Plain-Python reference for the lockstep sched-aware shard core.

Implements the same bounded-stream-merge algorithm as the CUDA kernel
(``csrc/fcfs_core.cu``) and its lockstep torch version
(:mod:`repro_torch.kernels.fcfs_core.plain`) — per-die single event slot,
write-transfer FIFO, admission cursor, explicit seq counters — one lane
at a time, with the identical float arithmetic (Python floats are IEEE
f64, and every add/max is written in the interpreter's association
order).  Used by the parity tests to pin the kernel bit-for-bit, and as
the unbatched fallback oracle.

``age_bound`` selects the scheduler: ``None`` is the single FIFO ring;
a float bound (``inf`` = plain host_prio) runs the dual priority rings
with the *verbatim* ``AgedHostPrioQueue.pop_next`` logic from
:mod:`repro_torch.flashsim.sched` — this oracle deliberately restates that
policy in queue-object terms so kernel parity is checked against an
independent restatement, not against itself.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_INF = float("inf")


def fcfs_core_ref(ops: np.ndarray, n_dies: int, pipelined: bool,
                  tdma: float, tecc: float,
                  age_bound: Optional[float] = None):
    """Run the shard core per lane in pure Python.

    ``ops``: (L, MAXP, 6 or 7) f64 — [arrival, kind, die, dur,
    attempts, tr, (hp)], admission order per lane, padded rows with
    ``arrival == inf``.  Column 6 (``hp``: 1.0 = host read) is the
    scheduling class; required when ``age_bound`` is not ``None``.
    Returns ``(fin, diestat, lane)`` with the same shapes/meaning as
    :func:`repro_torch.kernels.fcfs_core.ops.fcfs_core`.
    """
    L, maxp, ncol = ops.shape
    prio = age_bound is not None
    if prio and ncol < 7:
        raise ValueError("priority lowering needs the hp column (7-col "
                         f"op table), got {ncol} columns")
    fin = np.zeros((L, maxp + 1), dtype=np.float64)
    diestat = np.zeros((L, n_dies, 2), dtype=np.float64)
    lane = np.zeros((L, 4), dtype=np.float64)

    for l in range(L):
        arr = ops[l, :, 0]
        kind = ops[l, :, 1]
        die = np.where(np.isfinite(ops[l, :, 2]),
                       ops[l, :, 2], 0.0).astype(np.int64)
        dur = ops[l, :, 3]
        att = ops[l, :, 4]
        tr = ops[l, :, 5]
        hp = ops[l, :, 6] if ncol > 6 else np.zeros(maxp)
        n_adm = int((kind != 3.0).sum())   # pads are trailing

        ev_t = [_INF] * n_dies
        ev_seq = [0.0] * n_dies
        ev_op = [0] * n_dies
        ev_kind = [0] * n_dies      # 0=sense/copy, 1=release
        held = [0.0] * n_dies
        free = [True] * n_dies
        rem = [0.0] * n_dies
        a_act = [0.0] * n_dies
        tr_act = [0.0] * n_dies
        tot = [0.0] * n_dies
        busy = [0.0] * n_dies
        fifo: list = [[] for _ in range(n_dies)]       # hi ring (prio)
        fifo_lo: list = [[] for _ in range(n_dies)]
        byp = [0.0] * n_dies        # bypass counters (prio only)
        acq: list = []              # (done, seq, op) in push order
        aq_head = 0

        chb = 0.0
        ch_tot = 0.0
        seqc = 0.0
        n_ev = 0.0
        ai = 0

        def q_has(d: int) -> bool:
            return bool(fifo[d]) or bool(fifo_lo[d])

        def q_push(d: int, o: int) -> None:
            if prio and hp[o] != 1.0:
                fifo_lo[d].append(o)
            else:
                fifo[d].append(o)

        def q_pop(d: int) -> int:
            # AgedHostPrioQueue.pop_next (sched.py), restated: aged low
            # op jumps; else hi first (count the bypass iff low work
            # waits); any low pop resets the counter.
            if not prio:
                return fifo[d].pop(0)
            if fifo[d] and fifo_lo[d] and byp[d] >= age_bound:
                byp[d] = 0.0
                return fifo_lo[d].pop(0)
            if fifo[d]:
                if fifo_lo[d]:
                    byp[d] += 1.0
                return fifo[d].pop(0)
            byp[d] = 0.0
            return fifo_lo[d].pop(0)

        def grant(d: int, o: int, tm: float) -> None:
            nonlocal seqc
            held[d] = tm
            free[d] = False
            ev_op[d] = o
            ev_seq[d] = seqc
            if kind[o] == 0.0:
                ev_t[d] = tm + tr[o]
                ev_kind[d] = 0
                rem[d] = 0.0 if pipelined else att[o]
                a_act[d] = att[o]
                tr_act[d] = tr[o]
            else:                   # write program or erase
                ev_t[d] = tm + dur[o]
                ev_kind[d] = 1
            seqc += 1.0

        while True:
            # candidate: min (time, seq) over die slots + ACQ head
            tmin, smin, widx = _INF, _INF, -1
            for d in range(n_dies):
                if ev_t[d] < tmin or (ev_t[d] == tmin and ev_seq[d] < smin):
                    tmin, smin, widx = ev_t[d], ev_seq[d], d
            if aq_head < len(acq):
                at, asq, _ = acq[aq_head]
                if at < tmin or (at == tmin and asq < smin):
                    tmin, smin, widx = at, asq, n_dies
            adm_t = arr[ai] if ai < n_adm else _INF
            if adm_t == _INF and tmin == _INF:
                break

            if adm_t <= tmin:       # admission wins ties
                o = ai
                tm = adm_t
                ai += 1
                k = kind[o]
                if k == 1.0:        # write: channel transfer now
                    done = (chb if chb > tm else tm) + tdma
                    chb = done
                    ch_tot += tdma
                    acq.append((done, seqc, o))
                    seqc += 1.0
                else:               # read or erase: contend for the die
                    d = die[o]
                    if free[d] and not q_has(d):
                        grant(d, o, tm)
                    else:
                        q_push(d, o)
                continue

            n_ev += 1.0
            if widx == n_dies:      # ACQ: write transfer landed
                tm, _, o = acq[aq_head]
                aq_head += 1
                d = die[o]
                if free[d] and not q_has(d):
                    grant(d, o, tm)
                else:
                    q_push(d, o)
                continue

            d = widx
            tm = ev_t[d]
            o = ev_op[d]
            if ev_kind[d] == 0:     # sense done / pipelined copy
                done = (chb if chb > tm else tm) + tdma
                chb = done
                ch_tot += tdma
                if not pipelined:
                    r = rem[d] - 1.0
                    if r:
                        rem[d] = r
                        ev_t[d] = (done + tecc) + tr_act[d]
                    else:
                        fin[l, o] = done + tecc
                        ev_t[d] = done
                        ev_kind[d] = 1
                else:
                    i = rem[d]
                    if i + 1.0 < a_act[d]:
                        rem[d] = i + 1.0
                        tnext = tm + tr_act[d]
                        if done > tnext:
                            tnext = done
                        ev_t[d] = tnext
                    else:
                        fin[l, o] = done + tecc
                        ev_t[d] = tm + tr_act[d] if a_act[d] > 1.0 else tm
                        ev_kind[d] = 1
                ev_seq[d] = seqc
                seqc += 1.0
            else:                   # release
                tot[d] += tm - held[d]
                busy[d] = tm
                if kind[o] != 0.0:
                    fin[l, o] = tm
                if q_has(d):
                    o2 = q_pop(d)
                    grant(d, o2, tm)
                else:
                    free[d] = True
                    ev_t[d] = _INF

        diestat[l, :, 0] = tot
        diestat[l, :, 1] = busy
        lane[l] = (chb, ch_tot, n_ev, seqc)

    return fin, diestat, lane


def fused_core_ref(cells, n_dies: int, pipelined: bool):
    """Cell-axis oracle for the fused sweep lowering.

    Restates the *cell-axis law*: lanes never communicate, so running C
    independent cells stacked along the lane axis in one dispatch must
    equal running each cell alone with its own timing scalars.  This
    oracle therefore never sees a stacked table — it runs
    :func:`fcfs_core_ref` once per cell and concatenates, which is the
    independent restatement the fused-kernel parity tests pin
    :func:`repro_torch.kernels.fcfs_core.ops.fused_core` against.

    ``cells``: sequence of ``(ops, tdma, tecc, age_bound)`` tuples, one
    per cell, every ``ops`` of shape (L, MAXP, 6 or 7) with a common
    (L, MAXP).  Returns ``(fin, diestat, lane)`` with the cell-stacked
    shapes of :func:`fused_core` — cell c occupies rows
    [c*L, (c+1)*L).
    """
    fins, diestats, lanes = [], [], []
    for ops, tdma, tecc, age_bound in cells:
        fin, diestat, lane = fcfs_core_ref(
            ops, n_dies, pipelined, tdma, tecc, age_bound=age_bound)
        fins.append(fin)
        diestats.append(diestat)
        lanes.append(lane)
    return (np.concatenate(fins, axis=0),
            np.concatenate(diestats, axis=0),
            np.concatenate(lanes, axis=0))
