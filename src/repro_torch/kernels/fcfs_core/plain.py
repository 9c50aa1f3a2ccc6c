"""Plain torch version of the lockstep shard core (CPU path and oracle).

A lane-vectorized translation of the reference's lockstep kernel body
(``repro/kernels/fcfs_core/kernel.py::_core_kernel``): every step
retires one admission, sense, release or write-transfer landing per
active lane, with per-lane gathers and scatters over float64 state
tensors.  The float work is only ``max`` and ``+``, in the reference's
order, so the result is bit-identical to the CUDA kernel
(``csrc/fcfs_core.cu``) and to :func:`ref.fcfs_core_ref` on any device.

Where the reference logs completions per step and scatters the log on
the host, this version writes ``fin`` directly: each real op finalizes
once, and idle lanes write the sink column ``MAXP``, zeroed at the end.

Every step updates its carried tensors in place, so on a CUDA device
the same step is captured once into a CUDA graph (``_GRAPH_STEPS``
steps per graph) and replayed: a step is ~150 small launches, and
issuing them one by one from Python costs milliseconds per step.  The
graph replays exactly the eager ops, so the result is the same.

State layout (float64; integers are exactly representable):

  ops   (L, MAXP, 10) — augmented op table (see ``ops.augment_ops``)
  state (L, D+1, NC)  — per-die rows, row D the masked-write sink;
                        NC = 14 (fifo lowering) or 17 (prio lowering)
  fifo  (L, D+1, Q)   — per-die rings of queued op ids; under the prio
                        lowering the hi ring is slots [0, CAPQ) and the
                        low ring [CAPQ, 2*CAPQ)
  acq   (L, CAPW+1, 4)— in-flight write transfers [done, seq, op, die];
                        slot CAPW is the sink
"""

from __future__ import annotations

import torch

# ops columns
(_ARR, _KIND, _DIE, _DUR, _A, _TR, _HP, _GDT, _GK0, _GREM0) = range(10)
# die-state columns (the last three exist only under the prio lowering)
(_EVT, _EVSEQ, _EVOP, _EVKIND, _HELD, _FREE, _REM, _AACT, _TRACT,
 _QHEAD, _QTAIL, _TOT, _BUSY, _NR, _QHEAD2, _QTAIL2, _BYP) = range(17)

_BIGSEQ = 1e18

#: Steps per captured CUDA graph (CUDA devices only).
_GRAPH_STEPS = 64
#: Eager steps before capture (the usual side-stream warm-up).
_WARM_STEPS = 3


def fcfs_core_plain(ops: torch.Tensor, timing: torch.Tensor, steps: int, *,
                    n_dies: int, capq: int, capw: int, prio: bool):
    """Run ``steps`` lockstep steps over every lane of ``ops``.

    ``ops`` (L, MAXP, 10) and ``timing`` (L, 4) [tdma, tecc, age_bound,
    pipelined] are float64 tensors on one device; a lane is pipelined
    where its flag is not 0.  Returns float64 tensors ``(fin (L, MAXP+1),
    diestat (L, D, 2), lane (L, 4))`` on that device.
    """
    L, maxp, _ = ops.shape
    D = n_dies
    dev = ops.device
    f64 = torch.float64
    lanes = torch.arange(L, device=dev)
    inf = float("inf")
    tdma, tecc, bound = timing[:, 0], timing[:, 1], timing[:, 2]
    pip = timing[:, 3] != 0.0
    # which sense handlers the lanes need: one when all lanes agree
    n_pip = int(pip.sum())
    serial_lanes, pip_lanes = n_pip < L, n_pip > 0

    ncols = 17 if prio else 14
    state = torch.zeros((L, D + 1, ncols), dtype=f64, device=dev)
    state[:, :, _EVT] = inf
    state[:, :, _FREE] = 1.0
    fifo = torch.zeros((L, D + 1, capq * (2 if prio else 1)), dtype=f64,
                       device=dev)
    acq = torch.zeros((L, capw + 1, 4), dtype=f64, device=dev)
    fin = torch.zeros((L, maxp + 1), dtype=f64, device=dev)
    # per-lane carries: [ch_busy, ch_tot, n_events, seq] (the ``lane``
    # output) and [admission cursor, ACQ head, ACQ tail]
    lanev = torch.zeros((L, 4), dtype=f64, device=dev)
    cur = torch.zeros((L, 3), dtype=torch.int64, device=dev)
    d_sink = torch.full((L,), D, dtype=torch.int64, device=dev)
    w_sink = torch.full_like(d_sink, capw)
    p_sink = torch.full_like(d_sink, maxp)

    def step():
        chb, ch_tot, n_ev, seqc = lanev.unbind(1)
        ai, aq_head, aq_tail = cur.unbind(1)
        # ---- candidate selection: per-die events + ACQ head ----------
        aq_row = acq[lanes, aq_head % capw].unbind(1)
        aq_empty = aq_head >= aq_tail
        aq_t = torch.where(aq_empty, inf, aq_row[0])
        aq_sq = torch.where(aq_empty, _BIGSEQ, aq_row[1])
        cand_t = torch.cat([state[:, :D, _EVT], aq_t[:, None]], dim=1)
        cand_s = torch.cat([state[:, :D, _EVSEQ], aq_sq[:, None]], dim=1)
        tmin = cand_t.amin(dim=1)
        is_min = cand_t == tmin[:, None]
        smin = torch.where(is_min, cand_s, _BIGSEQ).amin(dim=1)
        widx = (is_min & (cand_s == smin[:, None])).to(torch.int32) \
            .argmax(dim=1)

        adm_row = ops[lanes, ai].unbind(1)
        adm_t = adm_row[_ARR]
        active = (adm_t < inf) | (tmin < inf)
        take_adm = (adm_t <= tmin) & active
        take_ev = ~take_adm & active

        a_kind = adm_row[_KIND]
        a_die = adm_row[_DIE].to(torch.int64)
        is_r = take_adm & (a_kind == 0.0)
        is_w = take_adm & (a_kind == 1.0)
        is_e = take_adm & (a_kind == 2.0)

        ev_acq = take_ev & (widx == D)
        ev_die = take_ev & (widx < D)
        o_acq = aq_row[2].to(torch.int64)
        acq_die = aq_row[3].to(torch.int64)
        aq_head = aq_head + ev_acq.to(torch.int64)

        # the one die row this step reads/writes
        tgt = torch.where(take_adm & (is_r | is_e), a_die,
                          torch.where(ev_die, widx.to(torch.int64),
                                      torch.where(ev_acq, acq_die, d_sink)))
        row = state[lanes, tgt].unbind(1)

        if prio:
            hi_empty = row[_QTAIL] == row[_QHEAD]
            lo_empty = row[_QTAIL2] == row[_QHEAD2]
            q_empty = hi_empty & lo_empty
        else:
            q_empty = row[_QTAIL] == row[_QHEAD]
        die_free = (row[_FREE] == 1.0) & q_empty

        ev_kind = row[_EVKIND]
        ev_sense = ev_die & (ev_kind == 0.0)
        ev_rel = ev_die & (ev_kind == 1.0)

        # -- the channel collapse (write admission DMA or sense DMA) --
        touches = is_w | ev_sense
        c_done = torch.maximum(chb, torch.where(take_adm, adm_t, tmin)) + tdma
        chb = torch.where(touches, c_done, chb)
        ch_tot = torch.where(touches, ch_tot + tdma, ch_tot)

        # write admission: ACQ push at its DMA-done time (others: sink)
        aq_slot = torch.where(is_w, aq_tail % capw, w_sink)
        acq[lanes, aq_slot] = torch.stack(
            [c_done, seqc, ai.to(f64), adm_row[_DIE]], dim=1)
        aq_tail = aq_tail + is_w.to(torch.int64)

        # -- sense / copy handler --
        s_tm = tmin
        s_tr = row[_TRACT]
        if serial_lanes:
            s_more = row[_REM] > 1.0
            s_next = torch.where(s_more, (c_done + tecc) + s_tr, c_done)
            s_rem = row[_REM] - 1.0
        if pip_lanes:
            p_more = row[_REM] + 1.0 < row[_AACT]
            p_rel = torch.where(row[_AACT] > 1.0, s_tm + s_tr, s_tm)
            p_next = torch.where(p_more, torch.maximum(s_tm + s_tr, c_done),
                                 p_rel)
            p_rem = row[_REM] + 1.0
            if serial_lanes:
                s_more = torch.where(pip, p_more, s_more)
                s_next = torch.where(pip, p_next, s_next)
                s_rem = torch.where(pip, p_rem, s_rem)
            else:
                s_more, s_next, s_rem = p_more, p_next, p_rem
        s_fin = c_done + tecc

        # -- grants: admission (free die), ACQ landing, release pop --
        r_tm = tmin
        g_adm = (is_r | is_e) & die_free
        g_acq = ev_acq & die_free
        queue_push = ((is_r | is_e) & ~die_free) | (ev_acq & ~die_free)
        push_op = torch.where(take_adm, ai, o_acq)

        push_die = torch.where(queue_push, tgt, d_sink)
        if prio:
            push_hp = ops[lanes, push_op, _HP] == 1.0
            push_hi = queue_push & push_hp
            push_lo = queue_push & ~push_hp
            push_slot = torch.where(
                push_hp, row[_QTAIL].to(torch.int64) % capq,
                capq + row[_QTAIL2].to(torch.int64) % capq)
        else:
            push_slot = row[_QTAIL].to(torch.int64) % capq
        fifo[lanes, push_die, push_slot] = push_op.to(f64)

        q_nonempty = ~q_empty
        grant2 = ev_rel & q_nonempty
        if prio:
            byp = row[_BYP]
            lo_ne = ~lo_empty
            aged = ~hi_empty & lo_ne & (byp >= bound)
            pop_lo = aged | hi_empty
            qh = torch.where(
                pop_lo, capq + row[_QHEAD2].to(torch.int64) % capq,
                row[_QHEAD].to(torch.int64) % capq)
        else:
            qh = row[_QHEAD].to(torch.int64) % capq
        o2 = fifo[lanes, tgt, qh].to(torch.int64)

        grant_any = g_adm | g_acq | grant2
        g_op = torch.where(grant2, o2, torch.where(take_adm, ai, o_acq))
        g_row = ops[lanes, g_op].unbind(1)
        gr_tm = torch.where(take_adm, adm_t, r_tm)
        # the granted read's first remaining-attempt count, from the
        # lane's own flag (the table's grem0 column, restated per lane)
        g_rem0 = torch.where(pip | (g_row[_GK0] != 0.0), 0.0, g_row[_A])

        # ---- assemble the new die row --------------------------------
        new_evt = torch.where(
            ev_sense, s_next,
            torch.where(grant_any, gr_tm + g_row[_GDT],
                        torch.where(ev_rel, inf, row[_EVT])))
        sets_ev = ev_sense | grant_any
        cols = [
            new_evt,
            torch.where(sets_ev, seqc, row[_EVSEQ]),
            torch.where(grant_any, g_op.to(f64), row[_EVOP]),
            torch.where(ev_sense, torch.where(s_more, 0.0, 1.0),
                        torch.where(grant_any, g_row[_GK0],
                                    row[_EVKIND])),
            torch.where(grant_any, gr_tm, row[_HELD]),
            torch.where(grant_any, 0.0,
                        torch.where(ev_rel & ~q_nonempty, 1.0,
                                    row[_FREE])),
            torch.where(ev_sense, s_rem,
                        torch.where(grant_any, g_rem0, row[_REM])),
            torch.where(grant_any, g_row[_A], row[_AACT]),
            torch.where(grant_any, g_row[_TR], row[_TRACT]),
        ]
        if prio:
            cols += [row[_QHEAD] + (grant2 & ~pop_lo).to(f64),
                     row[_QTAIL] + push_hi.to(f64)]
        else:
            cols += [row[_QHEAD] + grant2.to(f64),
                     row[_QTAIL] + queue_push.to(f64)]
        cols += [
            torch.where(ev_rel, row[_TOT] + (r_tm - row[_HELD]),
                        row[_TOT]),
            torch.where(ev_rel, r_tm, row[_BUSY]),
            torch.where(grant_any, g_row[_GK0], row[_NR]),
        ]
        if prio:
            cols += [
                row[_QHEAD2] + (grant2 & pop_lo).to(f64),
                row[_QTAIL2] + push_lo.to(f64),
                torch.where(grant2,
                            torch.where(pop_lo, 0.0, byp + lo_ne.to(f64)),
                            byp),
            ]
        state[lanes, tgt] = torch.stack(cols, dim=1)

        # fin: final sense (reads) or release of a non-read
        fin_sense = ev_sense & ~s_more
        fin_rel = ev_rel & (row[_NR] == 1.0)
        fin_idx = torch.where(fin_sense | fin_rel,
                              row[_EVOP].to(torch.int64), p_sink)
        fin[lanes, fin_idx] = torch.where(fin_sense, s_fin, r_tm)

        # seq counter: one push per write admission (ACQ), per grant,
        # and per sense continuation
        pushed = is_w | grant_any | ev_sense
        lanev.copy_(torch.stack([chb, ch_tot, n_ev + take_ev.to(f64),
                                 seqc + pushed.to(f64)], dim=1))
        cur.copy_(torch.stack([ai + take_adm.to(torch.int64), aq_head,
                               aq_tail], dim=1))

    def run(n):
        for _ in range(n):
            step()

    if dev.type == "cuda" and steps > _WARM_STEPS + _GRAPH_STEPS:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run(_WARM_STEPS)
        torch.cuda.current_stream(dev).wait_stream(side)
        n_rep, tail = divmod(steps - _WARM_STEPS, _GRAPH_STEPS)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run(_GRAPH_STEPS)
        for _ in range(n_rep):
            graph.replay()
        run(tail)
    else:
        run(steps)

    fin[:, maxp] = 0.0
    diestat = torch.stack([state[:, :D, _TOT], state[:, :D, _BUSY]], dim=2)
    return fin, diestat, lanev.clone()
