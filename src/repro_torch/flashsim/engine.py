"""Array event-core: the flashsim discrete-event interpreter loop.

This module is the bottom layer of the simulator's layered architecture:

  * :mod:`repro_torch.flashsim.ssd` (run orchestration: attempt sampling, stats)
  * :mod:`repro_torch.flashsim.sched` (die-queue policies: fcfs / host_prio / preempt)
  * :mod:`repro_torch.flashsim.gc_online` (completion-time-triggered GC, optional)
  * **this module** — the heap, the busy-until channel collapse, and the
    op-kind dispatch.

It is the host interpreter behind ``engine="array"``, the reference's
open-loop core with its online-GC and fault-recovery hooks and, below
it, its closed-loop interpreter (:func:`run_closed_loop`: bounded NCQ
admission, the host write-back cache of
:mod:`repro_torch.flashsim.hostcache`, an explicit channel transfer
phase, and the recovery tails of a fault plan).

Heap records are 2-tuples ``(time, seq << 40 | op_id << 2 | opcode)``: the
packed integer both tie-breaks FIFO (``seq`` in the high bits — push-order
discipline) and carries the whole event, so an event costs one tuple — no
closures, no argument unpacking.  Channels are single-server FCFS with
constant-duration transfers always requested at the current sim time, so
channel state collapses to a cumulative busy-until scalar (a transfer's
grant and completion times are exact at issue) — one heap event per read
attempt instead of two.  Each handler schedules at most one successor
event on its own behalf, so pop+push collapses into a ``heapreplace``
sift; online-GC injections may push extra events mid-handler.

Scheduler integration
---------------------
Die queues are policy objects from :mod:`repro_torch.flashsim.sched`.  Under
``fcfs`` the queue *is* a ``deque`` and the loop executes the exact heap
sequence of the pre-refactor monolithic engine — bit-identical SimStats.
``host_prio`` changes only which op a release dispatches.  ``preempt``
additionally arms two suspend paths:

  * **duration ops** (GC programs, erases): a host read admitted to a die
    held by an in-flight GC duration op suspends it immediately; the op
    re-enters the front of the low-priority class carrying its *residual*
    time (``op_end - now``), and its now-stale release event is ignored
    when it pops (detected by ``op_end[op] != time``).  Suspended elapsed
    time plus residual always sums to the op's original duration.
  * **GC reads**: checked at retry-attempt boundaries (the only points
    read-suspend firmware can interrupt a sense); the op yields with its
    remaining attempts — completed attempts are never re-executed — and
    resumes under the same copy/decode constraints it suspended with
    (``op_end`` stores the constraint instant while suspended).

Host operations are never suspended.

Per-channel sharding (``shard=True``)
-------------------------------------
The loop is parallel by construction: an op's die and channel are bound
by the static stripe (``die % n_channels == channel``), so ops of
different channels never share a die queue, a channel busy-until scalar,
or a scheduler instance.  ``run_event_core(..., shard=True)`` exploits
this by running one *shard loop* per channel — the same interpreter
(:func:`_run_shard`) over the admission substream of that channel's ops,
owning that channel's dies, queues, busy-until scalar, and (online mode)
its slice of the per-die GC state — and then combining the per-shard
completion streams with a thin deterministic merge
(:func:`merge_shard_results`): ``req_done`` is an elementwise max (a
request's pages may span channels), die/channel vectors take each
shard's owned entries, counters add.

The sharded run is **bit-identical** to the monolithic run: within one
shard, events are pushed in the same relative order as the monolithic
loop's events restricted to that channel (push-order tie-breaking is a
per-shard property), and cross-shard state is limited to the commutative
``req_done`` max and additive counters.  Online GC keeps this exact
because the FTL is die-partitioned (see :mod:`repro_torch.flashsim.ftl`) and
its attempt draws come from per-die RNG substreams
(:mod:`repro_torch.flashsim.gc_online`), so the draw sequence of a die does
not depend on how loops interleave across channels.  The shard loops
run sequentially in-process; cross-*run* parallelism lives a layer up in
:mod:`repro_torch.flashsim.runtime`.

Online-GC integration
---------------------
With an :class:`repro_torch.flashsim.gc_online.OnlineGC` controller
attached, the loop calls back at three points: host-read admission (FTL map + lazy
pre-fill + per-block attempt/tR resolution), host-program start (page
allocation at the *simulated* instant the die takes the program — the
free-block watermark trigger), and erase completion (the erased block
re-enters the free pool; stalled writes re-dispatch).  GC page-ops the
controller emits are admitted immediately at the current sim time through
the same queues as everything else.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional

from repro_torch.flashsim.sched import SchedulerPolicy

#: Event opcodes (low 2 bits of a heap record's packed code).
_EV_NEXT = 0    # serial read: sense done -> issue transfer, schedule next
_EV_COPY = 1    # pipelined read: copy into cache register -> issue transfer
_EV_ACQ = 2     # write: transfer landed -> acquire die for programming
_EV_REL = 3     # die release (read end / program end / erase end)

_INF = float("inf")
_SEQ1 = 1 << 40
_OPSHIFT_MASK = (1 << 40) - 1


@dataclasses.dataclass
class OpBuffers:
    """Flat per-op state driving one engine run (plain Python lists).

    The first ``len(arrival)`` entries are the admission stream (pre-
    sorted by arrival time); online GC appends further ops mid-run, so
    every consumer that needs per-op state holds a reference to these
    *growing* lists.  ``host_read`` is built by the engine when the
    scheduler classifies ops (None under fcfs).  The batched engine
    takes numpy columns in the same fields.
    """

    arrival: List[float]      # admission times of the initial stream
    rid: List[int]            # owning request id; -1 for GC/erase ops
    die: List[int]
    ch: List[int]
    read: List[bool]          # read-like (host read or GC read)
    erase: List[bool]
    dur: List[float]          # die-hold duration for write-like/erase ops
    a: List[int]              # attempt counts (reads)
    tr: List[float]           # per-attempt sense time (reads)
    rem: List[int]            # serial: attempts left; pipelined: copy idx
    held: List[float]         # die-held-since timestamp
    end: List[float]          # scheduled release / suspend constraint
    resid: List[float]        # residual duration of a suspended op
    susp: List[bool]          # suspended flag (preempt)
    host_read: Optional[List[bool]] = None
    #: Fault recovery (None without a fault model): extra full-strength
    #: re-reads appended after the op's last sampled attempt — the AR²
    #: misprediction re-read and/or uncorrectable-escalation attempts —
    #: executed as a serial continuation at ``xtr`` (nominal tR) with the
    #: die held throughout.
    xa: Optional[List[int]] = None
    xtr: Optional[List[float]] = None


@dataclasses.dataclass
class EngineResult:
    """Raw outcome of one event-core run (stats assembled by the caller)."""

    req_done: List[float]
    die_tot: List[float]
    ch_tot: List[float]
    die_busy: List[float]
    ch_busy: List[float]
    n_events: int
    gc_suspensions: int       # preempt: suspend events (duration + boundary)
    online_attempts: int      # online mode: total host-read attempts
    online_read_pages: int    # online mode: host read pages admitted
    #: Events retired by the batched lockstep kernel (0 for interpreter
    #: runs) — the "kernel fast path actually ran" observability counter.
    fast_path_events: int = 0
    #: Number of sweep cells sharing the kernel dispatch that produced
    #: this result (0 = not a fused dispatch) — the "fused sweep
    #: actually ran" observability counter.
    fused_cells: int = 0


def make_buffers(arrival, rid, die, ch, read, erase, dur, a, tr) -> OpBuffers:
    """Assemble :class:`OpBuffers`, deriving the per-run mutable state."""
    P = len(arrival)
    return OpBuffers(
        arrival=arrival, rid=rid, die=die, ch=ch, read=read, erase=erase,
        dur=dur, a=a, tr=tr, rem=a[:], held=[0.0] * P, end=[0.0] * P,
        resid=[0.0] * P, susp=[False] * P,
    )


def run_event_core(
    cfg,
    pipelined: bool,
    policy: SchedulerPolicy,
    bufs: OpBuffers,
    n_requests: int,
    online=None,
    validate: bool = False,
    shard: bool = False,
) -> EngineResult:
    """Run the interpreter loop over one admission stream.

    ``shard=False`` (default) runs the monolithic loop — one heap over
    every channel, the pre-refactor behavior.  ``shard=True`` decomposes
    the run into one loop per channel and merges the per-shard results
    (bit-identical; see the module docstring).  ``validate=True`` asserts
    work conservation (no die left idle while its queue holds a runnable
    op) after every step — test instrumentation, off on the hot path.
    """
    P = len(bufs.arrival)
    host_read = None
    if policy.prioritized:
        op_read, op_rid = bufs.read, bufs.rid
        host_read = [op_read[i] and op_rid[i] >= 0 for i in range(P)]
    bufs.host_read = host_read
    if online is not None:
        online.bind(bufs)

    if not shard or cfg.n_channels == 1:
        res = _run_shard(cfg, pipelined, policy, bufs, n_requests,
                         host_read, online, validate, None)
        if online is not None:
            online.assert_drained()
        return res

    # Per-channel decomposition: partition the admission stream by the
    # static die -> channel stripe.  Online injections never enter these
    # lists (they are admitted mid-loop at the current sim time) and are
    # die-local by the gc_online shard-scope contract, so the partition
    # computed up front stays exhaustive.
    n_ch = cfg.n_channels
    shard_ops: List[List[int]] = [[] for _ in range(n_ch)]
    for i, c in enumerate(bufs.ch[:P]):
        shard_ops[c].append(i)
    results = []
    for c in range(n_ch):
        if online is not None:
            online.set_shard_scope(range(c, cfg.n_dies, n_ch))
        results.append(
            _run_shard(cfg, pipelined, policy, bufs, n_requests,
                       host_read, online, validate, shard_ops[c])
        )
    if online is not None:
        online.set_shard_scope(None)
        online.assert_drained()
    return merge_shard_results(cfg, results)


def _run_shard(
    cfg,
    pipelined: bool,
    policy: SchedulerPolicy,
    bufs: OpBuffers,
    n_requests: int,
    host_read: Optional[List[bool]],
    online,
    validate: bool,
    shard_ops: Optional[List[int]],
) -> EngineResult:
    """One interpreter loop over an admission (sub)stream.

    ``shard_ops=None`` runs the whole stream (the monolithic loop);
    otherwise it is the list of op ids this shard admits, and the loop
    touches only those ops' dies and channel.  State vectors are
    allocated full-size either way — a shard writes only its owned
    entries, which is what :func:`merge_shard_results` reads back out.
    """
    t = cfg.timing
    tdma, tecc = t.tdma_us, t.tecc_us

    adm_t = bufs.arrival
    op_rid, op_die, op_ch = bufs.rid, bufs.die, bufs.ch
    op_read, op_erase, op_dur = bufs.read, bufs.erase, bufs.dur
    op_a, op_tr, op_rem = bufs.a, bufs.tr, bufs.rem
    op_held, op_end, op_resid, op_susp = (
        bufs.held, bufs.end, bufs.resid, bufs.susp
    )
    op_xa, op_xtr = bufs.xa, bufs.xtr
    P = len(adm_t)

    preempt = policy.preemptive

    n_dies, n_ch = cfg.n_dies, cfg.n_channels
    die_busy = [0.0] * n_dies   # busy_until; inf while held
    die_tot = [0.0] * n_dies
    dieq = policy.make_queues(n_dies, host_read)
    die_cur = [-1] * n_dies     # op currently holding the die
    ch_busy = [0.0] * n_ch
    ch_tot = [0.0] * n_ch

    req_done = [0.0] * n_requests

    heap: list = []
    push = heapq.heappush
    pop = heapq.heappop
    replace = heapq.heapreplace
    seqc = 0                      # already-shifted seq (increments 1<<40)
    n_events = 0
    gc_susp = 0
    online_attempts = 0
    online_read_pages = 0

    read_start_ev = _EV_COPY if pipelined else _EV_NEXT

    def admit_gc(o: int, tm: float) -> None:
        """Admit an online-injected GC page-op at the current instant."""
        nonlocal seqc
        if op_read[o]:
            d = op_die[o]
            if tm >= die_busy[d] and not dieq[d]:
                die_busy[d] = _INF
                op_held[o] = tm
                die_cur[d] = o
                if pipelined:
                    op_rem[o] = 0
                push(heap, (tm + op_tr[o], seqc | o << 2 | read_start_ev))
                seqc += _SEQ1
            else:
                dieq[d].append(o)
        elif op_erase[o]:
            d = op_die[o]
            if tm >= die_busy[d] and not dieq[d]:
                die_busy[d] = _INF
                op_held[o] = tm
                die_cur[d] = o
                rel = tm + op_dur[o]
                op_end[o] = rel
                push(heap, (rel, seqc | o << 2 | _EV_REL))
                seqc += _SEQ1
            else:
                dieq[d].append(o)
        else:
            c = op_ch[o]
            b = ch_busy[c]
            done = (b if b > tm else tm) + tdma
            ch_busy[c] = done
            ch_tot[c] += tdma
            push(heap, (done, seqc | o << 2 | _EV_ACQ))
            seqc += _SEQ1

    def drain_online(tm: float) -> None:
        for o in online.take_injected():
            admit_gc(o, tm)

    # Admission cursor merged with the heap (admits never enter it).  The
    # event sequence under fcfs is byte-for-byte the pre-refactor loop's.
    # A shard admits only its own ops (``shard_ops``); the monolithic
    # loop admits positionally (op == ai).
    n_adm = P if shard_ops is None else len(shard_ops)
    ai = 0
    if not n_adm:
        next_adm = _INF
    elif shard_ops is None:
        next_adm = adm_t[0]
    else:
        next_adm = adm_t[shard_ops[0]]
    while True:
        if heap:
            top = heap[0]
            tt = top[0]
        elif next_adm < _INF:
            top = None
            tt = _INF
        else:
            break
        if next_adm <= tt:
            op = ai if shard_ops is None else shard_ops[ai]
            tm = next_adm
            ai += 1
            if ai >= n_adm:
                next_adm = _INF
            elif shard_ops is None:
                next_adm = adm_t[ai]
            else:
                next_adm = adm_t[shard_ops[ai]]
            # Reads contend for their die; writes go straight to
            # the channel (program happens after the transfer);
            # erases hold their die with no channel traffic.
            if op_read[op]:
                if online is not None:
                    a_, tr_ = online.on_read_admit(op, tm)
                    op_a[op] = a_
                    op_rem[op] = a_
                    op_tr[op] = tr_
                    online_attempts += a_
                    online_read_pages += 1
                    if online.injected:
                        drain_online(tm)
                d = op_die[op]
                if tm >= die_busy[d] and not dieq[d]:
                    die_busy[d] = _INF
                    op_held[op] = tm
                    die_cur[d] = op
                    if pipelined:
                        op_rem[op] = 0
                    push(heap, (tm + op_tr[op],
                                seqc | op << 2 | read_start_ev))
                    seqc += _SEQ1
                elif preempt and host_read[op]:
                    dieq[d].append(op)
                    cur = die_cur[d]
                    if cur >= 0 and op_rid[cur] < 0 and not op_read[cur]:
                        # Read-suspend: the in-flight GC program/erase
                        # yields now; its pending release event goes
                        # stale (op_end mismatch) and the op carries its
                        # residual time back into the queue.
                        gc_susp += 1
                        die_tot[d] += tm - op_held[cur]
                        op_resid[cur] = op_end[cur] - tm
                        op_end[cur] = -1.0    # pending release is now stale
                        op_susp[cur] = True
                        dq = dieq[d]
                        dq.resume_push(cur)
                        op2 = dq.pop_next()     # oldest waiting host read
                        op_held[op2] = tm
                        die_cur[d] = op2
                        if pipelined:
                            op_rem[op2] = 0
                        push(heap, (tm + op_tr[op2],
                                    seqc | op2 << 2 | read_start_ev))
                        seqc += _SEQ1
                else:
                    dieq[d].append(op)
            elif op_erase[op]:
                d = op_die[op]
                if tm >= die_busy[d] and not dieq[d]:
                    die_busy[d] = _INF
                    op_held[op] = tm
                    die_cur[d] = op
                    rel = tm + op_dur[op]
                    if preempt:
                        op_end[op] = rel
                    push(heap, (rel, seqc | op << 2 | _EV_REL))
                    seqc += _SEQ1
                else:
                    dieq[d].append(op)
            else:
                c = op_ch[op]
                b = ch_busy[c]
                done = (b if b > tm else tm) + tdma
                ch_busy[c] = done
                ch_tot[c] += tdma
                push(heap, (done, seqc | op << 2 | _EV_ACQ))
                seqc += _SEQ1
            if validate:
                _check_work_conserving(die_busy, dieq)
            continue

        tm, code = top
        ev = code & 3
        op = (code & _OPSHIFT_MASK) >> 2
        n_events += 1

        if ev == _EV_COPY:
            # Pipelined copy into the cache register at tm: the sense is
            # done and the previous transfer has drained.  Issue the
            # transfer (completion time exact at issue) and schedule the
            # next copy at max(sense done, transfer drained) — both
            # already known — or end the sequence.
            c = op_ch[op]
            b = ch_busy[c]
            done = (b if b > tm else tm) + tdma
            ch_busy[c] = done
            ch_tot[c] += tdma
            i = op_rem[op]
            a = op_a[op]
            if i + 1 < a:
                op_rem[op] = i + 1
                if preempt and op_rid[op] < 0 and dieq[op_die[op]].has_host():
                    # Attempt boundary: the GC read yields to the waiting
                    # host read, keeping its remaining attempts and the
                    # cache-register constraint (previous transfer ends
                    # at `done`) for resume.
                    d = op_die[op]
                    dq = dieq[d]
                    gc_susp += 1
                    die_tot[d] += tm - op_held[op]
                    op_susp[op] = True
                    op_end[op] = done
                    dq.resume_push(op)
                    op2 = dq.pop_next()
                    op_held[op2] = tm
                    die_cur[d] = op2
                    op_rem[op2] = 0
                    replace(heap, (tm + op_tr[op2],
                                   seqc | op2 << 2 | _EV_COPY))
                else:
                    tnext = tm + op_tr[op]
                    if done > tnext:
                        tnext = done
                    replace(heap, (tnext, seqc | op << 2 | _EV_COPY))
            elif op_xa is not None and op_xa[op] > 0:
                # Recovery continuation: this attempt's decode *failed*
                # (misprediction or uncorrectable — known at done+tecc).
                # The firmware re-senses serially at full strength; the
                # die stays held for the whole ladder.
                op_rem[op] = op_xa[op]
                op_xa[op] = 0
                op_tr[op] = op_xtr[op]
                replace(heap, (done + tecc + op_tr[op],
                               seqc | op << 2 | _EV_NEXT))
            else:
                rid = op_rid[op]
                if rid >= 0:            # GC reads complete no request
                    fin = done + tecc
                    if fin > req_done[rid]:
                        req_done[rid] = fin
                # Final attempt leaves the die: charge one speculative
                # sense when the sequence actually retried.
                rel = tm + op_tr[op] if a > 1 else tm
                if preempt:
                    op_end[op] = rel
                replace(heap, (rel, seqc | op << 2 | _EV_REL))
            seqc += _SEQ1
        elif ev == _EV_NEXT:
            # Serial read: sense done at tm -> transfer -> decode; on
            # failure the firmware re-senses with the next table entry.
            c = op_ch[op]
            b = ch_busy[c]
            done = (b if b > tm else tm) + tdma
            ch_busy[c] = done
            ch_tot[c] += tdma
            rem = op_rem[op] - 1
            if rem:
                op_rem[op] = rem
                if preempt and op_rid[op] < 0 and dieq[op_die[op]].has_host():
                    # Attempt boundary: yield with remaining attempts;
                    # the decode verdict of this attempt is known at
                    # done + tecc, the resume constraint.
                    d = op_die[op]
                    dq = dieq[d]
                    gc_susp += 1
                    die_tot[d] += tm - op_held[op]
                    op_susp[op] = True
                    op_end[op] = done + tecc
                    dq.resume_push(op)
                    op2 = dq.pop_next()
                    op_held[op2] = tm
                    die_cur[d] = op2
                    replace(heap, (tm + op_tr[op2],
                                   seqc | op2 << 2 | _EV_NEXT))
                else:
                    replace(heap, (done + tecc + op_tr[op],
                                   seqc | op << 2 | _EV_NEXT))
            elif op_xa is not None and op_xa[op] > 0:
                # Recovery continuation (see _EV_COPY): extra serial
                # full-strength re-reads after the failed final attempt.
                op_rem[op] = op_xa[op]
                op_xa[op] = 0
                op_tr[op] = op_xtr[op]
                replace(heap, (done + tecc + op_tr[op],
                               seqc | op << 2 | _EV_NEXT))
            else:
                rid = op_rid[op]
                if rid >= 0:            # GC reads complete no request
                    fin = done + tecc
                    if fin > req_done[rid]:
                        req_done[rid] = fin
                # Die freed at last transfer; the decode tail is off-die.
                if preempt:
                    op_end[op] = done
                replace(heap, (done, seqc | op << 2 | _EV_REL))
            seqc += _SEQ1
        elif ev == _EV_REL:
            # Die release: read end, write program end, or erase end.
            if preempt and op_end[op] != tm:
                # Stale release of an op that was suspended (and possibly
                # rescheduled) after this event was pushed.
                pop(heap)
                if validate:
                    _check_work_conserving(die_busy, dieq)
                continue
            d = op_die[op]
            die_tot[d] += tm - op_held[op]
            die_busy[d] = tm
            if online is not None and op_erase[op]:
                # The erased block re-enters the free pool *now* —
                # writes stalled on this die become runnable again.
                online.on_erase_complete(op, tm)
                unstalled = online.take_unstalled()
                if unstalled:
                    dq0 = dieq[d]
                    for o in unstalled:
                        dq0.append(o)
            dq = dieq[d]
            op2 = -1
            while dq:
                cand = dq.pop_next()
                if (online is not None and not op_read[cand]
                        and not op_erase[cand] and op_rid[cand] >= 0):
                    # Host program start: the FTL maps the page at the
                    # simulated instant the die takes the program.
                    die_busy[d] = _INF    # reserve while the FTL maps
                    if online.on_program_start(cand, tm):
                        if online.injected:
                            drain_online(tm)
                        op2 = cand
                        break
                    die_busy[d] = tm      # no free page: stall, try next
                    online.stall(cand)
                    continue
                op2 = cand
                break
            if op2 >= 0:
                die_busy[d] = _INF
                op_held[op2] = tm
                die_cur[d] = op2
                if op_read[op2]:
                    if preempt and op_susp[op2]:
                        # Resume a boundary-suspended GC read under the
                        # constraints it suspended with.
                        op_susp[op2] = False
                        if pipelined:
                            t2 = tm + op_tr[op2]
                            c2 = op_end[op2]
                            if c2 > t2:
                                t2 = c2
                            replace(heap, (t2, seqc | op2 << 2 | _EV_COPY))
                        else:
                            base = op_end[op2]
                            t2 = (base if base > tm else tm) + op_tr[op2]
                            replace(heap, (t2, seqc | op2 << 2 | _EV_NEXT))
                    else:
                        if pipelined:
                            op_rem[op2] = 0
                        replace(heap, (tm + op_tr[op2],
                                       seqc | op2 << 2 | read_start_ev))
                else:
                    # Program or erase: hold the die for the op's
                    # duration (tPROG / t_erase / residual), then release.
                    dur = op_dur[op2]
                    if preempt and op_susp[op2]:
                        op_susp[op2] = False
                        dur = op_resid[op2]
                    rel2 = tm + dur
                    if preempt:
                        op_end[op2] = rel2
                    replace(heap, (rel2, seqc | op2 << 2 | _EV_REL))
                seqc += _SEQ1
            else:
                die_cur[d] = -1
                pop(heap)
            if not op_read[op]:
                rid = op_rid[op]
                if rid >= 0 and tm > req_done[rid]:
                    req_done[rid] = tm
        else:
            # _EV_ACQ — write transfer landed: acquire the die.
            d = op_die[op]
            if tm >= die_busy[d] and not dieq[d]:
                granted = True
                if online is not None and op_rid[op] >= 0:
                    die_busy[d] = _INF    # reserve while the FTL maps
                    granted = online.on_program_start(op, tm)
                    if granted:
                        if online.injected:
                            drain_online(tm)
                    else:
                        die_busy[d] = tm
                        online.stall(op)
                        pop(heap)
                if granted:
                    die_busy[d] = _INF
                    op_held[op] = tm
                    die_cur[d] = op
                    rel = tm + op_dur[op]
                    if preempt:
                        op_end[op] = rel
                    replace(heap, (rel, seqc | op << 2 | _EV_REL))
                    seqc += _SEQ1
            else:
                dieq[d].append(op)
                pop(heap)
        if validate:
            _check_work_conserving(die_busy, dieq)

    return EngineResult(
        req_done=req_done,
        die_tot=die_tot,
        ch_tot=ch_tot,
        die_busy=die_busy,
        ch_busy=ch_busy,
        n_events=n_events,
        gc_suspensions=gc_susp,
        online_attempts=online_attempts,
        online_read_pages=online_read_pages,
    )


def merge_shard_results(cfg, results: List[EngineResult]) -> EngineResult:
    """Deterministically combine per-channel shard results into one.

    ``results[c]`` is channel ``c``'s shard.  Cross-shard state is, by
    construction, limited to commutative/additive quantities:

      * ``req_done`` — elementwise max across shards (a request's pages
        may stripe over several channels; each shard recorded the last
        completion among *its* pages);
      * die vectors — each die is owned by exactly one shard
        (``die % n_channels == channel``), so the merge selects the
        owner's entries;
      * channel vectors — shard ``c`` owns exactly channel ``c``;
      * event/suspension/attempt counters — sums.

    The merge is independent of shard execution order, which is what
    makes the decomposition safe to parallelize at a higher layer.
    """
    n_ch = cfg.n_channels
    n_dies = cfg.n_dies
    if len(results) != n_ch:
        raise ValueError(
            f"expected one shard result per channel ({n_ch}), "
            f"got {len(results)}"
        )
    n_req = len(results[0].req_done)
    req_done = [0.0] * n_req
    die_tot = [0.0] * n_dies
    die_busy = [0.0] * n_dies
    ch_tot = [0.0] * n_ch
    ch_busy = [0.0] * n_ch
    n_events = gc_susp = attempts = read_pages = 0
    for c, r in enumerate(results):
        for i, v in enumerate(r.req_done):
            if v > req_done[i]:
                req_done[i] = v
        for d in range(c, n_dies, n_ch):
            die_tot[d] = r.die_tot[d]
            die_busy[d] = r.die_busy[d]
        ch_tot[c] = r.ch_tot[c]
        ch_busy[c] = r.ch_busy[c]
        n_events += r.n_events
        gc_susp += r.gc_suspensions
        attempts += r.online_attempts
        read_pages += r.online_read_pages
    return EngineResult(
        req_done=req_done,
        die_tot=die_tot,
        ch_tot=ch_tot,
        die_busy=die_busy,
        ch_busy=ch_busy,
        n_events=n_events,
        gc_suspensions=gc_susp,
        online_attempts=attempts,
        online_read_pages=read_pages,
    )


# ---------------------------------------------------------------------------
# Closed-loop interpreter (ncq_depth set): bounded NCQ admission, host
# write-back cache, and an explicit channel transfer phase.
# ---------------------------------------------------------------------------

#: Closed-loop event kinds (tuple field, not packed — this loop favors
#: legibility; the open-loop packed encoding above stays untouched).
_CL_ARRIVE = 0   # a queued request reaches the device boundary
_CL_SENSE = 1    # a read attempt's sense finished on the die
_CL_XFER = 2     # a channel DMA transfer finished
_CL_REL = 3      # scheduled die release (program end / speculative sense)
_CL_RDONE = 4    # request complete -> free its NCQ slot

#: Tail state of a pipelined read once its last sampled attempt copied.
_TAIL_NONE = 0
_TAIL_FIN = 1    # final transfer in flight; decode tail completes the op
_TAIL_XA = 2     # final decode fails; serial recovery ladder follows


@dataclasses.dataclass
class ClosedLoopResult:
    """Raw outcome of one closed-loop run (stats assembled by ssd.py)."""

    req_done: List[float]         # completion time per request
    req_admit: List[float]        # device-admission time per request
    die_tot: List[float]          # die-held time (same meaning as open loop)
    die_sense_tot: List[float]    # time each die spent actually sensing
    ch_tot: List[float]           # channel transfer occupancy
    die_busy: List[float]         # final busy-until (span accounting)
    ch_busy: List[float]
    n_events: int
    attempts_issued: int          # host-read attempts sent to the device
    read_pages_issued: int        # host-read page-ops sent to the device
    max_inflight: int             # peak admitted-and-incomplete requests
    full_hit_reads: int           # reads served entirely from the cache
    hit_pages: int                # read page-ops served from dirty lines
    absorbed_writes: int          # writes absorbed by the cache
    flush_pages: int              # page programs issued by cache flushes
    stalled_writes: int           # writes that waited on cache capacity
    #: Only with ``trace_phases=True``: ``(op, kind, resource, start,
    #: end)`` tuples, kind in {"sense", "xfer", "prog", "erase"} —
    #: the raw material for the interval-invariant property tests.
    phases: Optional[list] = None


def run_closed_loop(
    cfg,
    pipelined: bool,
    policy: SchedulerPolicy,
    bufs: OpBuffers,
    n_requests: int,
    req_arrival: List[float],
    req_is_read: List[bool],
    ncq_depth: int,
    op_lpn: Optional[List[int]] = None,
    cache=None,
    validate: bool = False,
    trace_phases: bool = False,
) -> ClosedLoopResult:
    """Closed-loop run: NCQ-gated admission over an admission stream.

    The stream in ``bufs`` is the same one the open-loop core executes
    (expansion / FTL prepass / fault plan — attempt counts pre-sampled),
    but requests are admitted **on completion**, not at trace time: ops
    are grouped by owning request (each request's ops plus the GC/fault
    ops interleaved at its trigger point form one *group*), at most
    ``ncq_depth`` requests occupy slots at once, and a group's ops enter
    the device only when its slot frees and every earlier group has been
    admitted (stream order — exactly the order the FTL prepass and fault
    plan assumed, so their precomputed mappings stay valid; only times
    shift).

    Unlike the open-loop core's busy-until collapse, the channel here is
    an explicit single-server FIFO: transfers are *requested* at sense
    end (or program issue) and *granted* when the wire frees, which keeps
    the same FCFS timing while making the sense/transfer split — the
    die/DMA overlap that CACHE READ pipelining (PR²) exploits —
    observable per phase (``trace_phases``) and per die
    (``die_sense_tot``).

    With a :class:`~repro_torch.flashsim.hostcache.WriteCache` attached, write
    groups that fit are absorbed (completing at ``cache.cfg.hit_us``),
    their programs parked until a watermark flush re-issues them as
    low-priority device traffic; reads that hit a resident dirty line
    are served from the cache.  Not supported here: ``preempt``
    scheduling and online GC (both raise upstream in ssd.py).
    """
    if policy.preemptive:
        raise NotImplementedError(
            "closed-loop frontend does not support the preempt scheduler"
        )
    t = cfg.timing
    tdma, tecc = t.tdma_us, t.tecc_us
    hit_us = cache.cfg.hit_us if cache is not None else 0.0

    op_rid, op_die, op_ch = bufs.rid, bufs.die, bufs.ch
    op_read, op_erase, op_dur = bufs.read, bufs.erase, bufs.dur
    op_a, op_tr = bufs.a, bufs.tr
    op_xa = bufs.xa if bufs.xa is not None else None
    op_xtr = bufs.xtr
    P = len(bufs.arrival)

    host_read = None
    if policy.prioritized:
        host_read = [op_read[i] and op_rid[i] >= 0 for i in range(P)]
    bufs.host_read = host_read

    # ---- request groups: contiguous runs of the admission stream ------
    # Each group is one request's ops plus every rid = -1 op interleaved
    # at its trigger point (GC traffic, fault relocations) and the
    # stripe-peer rebuild reads (which carry the request's own rid).
    grp_lo: List[int] = []
    grp_hi: List[int] = []
    grp_rid: List[int] = []
    cur_rid = None
    for i in range(P):
        r = op_rid[i]
        if r >= 0 and r != cur_rid:
            if cur_rid is None and grp_lo:
                raise AssertionError("admission stream starts with GC ops")
            grp_lo.append(i)
            grp_rid.append(r)
            if len(grp_lo) > 1:
                grp_hi.append(i)
            cur_rid = r
        elif not grp_lo:
            raise AssertionError("admission stream starts with GC ops")
    grp_hi.append(P)
    n_groups = len(grp_lo)
    # Each request must own exactly one contiguous run.  Rids need not be
    # sorted (unsorted traces admit in stream order, a permutation of
    # 0..n-1) — only uniqueness and completeness are required.
    if n_groups != n_requests or len(set(grp_rid)) != n_requests:
        raise AssertionError(
            "closed-loop grouping expects one contiguous op run per "
            "request in the admission stream"
        )

    # ---- per-op state --------------------------------------------------
    o_rem = op_a[:]               # serial: attempts left (incl. in flight)
    o_left = [0] * P              # pipelined: attempts not yet sensed
    o_tr = op_tr[:]               # live sense time (xa swaps in xtr)
    o_xa = op_xa[:] if op_xa is not None else [0] * P
    o_serial = [not pipelined] * P
    o_regfree = [True] * P        # pipelined: cache register drained
    o_sense_t = [-1.0] * P        # pipelined: sense done, waiting on reg
    o_tail = [_TAIL_NONE] * P
    o_held = [0.0] * P
    o_defer = [False] * P         # cache-deferred op (no request account)
    o_fver = [0] * P              # flush version of a deferred program

    n_dies, n_ch = cfg.n_dies, cfg.n_channels
    die_cur = [-1] * n_dies
    die_busy = [0.0] * n_dies
    die_tot = [0.0] * n_dies
    die_sense = [0.0] * n_dies
    dieq = policy.make_queues(n_dies, host_read)
    ch_cur = [-1] * n_ch
    ch_q = [[] for _ in range(n_ch)]      # FIFO via index cursor
    ch_head = [0] * n_ch
    ch_busy = [0.0] * n_ch
    ch_tot = [0.0] * n_ch

    req_done = [0.0] * n_requests
    req_admit = [0.0] * n_requests
    req_pend = [0] * n_requests

    heap: list = []
    push = heapq.heappush
    seq = 0
    n_events = 0
    attempts_issued = 0
    read_pages_issued = 0
    inflight = 0
    max_inflight = 0
    full_hit_reads = 0
    stalled_writes = 0
    phases: Optional[list] = [] if trace_phases else None

    def emit(tm, ev, idx):
        nonlocal seq
        push(heap, (tm, seq, ev, idx))
        seq += 1

    # ---- channel: explicit single-server FIFO transfer phase -----------
    def start_transfer(c, o, tm):
        ch_cur[c] = o
        ch_tot[c] += tdma
        ch_busy[c] = tm + tdma
        emit(tm + tdma, _CL_XFER, o)
        if phases is not None:
            phases.append((o, "xfer", c, tm, tm + tdma))

    def request_transfer(o, tm):
        c = op_ch[o]
        if ch_cur[c] < 0:
            start_transfer(c, o, tm)
        else:
            ch_q[c].append(o)

    # ---- die: grant / release ------------------------------------------
    def start_sense(o, tm):
        d = op_die[o]
        die_sense[d] += o_tr[o]
        emit(tm + o_tr[o], _CL_SENSE, o)
        if phases is not None:
            phases.append((o, "sense", d, tm, tm + o_tr[o]))

    def grant_die(o, tm):
        d = op_die[o]
        die_cur[d] = o
        die_busy[d] = _INF
        o_held[o] = tm
        if op_read[o]:
            if not o_serial[o]:
                o_left[o] = op_a[o] - 1
            start_sense(o, tm)
        else:
            emit(tm + op_dur[o], _CL_REL, o)
            if phases is not None:
                kind = "erase" if op_erase[o] else "prog"
                phases.append((o, kind, d, tm, tm + op_dur[o]))

    def admit_to_die(o, tm):
        d = op_die[o]
        if die_cur[d] < 0 and not dieq[d]:
            grant_die(o, tm)
        else:
            dieq[d].append(o)

    def release_die(o, tm):
        d = op_die[o]
        die_tot[d] += tm - o_held[o]
        die_cur[d] = -1
        die_busy[d] = tm
        if dieq[d]:
            grant_die(dieq[d].pop_next(), tm)

    # ---- request completion bookkeeping --------------------------------
    def complete_page(o, fin):
        r = op_rid[o]
        if r < 0 or o_defer[o]:
            return
        if fin > req_done[r]:
            req_done[r] = fin
        req_pend[r] -= 1
        if req_pend[r] == 0:
            emit(req_done[r], _CL_RDONE, r)

    def finish_at_host(r, tm):
        """Complete a request host-side (cache absorb / full cache hit)."""
        req_done[r] = tm + hit_us
        emit(tm + hit_us, _CL_RDONE, r)

    # ---- read state machines (mirror the open-loop timing exactly) -----
    def _copy(o, tm):
        """Pipelined: sense data lands in the cache register at ``tm`` —
        issue its DMA and (CACHE READ) start the next sense under it."""
        o_regfree[o] = False
        request_transfer(o, tm)
        if o_left[o] > 0:
            o_left[o] -= 1
            start_sense(o, tm)            # overlaps the transfer: the PR² win
        elif o_xa[o] > 0:
            o_tail[o] = _TAIL_XA          # recovery ladder; die stays held
        else:
            o_tail[o] = _TAIL_FIN
            if op_a[o] > 1:
                # The speculatively-started next sense occupies the die
                # until tm + tr even though its data is never needed.
                die_sense[op_die[o]] += o_tr[o]
                if phases is not None:
                    phases.append((o, "sense", op_die[o], tm, tm + o_tr[o]))
                emit(tm + o_tr[o], _CL_REL, o)
            else:
                release_die(o, tm)

    def _pipelined_xfer(o, tm):
        """Pipelined read transfer drained at ``tm``."""
        o_regfree[o] = True
        tail = o_tail[o]
        if tail == _TAIL_XA:
            # Decode of the final sampled attempt failed (known at
            # tm + tecc): serial full-strength re-reads, die held.
            o_tail[o] = _TAIL_NONE
            o_serial[o] = True
            o_rem[o] = o_xa[o]
            o_xa[o] = 0
            o_tr[o] = op_xtr[o]
            start_sense(o, tm + tecc)
        elif tail == _TAIL_FIN:
            complete_page(o, tm + tecc)   # decode tail is off-die
        elif o_sense_t[o] >= 0.0:
            o_sense_t[o] = -1.0
            _copy(o, tm)                  # a sense was waiting on the reg

    def _serial_xfer(o, tm):
        """Serial read transfer drained at ``tm`` -> decode at tm + tecc."""
        rem = o_rem[o] - 1
        if rem > 0:
            o_rem[o] = rem
            start_sense(o, tm + tecc)     # decode failed: next table entry
        elif o_xa[o] > 0:
            o_rem[o] = o_xa[o]            # recovery: full-strength ladder
            o_xa[o] = 0
            o_tr[o] = op_xtr[o]
            start_sense(o, tm + tecc)
        else:
            complete_page(o, tm + tecc)
            release_die(o, tm)            # die freed at last transfer end

    # ---- write-back cache ----------------------------------------------
    blocked_group = -1            # group waiting on cache capacity

    def host_page_ops(g):
        r = grp_rid[g]
        return [o for o in range(grp_lo[g], grp_hi[g])
                if op_rid[o] == r and not op_read[o] and not op_erase[o]]

    def issue_entry(entry, tm):
        """Issue one flushed cache entry's device ops (low priority)."""
        g = entry.payload
        pages = iter(entry.versions)
        r = grp_rid[g]
        for o in range(grp_lo[g], grp_hi[g]):
            if op_rid[o] == r and not op_read[o] and not op_erase[o]:
                o_fver[o] = next(pages)
            issue_op(o, tm)

    def maybe_flush(tm):
        if cache.need_flush():
            while not cache.flushed_enough():
                entry = cache.pop_entry()
                if entry is None:
                    break
                issue_entry(entry, tm)

    def drain_cache(tm):
        for entry in cache.drain():
            issue_entry(entry, tm)

    # ---- admission ------------------------------------------------------
    def issue_op(o, tm):
        nonlocal attempts_issued, read_pages_issued
        if op_read[o]:
            if op_rid[o] >= 0 and not o_defer[o]:
                attempts_issued += op_a[o]
                read_pages_issued += 1
            admit_to_die(o, tm)
        elif op_erase[o]:
            admit_to_die(o, tm)
        else:
            request_transfer(o, tm)   # program: DMA first, then the die

    def admit_group(g, tm):
        """Issue (or absorb) group ``g`` now.  False = blocked on cache."""
        nonlocal blocked_group, stalled_writes, full_hit_reads, inflight
        nonlocal max_inflight
        r = grp_rid[g]
        if cache is not None and not req_is_read[r]:
            pages = host_page_ops(g)
            if cache.fits(len(pages)):
                if not cache.can_absorb(len(pages)):
                    # Backpressure: hold the slot, force the oldest dirty
                    # entries out, retry as their programs land.
                    stalled_writes += 1
                    blocked_group = g
                    while (cache.dirty_pages >
                           cache.capacity - len(pages)):
                        entry = cache.pop_entry()
                        if entry is None:
                            break
                        issue_entry(entry, tm)
                    return False
                req_admit[r] = tm
                inflight += 1
                if inflight > max_inflight:
                    max_inflight = inflight
                entry = cache.absorb([op_lpn[o] for o in pages], payload=g)
                for o in range(grp_lo[g], grp_hi[g]):
                    o_defer[o] = True
                finish_at_host(r, tm)
                maybe_flush(tm)
                return True
            # Oversized write: fall through to write-through.
        req_admit[r] = tm
        inflight += 1
        if inflight > max_inflight:
            max_inflight = inflight
        for o in range(grp_lo[g], grp_hi[g]):
            if (cache is not None and op_read[o] and op_rid[o] == r
                    and op_lpn is not None and op_lpn[o] >= 0
                    and cache.contains(op_lpn[o])):
                cache.note_hit()
                cache.touch(op_lpn[o])
                continue
            if op_rid[o] == r:
                req_pend[r] += 1
            issue_op(o, tm)
        if req_pend[r] == 0:
            # Every page hit the cache (reads) — no device traffic.
            full_hit_reads += 1
            finish_at_host(r, tm)
        return True

    # NCQ slots: reserve a slot per queued request up front (SNIPPETS
    # FTL-SIM discipline — an arrival is *scheduled* the moment a slot
    # frees, firing at max(trace arrival, now)); admission additionally
    # waits for stream order so the prepass/fault mappings stay valid.
    free_slots = ncq_depth
    next_sched = 0                # next group to receive a slot
    adm_head = 0                  # next group to admit (stream order)
    arrived = [False] * n_groups

    def schedule_arrivals(tm):
        nonlocal free_slots, next_sched
        while free_slots > 0 and next_sched < n_groups:
            g = next_sched
            next_sched += 1
            free_slots -= 1
            ta = req_arrival[grp_rid[g]]
            emit(ta if ta > tm else tm, _CL_ARRIVE, g)

    def pump_admissions(tm):
        nonlocal adm_head
        while (adm_head < n_groups and arrived[adm_head]
               and blocked_group < 0):
            if not admit_group(adm_head, tm):
                break
            adm_head += 1
        if cache is not None and adm_head == n_groups and blocked_group < 0:
            drain_cache(tm)

    schedule_arrivals(0.0)

    # ---- the loop -------------------------------------------------------
    while heap:
        tm, _, ev, idx = heapq.heappop(heap)
        n_events += 1

        if ev == _CL_ARRIVE:
            arrived[idx] = True
            pump_admissions(tm)

        elif ev == _CL_SENSE:
            o = idx
            if o_serial[o]:
                request_transfer(o, tm)     # die stays held through DMA
            elif o_regfree[o]:
                _copy(o, tm)
            else:
                o_sense_t[o] = tm           # wait for the register

        elif ev == _CL_XFER:
            o = idx
            c = op_ch[o]
            q = ch_q[c]
            h = ch_head[c]
            if h < len(q):                  # grant the next transfer
                nxt = q[h]
                ch_head[c] = h + 1
                if ch_head[c] > 64 and ch_head[c] * 2 > len(q):
                    del q[:ch_head[c]]
                    ch_head[c] = 0
                start_transfer(c, nxt, tm)
            else:
                ch_cur[c] = -1
            if op_read[o]:
                if o_serial[o]:
                    _serial_xfer(o, tm)
                else:
                    _pipelined_xfer(o, tm)
            else:
                admit_to_die(o, tm)         # program transfer landed

        elif ev == _CL_REL:
            o = idx
            release_die(o, tm)
            if not op_read[o]:
                if o_defer[o] and not op_erase[o] and op_rid[o] >= 0:
                    # A flushed cache page became durable: free its slot,
                    # retry a blocked write, keep draining if done.
                    cache.page_durable(op_lpn[o], o_fver[o])
                    if blocked_group >= 0:
                        g = blocked_group
                        need = len(host_page_ops(g))
                        if cache.can_absorb(need):
                            blocked_group = -1
                            pump_admissions(tm)
                    elif adm_head == n_groups:
                        pass    # end-of-trace drain already issued
                else:
                    complete_page(o, tm)

        else:                               # _CL_RDONE
            inflight -= 1
            free_slots += 1
            schedule_arrivals(tm)

        if validate:
            if inflight > ncq_depth:
                raise AssertionError(
                    f"NCQ violated: {inflight} > depth {ncq_depth}"
                )
            # A granted die's busy-until is _INF, a free one's its
            # release time: the open loop's check reads the same state.
            _check_work_conserving(die_busy, dieq)

    if adm_head != n_groups or blocked_group >= 0:
        raise AssertionError("closed loop finished with unadmitted groups")
    if cache is not None and cache.pending_pages:
        raise AssertionError("closed loop finished with undrained cache")

    return ClosedLoopResult(
        req_done=req_done,
        req_admit=req_admit,
        die_tot=die_tot,
        die_sense_tot=die_sense,
        ch_tot=ch_tot,
        die_busy=die_busy,
        ch_busy=ch_busy,
        n_events=n_events,
        attempts_issued=attempts_issued,
        read_pages_issued=read_pages_issued,
        max_inflight=max_inflight,
        full_hit_reads=full_hit_reads,
        hit_pages=cache.hit_pages if cache is not None else 0,
        absorbed_writes=cache.absorbed_writes if cache is not None else 0,
        flush_pages=cache.flush_pages if cache is not None else 0,
        stalled_writes=stalled_writes,
        phases=phases,
    )


def _check_work_conserving(die_busy, dieq) -> None:
    """Raise when any die sits idle while its queue holds a runnable op.

    Stalled writes are parked *outside* the die queues (gc_online), so
    everything queued here is runnable by construction.
    """
    for d, q in enumerate(dieq):
        if q and die_busy[d] != _INF:
            raise AssertionError(
                f"work conservation violated: die {d} idle "
                f"(free since t={die_busy[d]:.3f}) with {len(q)} queued ops"
            )
