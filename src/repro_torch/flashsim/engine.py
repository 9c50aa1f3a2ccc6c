"""Array event-core: the flashsim discrete-event interpreter loop.

This module is the bottom layer of the simulator's layered architecture:

  * :mod:`repro_torch.flashsim.ssd` (run orchestration: attempt sampling, stats)
  * :mod:`repro_torch.flashsim.sched` (die-queue policies: fcfs / host_prio / preempt)
  * **this module** — the heap, the busy-until channel collapse, and the
    op-kind dispatch.

It is the host interpreter behind ``engine="array"`` and the open-loop
counterpart of the reference's; the closed-loop frontend, online GC and
fault-recovery continuations are not part of this port yet (see
ROADMAP.md), so this loop carries none of their hooks.

Heap records are 2-tuples ``(time, seq << 40 | op_id << 2 | opcode)``: the
packed integer both tie-breaks FIFO (``seq`` in the high bits — push-order
discipline) and carries the whole event, so an event costs one tuple — no
closures, no argument unpacking.  Channels are single-server FCFS with
constant-duration transfers always requested at the current sim time, so
channel state collapses to a cumulative busy-until scalar (a transfer's
grant and completion times are exact at issue) — one heap event per read
attempt instead of two.  Each handler schedules at most one successor
event on its own behalf, so pop+push collapses into a ``heapreplace``
sift.

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
owning that channel's dies, queues and busy-until scalar — and then
combining the per-shard
completion streams with a thin deterministic merge
(:func:`merge_shard_results`): ``req_done`` is an elementwise max (a
request's pages may span channels), die/channel vectors take each
shard's owned entries, counters add.

The sharded run is **bit-identical** to the monolithic run: within one
shard, events are pushed in the same relative order as the monolithic
loop's events restricted to that channel (push-order tie-breaking is a
per-shard property), and cross-shard state is limited to the commutative
``req_done`` max and additive counters.  The shard loops run
sequentially in-process.
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

    The entries are the admission stream (pre-sorted by arrival time).
    ``host_read`` is built by the engine when the scheduler classifies
    ops (None under fcfs).  The batched engine takes numpy columns in
    the same fields.
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

    if not shard or cfg.n_channels == 1:
        return _run_shard(cfg, pipelined, policy, bufs, n_requests,
                          host_read, validate, None)

    # Per-channel decomposition: partition the admission stream by the
    # static die -> channel stripe.
    n_ch = cfg.n_channels
    shard_ops: List[List[int]] = [[] for _ in range(n_ch)]
    for i, c in enumerate(bufs.ch[:P]):
        shard_ops[c].append(i)
    results = []
    for c in range(n_ch):
        results.append(
            _run_shard(cfg, pipelined, policy, bufs, n_requests,
                       host_read, validate, shard_ops[c])
        )
    return merge_shard_results(cfg, results)


def _run_shard(
    cfg,
    pipelined: bool,
    policy: SchedulerPolicy,
    bufs: OpBuffers,
    n_requests: int,
    host_read: Optional[List[bool]],
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

    read_start_ev = _EV_COPY if pipelined else _EV_NEXT

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
            dq = dieq[d]
            op2 = dq.pop_next() if dq else -1
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
      * event/suspension counters — sums.

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
    n_events = gc_susp = 0
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
    return EngineResult(
        req_done=req_done,
        die_tot=die_tot,
        ch_tot=ch_tot,
        die_busy=die_busy,
        ch_busy=ch_busy,
        n_events=n_events,
        gc_suspensions=gc_susp,
    )


def _check_work_conserving(die_busy, dieq) -> None:
    """Raise when any die sits idle while its queue holds a runnable op."""
    for d, q in enumerate(dieq):
        if q and die_busy[d] != _INF:
            raise AssertionError(
                f"work conservation violated: die {d} idle "
                f"(free since t={die_busy[d]:.3f}) with {len(q)} queued ops"
            )
