"""Reference (seed) closure-based DES engine, kept for validation.

The original pure-Python engine of the reference package, ported
unchanged: per-page closures scheduled on a ``(time, seq, fn, args)``
tuple heap, with attempt counts sampled per request at admit time.  The
production engines (:mod:`repro_torch.flashsim.engine` and the batched
shard core) replaced it; it stays as the seed the array engine is held
against.  Select it with ``simulate(..., engine="reference")``.

Like every engine of the port it simulates on the host; only the
characterization it samples from runs on the simulator's ``device``.

Parity notes
------------
This engine predates the FTL/GC subsystem and the scheduler layer and
models the original *in-place-program* device under strict FCFS die
queues: host reads (serial and PR²-pipelined) and host writes with
``SSDConfig.gc.enabled = False``.  Other configurations raise
``NotImplementedError`` rather than silently simulate a different
device.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch.flashsim.ssd import (PAGE_TYPE_ORDER, SSDSim, SimStats,
                                     TraceExpansion)
from repro_torch.flashsim.workloads import RequestTrace


class _Resource:
    """Single-server FCFS resource (a die or a channel)."""

    __slots__ = ("busy_until", "queue", "busy_total")

    def __init__(self):
        self.busy_until = 0.0
        self.queue: deque = deque()
        self.busy_total = 0.0


class SSDSimRef(SSDSim):
    """The seed closure engine behind the SSDSim policy/CDF setup.

    Subclasses :class:`SSDSim` so the policy resolution, AR² scale lookup,
    and attempt-CDF construction are literally shared with the array
    engine — only the event core differs, which is exactly the surface the
    equivalence tests compare.
    """

    # -- discrete-event engine -------------------------------------------------

    def run(
        self,
        trace: RequestTrace,
        expansion: Optional[TraceExpansion] = None,  # unused: closure engine
        validate: bool = False,                      # engine-core flag: n/a
    ) -> SimStats:
        if self.cfg.gc.enabled:
            raise NotImplementedError(
                "the reference (seed) engine predates the FTL/GC subsystem; "
                "run FTL configurations with engine='array' "
                "(see the parity notes in repro_torch/flashsim/engine_ref.py)"
            )
        if self.cfg.scheduler != "fcfs":
            raise NotImplementedError(
                "the reference (seed) engine predates the scheduler layer "
                "and implements strict FCFS die queues only; run "
                f"scheduler={self.cfg.scheduler!r} with engine='array'"
            )
        cfg, t = self.cfg, self.cfg.timing
        tdma, tecc, tprog = t.tdma_us, t.tecc_us, t.tprog_us
        pipelined = self.policy.pipelined
        tr_by_type = (
            np.array([t.tr_us[pt] for pt in PAGE_TYPE_ORDER]) * self.tr_scale
        )

        dies = [_Resource() for _ in range(cfg.n_dies)]
        chans = [_Resource() for _ in range(cfg.n_channels)]

        heap: List = []
        seq = 0

        def push(time_, fn, *args):
            nonlocal seq
            heapq.heappush(heap, (time_, seq, fn, args))
            seq += 1

        n = len(trace.arrival_us)
        req_remaining = np.zeros(n, np.int64)
        req_done_at = np.zeros(n)
        total_attempts = 0
        total_read_pages = 0

        # ------- resource helpers ------------------------------------------

        def die_acquire(d: int, now: float, fn, *args):
            res = dies[d]
            if now >= res.busy_until and not res.queue:
                res.busy_until = np.inf  # held until explicit release
                fn(now, *args)
            else:
                res.queue.append((fn, args))

        def die_release(d: int, now: float, held_since: float):
            res = dies[d]
            res.busy_total += now - held_since
            res.busy_until = now
            if res.queue:
                fn, args = res.queue.popleft()
                res.busy_until = np.inf
                fn(now, *args)

        def chan_request(ch: int, now: float, dur: float, fn):
            """FCFS channel: start the transfer asap; fn fires at completion.

            The channel chains its own job-done events, so callbacks never
            manage channel state.
            """
            res = chans[ch]
            if res.busy_until <= now and not res.queue:
                res.busy_until = now + dur
                res.busy_total += dur
                push(now + dur, _chan_job_done, ch, fn)
            else:
                res.queue.append((dur, fn))

        def _chan_job_done(tm: float, ch: int, fn):
            res = chans[ch]
            if res.queue:
                dur, fn2 = res.queue.popleft()
                res.busy_until = tm + dur
                res.busy_total += dur
                push(tm + dur, _chan_job_done, ch, fn2)
            fn(tm)

        # ------- read page-op state machines --------------------------------

        def page_complete(now: float, rid: int):
            req_remaining[rid] -= 1
            req_done_at[rid] = max(req_done_at[rid], now)

        def start_read_serial(now: float, rid: int, d: int, ch: int,
                              a: int, tr: float):
            held_since = now
            state = {"i": 0}

            def xfer_done(tm):
                ecc_done = tm + tecc
                state["i"] += 1
                if state["i"] >= a:
                    die_release(d, tm, held_since)       # die freed at last xfer
                    page_complete(ecc_done, rid)
                else:
                    # Decode failed; firmware re-senses with the next entry.
                    push(ecc_done + tr, sense_fire)

            def sense_fire(tm):
                chan_request(ch, tm, tdma, xfer_done)

            push(now + tr, sense_fire)

        def start_read_pipelined(now: float, rid: int, d: int, ch: int,
                                 a: int, tr: float):
            held_since = now
            sense_done_t = [None] * a       # per-attempt milestones
            xfer_done_t = [None] * a
            copied = [False] * a

            def try_copy(i: int, tm: float):
                """copy_i fires when sense i is done and cache reg is free."""
                if copied[i] or sense_done_t[i] is None:
                    return
                if i > 0 and xfer_done_t[i - 1] is None:
                    return
                tc = max(sense_done_t[i], xfer_done_t[i - 1] if i else 0.0)
                copied[i] = True
                chan_request(ch, tc, tdma, lambda tm2: on_xfer(i, tm2))
                if i + 1 < a:
                    push(tc + tr, lambda tm2: on_sense(i + 1, tm2))
                else:
                    # Final attempt leaves the die: charge one speculative
                    # sense when the sequence actually retried.
                    spec = tr if a > 1 else 0.0
                    push(tc + spec, lambda tm2: die_release(d, tm2, held_since))

            def on_sense(i: int, tm: float):
                sense_done_t[i] = tm
                try_copy(i, tm)

            def on_xfer(i: int, tm: float):
                xfer_done_t[i] = tm
                if i + 1 < a:
                    try_copy(i + 1, tm)
                if i == a - 1:
                    page_complete(tm + tecc, rid)

            push(now + tr, lambda tm: on_sense(0, tm))

        # ------- write page-op ----------------------------------------------

        def start_write(now: float, rid: int, d: int, ch: int):
            def xfer_done(tm):
                die_acquire(d, tm, prog_start)

            def prog_start(tm):
                push(tm + tprog, lambda tm2: prog_done(tm2))
                state["held"] = tm

            def prog_done(tm):
                die_release(d, tm, state["held"])
                page_complete(tm, rid)

            state = {"held": now}
            chan_request(ch, now, tdma, xfer_done)

        # ------- request admission ------------------------------------------

        def admit(now: float, rid: int):
            pages = int(trace.n_pages[rid])
            first = int(trace.start_page[rid])
            req_remaining[rid] = pages
            page_ids = first + np.arange(pages)
            if trace.is_read[rid]:
                ptypes = (page_ids % 3).astype(np.int64)
                attempts = self._sample_attempts(ptypes)
                nonlocal_totals[0] += int(attempts.sum())
                nonlocal_totals[1] += pages
                for j in range(pages):
                    d = int(page_ids[j] % cfg.n_dies)
                    ch = cfg.channel_of(d)
                    a = int(attempts[j])
                    tr = float(tr_by_type[ptypes[j]])
                    starter = start_read_pipelined if pipelined else start_read_serial
                    die_acquire(d, now, starter, rid, d, ch, a, tr)
            else:
                for j in range(pages):
                    d = int(page_ids[j] % cfg.n_dies)
                    ch = cfg.channel_of(d)
                    start_write(now, rid, d, ch)

        nonlocal_totals = [0, 0]  # attempts, read pages

        for rid in range(n):
            push(float(trace.arrival_us[rid]), admit, rid)

        # ------- main loop ----------------------------------------------------

        n_events = 0
        while heap:
            tm, _, fn, args = heapq.heappop(heap)
            fn(tm, *args)
            n_events += 1
        self.events_processed = n_events

        total_attempts, total_read_pages = nonlocal_totals
        self.last_req_done_us = req_done_at
        response = req_done_at - trace.arrival_us + cfg.host_overhead_us
        read_resp = response[trace.is_read]
        span = float(req_done_at.max())
        return SimStats(
            mean_us=float(response.mean()),
            p50_us=float(np.percentile(response, 50)),
            p95_us=float(np.percentile(response, 95)),
            p99_us=float(np.percentile(response, 99)),
            read_mean_us=float(read_resp.mean()) if read_resp.size else 0.0,
            n_requests=n,
            mean_read_attempts=(
                total_attempts / total_read_pages if total_read_pages else 0.0
            ),
            die_util=sum(r.busy_total for r in dies) / (span * cfg.n_dies),
            channel_util=sum(r.busy_total for r in chans) / (span * cfg.n_channels),
            read_p99_us=(
                float(np.percentile(read_resp, 99)) if read_resp.size else 0.0
            ),
        )
