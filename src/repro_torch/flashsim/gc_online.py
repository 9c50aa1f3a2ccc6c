"""Online garbage collection: completion-time watermark triggering.

The reference package's online GC controller, kept here as the port's own
copy (numpy and the standard library): the same triggers, victims and
per-die substreams, so an online run of the port equals the reference's
given the same characterization tables.  Its per-op hooks read host
memos only (``SSDSim``'s attempt CDFs and AR² scales, each worn bin
characterized once on the run's device), so hundreds of thousands of
hook calls never synchronize with the card.

The prepass FTL (:func:`repro_torch.flashsim.ftl.build_ftl_schedule`) decides
*when* GC runs by walking the trace in write-admission order: a host
write admitted at ``t`` schedules its GC at ``t``, regardless of when the
write actually reaches its die.  That is exact for the *mapping* but
approximates the trigger instant — under bursts the pre-pass front-loads
GC storms that real firmware would spread across the burst's drain time.

This module replaces the trigger with device dynamics.  An
:class:`OnlineGC` controller rides inside the event core and advances the
FTL at *simulated* instants:

  * **reads** map (with lazy pre-fill) when admitted, resolving per-block
    wear for attempt sampling and the per-block AR² tR scale;
  * **writes** allocate their physical page when the die actually takes
    the program — the free-block pool is consumed at simulated
    program-start times, not admission times;
  * when a die's projected free-block pool — free blocks plus erases
    already in flight — falls to the **watermark**
    (``GCConfig.watermark_blocks``, default ``gc_threshold_blocks``), the
    controller collects greedy victims *now*: copy-back page-ops and the
    erase are injected into the event core at the current sim time and
    contend through the die scheduler like any other op;
  * an erased block re-enters the free pool only when its **erase
    completes** on the die — reclaim takes simulated time, which is the
    whole point;
  * a write that finds no free page **stalls** (host write throttling):
    it is parked off-queue, its die is released to the GC traffic ahead
    of it, and it re-dispatches when an erase completes.  A device whose
    stalls can never drain raises at end of run rather than reporting
    truncated statistics.

Mapping state machine and victim policy are shared with the prepass
(:class:`repro_torch.flashsim.ftl.PageMapFTL` with ``auto_gc=False`` +
``defer_free=True``); only the trigger and free-pool dynamics differ.

RNG discipline: shard-invariant per-die substreams
--------------------------------------------------
Attempt counts for online-mode reads (host reads at admission, GC reads
at injection) are drawn from **per-die RNG substreams** seeded as
``(run seed, die)``, not from one run-global stream.  A die's draw
sequence then depends only on that die's own event order — which is
identical whether the event core runs one monolithic loop or one loop
per channel (:mod:`repro_torch.flashsim.engine` ``shard=True``) — so sharded
and monolithic online runs are bit-identical.  (There is no bit-parity
contract with the prepass stream; online mode has always sampled on its
own schedule.)

Cross-shard coupling contract
-----------------------------
The only state online GC touches that *could* couple shards is FTL
allocation and host-write stalls — and both are die-partitioned by
construction (see the "Die-partitioned state" section of
:mod:`repro_torch.flashsim.ftl`): free pools, frontiers, sealed sets, and the
stall lists are all per-die, and a die is owned by exactly one channel
shard.  The engine makes the contract explicit through
:meth:`OnlineGC.set_shard_scope`: while a shard's loop runs, the controller
fails fast if any allocation, stall, injection, or erase completion
touches a die outside the shard.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.flashsim.config import SSDConfig
from repro_torch.flashsim.ftl import OP_ERASE, OP_GC_READ, PageMapFTL


class OnlineGC:
    """Event-core controller for completion-time-triggered garbage collection.

    Engine-facing protocol (called by :func:`repro_torch.flashsim.engine.
    run_event_core`):

    ``bind(bufs)``                 attach the run's growing op buffers;
    ``on_read_admit(op, tm)``      map a host read; returns (attempts, tR);
    ``on_program_start(op, tm)``   map a host write at program start;
                                   False = no free page (caller stalls it);
    ``stall(op)``                  park a write that could not start;
    ``on_erase_complete(op, tm)``  return the erased block to the pool;
    ``take_injected()``            drain newly-emitted GC ops to admit;
    ``take_unstalled()``           drain writes made runnable by an erase;
    ``set_shard_scope(dies)``      restrict to one shard's dies (None
                                   clears; sharded engine runs only);
    ``assert_drained()``           end-of-run wedge check.
    """

    def __init__(self, cfg: SSDConfig, expansion, sim, faults=None):
        gc = cfg.gc
        self.cfg = cfg
        self.sim = sim
        #: Optional :class:`repro_torch.flashsim.faults.FaultModel`.
        #: Online mode draws the recovery ladder at the simulated admission instants
        #: and runs *real* FTL bad-block retirement; draws stay die-local
        #: (the fault model's streams are per-die), preserving the shard
        #: contract.
        self.faults = faults
        self.ftl = PageMapFTL(cfg, lpns=expansion.page_id,
                              auto_gc=False, defer_free=True)
        self.watermark = (
            gc.watermark_blocks if gc.watermark_blocks is not None
            else gc.gc_threshold_blocks
        )
        self.tprog = cfg.timing.tprog_us
        self.terase = gc.t_erase_us
        self.n_dies = cfg.n_dies
        self.n_channels = cfg.n_channels

        self._lpn = expansion.page_id.tolist()
        self._ptype = expansion.ptype.tolist()

        # Per-die attempt-sampling substreams, seeded (run seed, die):
        # a die's draw order is a die-local property, so sharded and
        # monolithic loops consume identical streams (module docstring).
        self._rngs = [
            np.random.default_rng((sim.seed, d)) for d in range(self.n_dies)
        ]
        self._scope: Optional[frozenset] = None

        self.inflight_erases = [0] * self.n_dies
        self._stalled: List[List[int]] = [[] for _ in range(self.n_dies)]
        self._erase_block: Dict[int, Tuple[int, int]] = {}
        self.injected: List[int] = []
        self.unstalled: List[int] = []
        self.write_stalls = 0
        self.prefill_skips = 0
        self.host_reads = 0
        self.bufs = None

    # -- engine protocol -----------------------------------------------------

    def bind(self, bufs) -> None:
        self.bufs = bufs

    def on_read_admit(self, op: int, tm: float) -> Tuple[int, float]:
        """Map a host read at admission; lazy pre-fill may consume pages
        (and thus cross the watermark).  Returns the per-block-resolved
        (attempt count, per-attempt tR).

        Unlike writes, reads can never stall on the free pool: when an
        unmapped lpn arrives while the die has no page to pre-fill into
        (reclaim in flight, pool momentarily dry), the read senses an
        unwritten page at zero wear without consuming capacity —
        counted in ``prefill_skips``.
        """
        lpn = self._lpn[op]
        ftl = self.ftl
        d = lpn % self.n_dies
        self.host_reads += 1
        if lpn in ftl.l2p or ftl.can_alloc(d):
            wear = ftl.host_read(lpn)
            self._check_watermark(d)
        else:
            wear = 0.0
            self.prefill_skips += 1
        pt = self._ptype[op]
        a = self.sim._draw_attempts(pt, wear, rng=self._rngs[d])
        tr = self.sim._tr_for(pt, wear)
        fm = self.faults
        if fm is not None:
            mult = fm.die_mult(d)
            tr *= mult
            extra, rebuild, affected = fm.read_ladder(d, wear)
            b = self.bufs
            rid = b.rid[op]
            if affected:
                fm.outcome.affected_rids.add(rid)
            if extra:
                # Failed decodes re-read at full strength: the engine
                # appends `extra` serial nominal-tR attempts after the
                # op's last sampled attempt (die held throughout).
                b.xa[op] = extra
                b.xtr[op] = float(self.sim._tr_base[pt]) * mult
            if rebuild:
                self._parity_rebuild(d, pt, wear, rid, lpn)
        return (a, tr)

    def _parity_rebuild(self, d: int, pt: int, wear: float, rid: int,
                        lpn: int) -> None:
        """Escalation exhausted: rebuild the page from its superpage
        stripe peers and retire the bad block.

        Peer reads are injected as *real* page-ops on the other dies of
        the channel, carrying the original request id (the request
        completes only when the slowest peer's data is in — ``req_done``
        is a max) and host-read priority under prioritized schedulers.
        Retirement relocates the block's valid pages through the FTL's
        GC frontier; the relocation traffic contends like GC copy-back.
        """
        fm = self.faults
        sim = self.sim
        peers = fm.rebuild_peers(d)
        fm.rebuild_outcome(d, len(peers))
        for dd in peers:
            # Peer draws come from the *trigger* die's fault substream —
            # die-local order, so sharding never reorders them (peers
            # share the trigger's channel, hence its shard).
            pa = sim._draw_attempts(pt, 0.0, rng=fm.rngs[d])
            ptr = sim._tr_for(pt, 0.0) * fm.die_mult(dd)
            self._inject_host_read(dd, rid, pa, ptr)
        if fm.fc.retire_blocks:
            ftl = self.ftl
            ppn = ftl.l2p.get(lpn, -1)
            if ppn >= 0 and ftl.retire_block(d, ppn // ftl.ppb):
                fm.outcome.retired_blocks += 1
                for kind, gd, pt2, w2, blk2 in ftl.drain_events():
                    self._inject(kind, gd, pt2, w2, blk2)
                self._check_watermark(d)

    def on_program_start(self, op: int, tm: float) -> bool:
        """Allocate the write's physical page at simulated program start.

        Returns False when the die has no free page — the caller parks
        the op via :meth:`stall` and it re-dispatches after an erase.
        """
        d = self.bufs.die[op]
        if self._scope is not None and d not in self._scope:
            raise AssertionError(
                f"online GC shard-scope violation: program start on die "
                f"{d} outside the active shard"
            )
        if not self.ftl.can_alloc(d):
            self.write_stalls += 1
            return False
        self.ftl.host_write(self._lpn[op])
        self._check_watermark(d)
        fm = self.faults
        if fm is not None:
            # Reached exactly once per op (stalled retries return False
            # above): apply fail-slow stretch and draw a program failure
            # (+tPROG for the internal reprogram).
            b = self.bufs
            mult = fm.die_mult(d)
            if mult != 1.0:
                b.dur[op] = b.dur[op] * mult
            if fm.draw_program_fail(d):
                fm.outcome.program_fails += 1
                fm.outcome.affected_rids.add(b.rid[op])
                b.dur[op] += self.tprog * mult
        return True

    def stall(self, op: int) -> None:
        d = self.bufs.die[op]
        if self._scope is not None and d not in self._scope:
            raise AssertionError(
                f"online GC shard-scope violation: write stall on die "
                f"{d} outside the active shard"
            )
        self._stalled[d].append(op)

    def on_erase_complete(self, op: int, tm: float) -> None:
        d, blk = self._erase_block.pop(op)
        if self._scope is not None and d not in self._scope:
            raise AssertionError(
                f"online GC shard-scope violation: erase completion on "
                f"die {d} outside the active shard"
            )
        fm = self.faults
        apply_fail = False
        if fm is not None and fm.draw_erase_fail(d):
            # The draw is always consumed (stream position is config-
            # independent), but the failure is suppressed when this erase
            # is the only reclaim a dry die's stalled writes wait on —
            # losing it would wedge the device.  The guard reads only
            # die-local state, so it is shard-invariant.
            if self.ftl.free[d] or not self._stalled[d]:
                apply_fail = True
        if apply_fail:
            fm.outcome.erase_fails += 1
            fm.outcome.retired_blocks += 1
            self.ftl.retire_erase_failed(d, blk)
        else:
            self.ftl.erase_complete(d, blk)
        self.inflight_erases[d] -= 1
        stalled = self._stalled[d]
        if stalled:
            self.unstalled.extend(stalled)
            stalled.clear()

    def take_injected(self) -> List[int]:
        out = self.injected
        self.injected = []
        return out

    def take_unstalled(self) -> List[int]:
        out = self.unstalled
        self.unstalled = []
        return out

    def set_shard_scope(self, dies) -> None:
        """Restrict the controller to one shard's dies (engine sharding).

        While a scope is set, any FTL allocation, write stall, GC
        injection, or erase completion on a die outside it raises — the
        fail-fast form of the cross-shard coupling contract (module
        docstring).  ``None`` clears the scope (monolithic runs never
        set one).
        """
        self._scope = None if dies is None else frozenset(dies)

    def assert_drained(self) -> None:
        parked = sum(len(s) for s in self._stalled)
        if parked or any(self.inflight_erases) or self.injected:
            raise RuntimeError(
                f"online GC wedged at end of run: {parked} stalled writes, "
                f"{sum(self.inflight_erases)} erases still in flight "
                f"(device capacity exhausted? raise GCConfig.blocks_per_die "
                f"or op_ratio)"
            )

    # -- internals -----------------------------------------------------------

    def _check_watermark(self, d: int) -> None:
        """Collect victims while the projected free pool sits at/below the
        watermark.  Projected = free now + erases already in flight — each
        collection queues one erase, so the loop converges without waiting
        for reclaim."""
        ftl = self.ftl
        wm = self.watermark
        while len(ftl.free[d]) + self.inflight_erases[d] <= wm:
            if not ftl._collect(d):
                break
            for kind, gd, pt, wear, blk in ftl.drain_events():
                self._inject(kind, gd, pt, wear, blk)

    def _inject(self, kind: int, d: int, pt: int, wear: float,
                blk: int) -> None:
        """Append one GC page-op to the run's op buffers (admitted by the
        engine at the current sim time)."""
        b = self.bufs
        sim = self.sim
        if self._scope is not None and d not in self._scope:
            raise AssertionError(
                f"online GC shard-scope violation: GC op injected on die "
                f"{d} outside the active shard"
            )
        is_read = kind == OP_GC_READ
        is_erase = kind == OP_ERASE
        fm = self.faults
        mult = 1.0 if fm is None else fm.die_mult(d)
        if is_read:
            a = sim._draw_attempts(pt, wear, rng=self._rngs[d])
            tr = sim._tr_for(pt, wear) * mult
            dur = 0.0
        else:
            a, tr = 1, 0.0
            dur = (self.terase if is_erase else self.tprog) * mult
        b.rid.append(-1)
        b.die.append(d)
        b.ch.append(d % self.n_channels)
        b.read.append(is_read)
        b.erase.append(is_erase)
        b.dur.append(dur)
        b.a.append(a)
        b.tr.append(tr)
        b.rem.append(a)
        b.held.append(0.0)
        b.end.append(0.0)
        b.resid.append(0.0)
        b.susp.append(False)
        if b.host_read is not None:
            b.host_read.append(False)
        if b.xa is not None:
            b.xa.append(0)
            b.xtr.append(0.0)
        o = len(b.rid) - 1
        if is_erase:
            self._erase_block[o] = (d, blk)
            self.inflight_erases[d] += 1
        self.injected.append(o)

    def _inject_host_read(self, d: int, rid: int, a: int, tr: float) -> None:
        """Inject a parity-rebuild stripe-peer read: a real page-op on
        ``d`` carrying the *original* request id (and host-read priority
        under prioritized schedulers), admitted at the current sim time."""
        b = self.bufs
        if self._scope is not None and d not in self._scope:
            raise AssertionError(
                f"online GC shard-scope violation: rebuild read injected "
                f"on die {d} outside the active shard"
            )
        b.rid.append(rid)
        b.die.append(d)
        b.ch.append(d % self.n_channels)
        b.read.append(True)
        b.erase.append(False)
        b.dur.append(0.0)
        b.a.append(a)
        b.tr.append(tr)
        b.rem.append(a)
        b.held.append(0.0)
        b.end.append(0.0)
        b.resid.append(0.0)
        b.susp.append(False)
        if b.host_read is not None:
            b.host_read.append(True)
        if b.xa is not None:
            b.xa.append(0)
            b.xtr.append(0.0)
        self.injected.append(len(b.rid) - 1)

    def stats(self):
        """FTL summary for SimStats (WA, GC traffic, wear)."""
        return self.ftl.stats(host_reads=self.host_reads)
