"""Page-mapping FTL with greedy garbage collection for the SSD simulator.

The reference package's FTL, kept here as the port's own copy (numpy and
the standard library only): the same mapping state, victim choice and
op schedule, so a prepass-GC run of the port equals the reference's.
The schedule it builds runs on either engine; on the card the batched
engine hands its GC reads (low priority), GC programs and erases to the
shard-core kernel with the host ops.

Before this layer existed the simulator programmed writes *in place*: a
host write occupied its die for tPROG and the flash never filled up, so
sustained-write workloads could not exercise read-retry behind GC-induced
die contention — exactly the regime where PR²'s pipelining and AR²'s
latency scaling matter most.  This module adds the missing subsystem:

  * a logical→physical **page map** (``l2p`` dict + ``p2l`` reverse array)
    with out-of-place programs: each host write allocates the next free
    page of its die's *active block* and invalidates the previous mapping;
  * configurable **over-provisioning** (:class:`~repro_torch.flashsim.config.
    GCConfig.op_ratio`): physical capacity is auto-sized from the trace's
    logical **footprint** — the count of *distinct* pages each die's
    stripe touches, never the raw LBA span — so utilization = 1 − OP at
    full pre-fill, or pinned explicitly with ``blocks_per_die``.  Real
    ingested traces scatter their footprint across volume-sized sparse
    spans; sizing stays footprint-proportional regardless, but run them
    through the dense-footprint remap (:class:`repro_torch.flashsim.workloads.
    DenseRemap`, the registry default for file sources) so the
    ``lpn % n_dies`` stripe also spreads evenly instead of following the
    trace's offset stride;
  * **greedy victim selection**: when a die's free-block count falls to
    the GC threshold, the sealed block with the fewest valid pages is
    compacted — its valid pages are read (``OP_GC_READ``), re-programmed
    into the die's dedicated GC frontier block (``OP_GC_PROG``), and the
    victim is erased (``OP_ERASE``);
  * **per-block P/E tracking**: every erase bumps the block's wear by
    ``pec_per_erase`` cycles; reads of relocated data resolve the device
    :class:`~repro_torch.flashsim.config.OperatingCondition` per block
    (``condition.with_wear``), so their retry-attempt distributions come
    from the characterization at the block's *effective* wear.

GC traffic is not simulated here — it is *scheduled* here.  The FTL walk
happens as a deterministic pre-pass over the trace in admission order
(:func:`build_ftl_schedule`), and the GC page-ops it emits are injected
into the array event-core's admission stream with the arrival time of the
host write that triggered them.  Inside the event loop they are ordinary
page-ops: GC reads run the same (possibly PR²-pipelined) read state
machine and sample retry attempts like host reads; GC programs transfer
over the channel and hold the die for tPROG; erases hold the die for
``t_erase_us``.  They therefore contend with host reads on the same die
FCFS queues and channel busy-until state — the contention the paper's
MQSim evaluation bakes in.

Die-partitioned state (the sharding contract)
---------------------------------------------
Every piece of FTL state that simulation-time code paths touch is
partitioned by die, keyed by the same static stripe the simulator uses
(``lpn % n_dies``):

  * allocation — free pools (``free[die]``), frontiers (``active`` /
    ``gc_active``), and sealed sets are per-die lists/sets; ``_alloc``,
    :meth:`PageMapFTL.can_alloc`, and :meth:`PageMapFTL.erase_complete`
    take the die explicitly and touch no other die's entries;
  * mapping — an lpn lives on exactly one die, and block-indexed arrays
    (``valid`` / ``wp`` / ``erases`` / ``p2l``) are partitioned into
    per-die block ranges (``[die*blocks_per_die, (die+1)*blocks_per_die)``);
  * victim selection / collection — :meth:`_collect` reads and writes
    only its die's structures.

Only *statistics* (page/invocation counters, ``gc_log``) are shared, and
those are additive.  This is what makes the per-channel sharded event
core (:mod:`repro_torch.flashsim.engine` ``shard=True``) exact: a channel
shard owns its dies' FTL slice outright, and the two cross-shard-looking
couplings — page allocation and host-write stalls — are in fact die-local
(the stall lists in :mod:`repro_torch.flashsim.gc_online` are per-die too).
Code extending the FTL must preserve this partitioning or the sharded
engine's bit-equality contract breaks; the online controller's
``set_shard_scope`` guard fails fast on violations.

Approximation notes (documented, deliberate):

  * GC is triggered by write *admission order*, not by simulated write
    completion times.  Mapping state is exact; only the trigger instant is
    approximated (a host write admitted at t schedules its GC at t).
  * Within one GC invocation the reads/programs/erase are all admitted at
    the trigger time and serialize through the die's FCFS queue rather
    than through explicit read→program→erase dependencies.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import deque
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.flashsim.config import DEFAULT_SSD, SSDConfig
from repro_torch.flashsim.workloads import RequestTrace

#: Page-op kinds of the FTL schedule.  ``OP_READ``/``OP_GC_READ`` are
#: read-like (die sense + channel transfer per retry attempt);
#: ``OP_PROG``/``OP_GC_PROG`` are write-like (channel transfer, then die
#: held for the op's duration); ``OP_ERASE`` holds the die only.
OP_READ = 0
OP_GC_READ = 1
OP_PROG = 2
OP_GC_PROG = 3
OP_ERASE = 4

_READ_LIKE_MAX = OP_GC_READ


@dataclasses.dataclass(frozen=True)
class FTLStats:
    """Mapping-layer summary of one FTL pre-pass (page counts, not time)."""

    host_reads: int            # host read page-ops (pages)
    host_progs: int            # host write page-ops (pages)
    prefill_progs: int         # lazy pre-fill mappings for never-written reads
    gc_page_reads: int         # valid pages read back by GC (pages)
    gc_page_progs: int         # valid pages re-programmed by GC (pages)
    blocks_erased: int         # erase operations issued (blocks)
    gc_invocations: int        # victim-collection passes
    write_amplification: float # (host_progs + gc_page_progs) / host_progs
    blocks_per_die: int        # physical geometry actually used (blocks)
    pages_per_block: int       # physical geometry actually used (pages)
    footprint_pages: int       # distinct logical pages referenced (pages)
    max_block_pe: float        # highest per-block added wear (P/E cycles)
    blocks_retired: int = 0    # bad blocks retired (never return to pool)


@dataclasses.dataclass(frozen=True)
class FTLSchedule:
    """Flat page-op schedule of a trace run through the FTL (admission order).

    The FTL-aware analogue of :class:`repro_torch.flashsim.ssd.TraceExpansion`:
    host page-ops in admission order with GC page-ops interleaved at their
    trigger points.  Mechanism- and condition-independent, so one schedule
    is shared by every mechanism of a sweep; only attempt sampling (which
    reads ``wear_pec``) depends on the policy/condition.
    """

    arrival_us: np.ndarray   # (P,) op admission time (us)
    rid: np.ndarray          # (P,) owning request index; -1 for GC/erase ops
    die: np.ndarray          # (P,) die id
    chan: np.ndarray         # (P,) channel id
    ptype: np.ndarray        # (P,) page-type index (lsb/csb/msb)
    kind: np.ndarray         # (P,) OP_* code
    dur_us: np.ndarray       # (P,) die-hold duration for write-like/erase ops
    wear_pec: np.ndarray     # (P,) block-local added wear at read time (P/E)
    n_requests: int
    stats: FTLStats
    #: (P,) logical page of each host op; -1 for GC/erase ops.  Only the
    #: closed-loop frontend reads it (write-cache hit detection); None on
    #: schedules built before the field existed.
    lpn: Optional[np.ndarray] = None

    @property
    def n_ops(self) -> int:
        return int(self.rid.shape[0])

    @functools.cached_property
    def admission_lists(self):
        """Per-op buffers as plain Python lists for the event loop.

        Mirrors ``TraceExpansion.admission_lists`` (scalar list indexing is
        ~4x faster than ndarray scalar access in the interpreter loop) with
        two extra views: ``is_erase`` and ``dur_us``.
        """
        return (
            self.arrival_us.tolist(),
            self.rid.tolist(),
            self.die.tolist(),
            self.chan.tolist(),
            (self.kind <= _READ_LIKE_MAX).tolist(),   # read-like
            (self.kind == OP_ERASE).tolist(),
            self.dur_us.tolist(),
        )

    @functools.cached_property
    def admission_arrays(self):
        """The same per-op buffers as dtype-pinned numpy columns.

        Mirrors ``TraceExpansion.admission_arrays``: batched-resolved
        runs hand the lockstep core whole columns and skip the
        list round-trip; the interpreter keeps
        :attr:`admission_lists`.  Values are identical either way.
        """
        return (
            np.asarray(self.arrival_us, np.float64),
            np.asarray(self.rid, np.int64),
            np.asarray(self.die, np.int64),
            np.asarray(self.chan, np.int64),
            np.asarray(self.kind <= _READ_LIKE_MAX, bool),
            np.asarray(self.kind == OP_ERASE, bool),
            np.asarray(self.dur_us, np.float64),
        )


class PageMapFTL:
    """Per-die page-mapping FTL with greedy GC (deterministic, no RNG).

    Logical pages are statically striped across dies (``lpn % n_dies`` —
    the same rule the in-place simulator uses), so enabling the FTL changes
    *where on the die* data lives and what extra traffic exists, never
    which die a host op targets.  Within a die, programs are log-structured
    over two frontier blocks: ``active`` (host writes + pre-fill) and
    ``gc_active`` (GC relocations) — the standard hot/cold split, and the
    reason GC can never select the block it is compacting into (the
    frontier blocks are not sealed, and only sealed blocks are victims).

    The class is pure mapping state — it emits page-op *events* (tuples)
    into an internal buffer that :func:`build_ftl_schedule` drains; it
    never touches simulated time.

    Two construction flags adapt the same state machine to the *online*
    GC controller (:mod:`repro_torch.flashsim.gc_online`):

    ``auto_gc=False``
        host ops never trigger collection themselves; the controller calls
        :meth:`_collect` explicitly at watermark crossings.
    ``defer_free=True``
        an erased victim does **not** re-enter the free pool inside
        :meth:`_collect`; the controller returns it via
        :meth:`erase_complete` when the erase finishes on the simulated
        die — reclaim takes simulated time.
    """

    def __init__(self, cfg: SSDConfig = DEFAULT_SSD,
                 lpns: Optional[np.ndarray] = None,
                 auto_gc: bool = True, defer_free: bool = False):
        gc = cfg.gc
        self.cfg = cfg
        self.gc = gc
        self.auto_gc = auto_gc
        self.defer_free = defer_free
        self.n_dies = cfg.n_dies
        self.ppb = gc.pages_per_block

        if gc.blocks_per_die is not None:
            bpd = int(gc.blocks_per_die)
            footprint = int(np.unique(lpns).size) if lpns is not None else 0
        else:
            if lpns is None:
                raise ValueError(
                    "GCConfig.blocks_per_die is None (auto-size): "
                    "PageMapFTL needs the trace's lpns to size capacity"
                )
            uniq = np.unique(lpns)
            footprint = int(uniq.size)
            per_die = np.bincount(
                (uniq % self.n_dies).astype(np.int64), minlength=self.n_dies
            )
            data_blocks = max(int(np.ceil(per_die.max() / self.ppb)), 1)
            bpd = int(np.ceil(data_blocks / (1.0 - gc.op_ratio)))
            # Floor: the live footprint plus one frontier and one spare
            # must always fit, or a write-once fill could exhaust the
            # allocator before GC has anything to reclaim.
            bpd = max(bpd, data_blocks + 2)
        # Room for both frontier blocks + the GC threshold, whatever OP says.
        bpd = max(bpd, gc.gc_threshold_blocks + 3)
        self.blocks_per_die = bpd
        self.footprint = footprint

        nb = self.n_dies * bpd
        self.n_blocks = nb
        self.valid = np.zeros(nb, np.int64)       # valid pages per block
        self.wp = np.zeros(nb, np.int64)          # pages programmed per block
        self.erases = np.zeros(nb, np.int64)      # erase count per block
        self.p2l = np.full(nb * self.ppb, -1, np.int64)
        self.l2p: Dict[int, int] = {}
        self.free: List[Deque[int]] = [
            deque(range(d * bpd, (d + 1) * bpd)) for d in range(self.n_dies)
        ]
        self.active = [-1] * self.n_dies          # host/pre-fill frontier
        self.gc_active = [-1] * self.n_dies       # GC relocation frontier
        self.sealed: List[Set[int]] = [set() for _ in range(self.n_dies)]

        self.host_progs = 0
        self.prefill_progs = 0
        self.gc_page_reads = 0
        self.gc_page_progs = 0
        self.blocks_erased = 0
        self.gc_invocations = 0
        #: Bad blocks taken out of service (:meth:`retire_block` /
        #: :meth:`retire_erase_failed`) — never re-enter any free pool.
        self.retired: Set[int] = set()
        self.blocks_retired = 0
        #: (die, victim, gc_frontier_at_selection) per collection — lets
        #: tests assert GC never evicts the block it compacts into.
        self.gc_log: List[Tuple[int, int, int]] = []
        self._events: List[Tuple[int, int, int, float, int]] = []

    # -- allocation ---------------------------------------------------------

    def _alloc(self, die: int, gc_stream: bool) -> int:
        """Next free physical page slot on ``die`` (pops a free block as
        needed, sealing the filled frontier).

        Under extreme pressure (no free block left) the allocation borrows
        room from the *sibling* stream's frontier instead of failing: at
        tiny sim-scaled geometries the last invalid slack can sit entirely
        in the other frontier, and refusing it would wedge a device whose
        live data still fits.  The borrow briefly mixes the hot/cold
        streams; it is rare and only happens at the edge of device-full.
        """
        frontier = self.gc_active if gc_stream else self.active
        blk = frontier[die]
        if blk < 0 or self.wp[blk] >= self.ppb:
            if blk >= 0:
                self.sealed[die].add(blk)
                frontier[die] = -1
            free = self.free[die]
            if free:
                blk = free.popleft()
                frontier[die] = blk
            else:
                other = (self.active if gc_stream else self.gc_active)[die]
                if other >= 0 and self.wp[other] < self.ppb:
                    blk = other  # borrowed: ownership stays with sibling
                else:
                    raise RuntimeError(
                        f"FTL die {die} out of free blocks "
                        f"(blocks_per_die={self.blocks_per_die} too small "
                        f"for the workload footprint; raise it or op_ratio)"
                    )
        ppn = blk * self.ppb + int(self.wp[blk])
        self.wp[blk] += 1
        return ppn

    def can_alloc(self, die: int, gc_stream: bool = False) -> bool:
        """Whether :meth:`_alloc` on ``die`` would succeed right now.

        The online controller probes this before mapping a host write at
        program start; False means the write must stall until an erase
        completes (host write throttling).
        """
        frontier = (self.gc_active if gc_stream else self.active)[die]
        if frontier >= 0 and self.wp[frontier] < self.ppb:
            return True
        if self.free[die]:
            return True
        other = (self.active if gc_stream else self.gc_active)[die]
        return other >= 0 and self.wp[other] < self.ppb

    def _map_write(self, lpn: int, gc_stream: bool) -> int:
        """(Re)map ``lpn`` to a fresh physical page; invalidate the old one."""
        old = self.l2p.get(lpn, -1)
        if old >= 0:
            self.valid[old // self.ppb] -= 1
            self.p2l[old] = -1
        ppn = self._alloc(lpn % self.n_dies, gc_stream)
        self.l2p[lpn] = ppn
        self.p2l[ppn] = lpn
        self.valid[ppn // self.ppb] += 1
        return ppn

    # -- garbage collection -------------------------------------------------

    def _pick_victim(self, die: int) -> int:
        """Greedy: sealed block with the fewest valid pages (ties: lowest
        id, for determinism).  Returns -1 when no block would free space."""
        best, best_valid = -1, self.ppb
        for b in sorted(self.sealed[die]):
            v = int(self.valid[b])
            if v < best_valid:
                best, best_valid = b, v
        return best

    def _collect(self, die: int) -> bool:
        """One GC pass: compact the greedy victim, erase it.  False when no
        victim can yield free space (device effectively full)."""
        victim = self._pick_victim(die)
        if victim < 0:
            return False
        v = int(self.valid[victim])
        gdst = self.gc_active[die]
        room = 0 if gdst < 0 else self.ppb - int(self.wp[gdst])
        ha = self.active[die]
        if ha >= 0:  # pressure fallback may borrow the host frontier
            room += self.ppb - int(self.wp[ha])
        if v > room + len(self.free[die]) * self.ppb:
            return False  # nowhere to relocate into
        self.gc_invocations += 1
        self.gc_log.append((die, victim, gdst))
        base = victim * self.ppb
        wear = float(self.erases[victim]) * self.gc.pec_per_erase
        for slot in range(int(self.wp[victim])):
            lpn = int(self.p2l[base + slot])
            if lpn < 0:
                continue  # already invalidated by a newer host write
            self._events.append((OP_GC_READ, die, lpn % 3, wear, victim))
            self.gc_page_reads += 1
            self._map_write(lpn, gc_stream=True)
            self._events.append((OP_GC_PROG, die, lpn % 3, 0.0, victim))
            self.gc_page_progs += 1
        # Victim is now fully invalid: erase it and (prepass) return it to
        # the pool; under defer_free the online controller returns it via
        # erase_complete() when the erase finishes on the simulated die.
        self.erases[victim] += 1
        self.wp[victim] = 0
        self.valid[victim] = 0
        self.sealed[die].discard(victim)
        if not self.defer_free:
            self.free[die].append(victim)
        self.blocks_erased += 1
        self._events.append((OP_ERASE, die, 0, 0.0, victim))
        return True

    def erase_complete(self, die: int, block: int) -> None:
        """Return an erased (defer_free) victim to ``die``'s free pool."""
        self.free[die].append(block)

    # -- bad-block retirement ------------------------------------------------

    def retire_block(self, die: int, block: int) -> bool:
        """Take a sealed block out of service, relocating its valid pages.

        The controller's end-of-ladder action after a parity rebuild: the
        block's valid pages are compacted through the GC frontier (page
        read + reprogram events, drained like GC traffic) and the block
        never re-enters the free pool.  Returns False — retirement is
        refused — when the block is not a retirable sealed block of
        ``die`` (frontiers and in-flight-erase victims are not), is
        already retired, or when relocating it would consume the die's
        last free block (a wedged device is worse than a bad block; the
        block then stays in service and may be retried later).

        Die-partitioned like every other mutation here: only ``die``'s
        structures are touched, so the sharded engine's contract holds.
        """
        ppb = self.ppb
        if block in self.retired:
            return False
        if block // self.blocks_per_die != die:
            return False
        if block not in self.sealed[die]:
            return False   # frontier / erasing / already free: not ours
        v = int(self.valid[block])
        gdst = self.gc_active[die]
        room = 0 if gdst < 0 else ppb - int(self.wp[gdst])
        ha = self.active[die]
        if ha >= 0:
            room += ppb - int(self.wp[ha])
        # Keep one free block in reserve: retirement must never eat the
        # last allocation room a stalled host write is waiting on.
        if v > room + max(len(self.free[die]) - 1, 0) * ppb:
            return False
        base = block * ppb
        wear = float(self.erases[block]) * self.gc.pec_per_erase
        for slot in range(int(self.wp[block])):
            lpn = int(self.p2l[base + slot])
            if lpn < 0:
                continue
            self._events.append((OP_GC_READ, die, lpn % 3, wear, block))
            self.gc_page_reads += 1
            self._map_write(lpn, gc_stream=True)
            self._events.append((OP_GC_PROG, die, lpn % 3, 0.0, block))
            self.gc_page_progs += 1
        self.sealed[die].discard(block)
        self.wp[block] = ppb      # never allocatable again
        self.valid[block] = 0
        self.retired.add(block)
        self.blocks_retired += 1
        return True

    def retire_erase_failed(self, die: int, block: int) -> None:
        """Retire a block whose erase failed verification.

        Called by the online controller *instead of* :meth:`erase_complete`:
        the block was already compacted and erased by :meth:`_collect`
        (no valid data on it), so retirement is just never returning it
        to ``die``'s free pool.
        """
        self.wp[block] = self.ppb
        self.retired.add(block)
        self.blocks_retired += 1

    def _maybe_gc(self, die: int) -> None:
        if not self.auto_gc:
            return
        guard = 4 * self.blocks_per_die
        while len(self.free[die]) <= self.gc.gc_threshold_blocks and guard > 0:
            if not self._collect(die):
                break
            guard -= 1

    # -- host-facing API ----------------------------------------------------

    def host_write(self, lpn: int) -> None:
        """Out-of-place program of one logical page; may trigger GC."""
        self._map_write(lpn, gc_stream=False)
        self.host_progs += 1
        self._maybe_gc(lpn % self.n_dies)

    def host_read(self, lpn: int) -> float:
        """Resolve a read; returns the mapped block's added wear (P/E).

        A never-written lpn is lazily *pre-filled* (the drive shipped with
        that data): it consumes a physical page and can advance frontiers,
        but is not counted as a host program and emits no program traffic.
        """
        ppn = self.l2p.get(lpn, -1)
        if ppn < 0:
            ppn = self._map_write(lpn, gc_stream=False)
            self.prefill_progs += 1
            self._maybe_gc(lpn % self.n_dies)
        return float(self.erases[ppn // self.ppb]) * self.gc.pec_per_erase

    def drain_events(self) -> List[Tuple[int, int, int, float, int]]:
        """Take the GC page-op events emitted since the last drain —
        ``(kind, die, ptype, wear_pec, victim_block)`` tuples in emission
        order (the block id lets the online controller credit the right free
        pool when the erase completes)."""
        ev = self._events
        self._events = []
        return ev

    @property
    def write_amplification(self) -> float:
        """Physical programs per host program (>= 1.0 by construction)."""
        if self.host_progs == 0:
            return 1.0
        return (self.host_progs + self.gc_page_progs) / self.host_progs

    def stats(self, host_reads: int = 0) -> FTLStats:
        return FTLStats(
            host_reads=host_reads,
            host_progs=self.host_progs,
            prefill_progs=self.prefill_progs,
            gc_page_reads=self.gc_page_reads,
            gc_page_progs=self.gc_page_progs,
            blocks_erased=self.blocks_erased,
            gc_invocations=self.gc_invocations,
            write_amplification=self.write_amplification,
            blocks_per_die=self.blocks_per_die,
            pages_per_block=self.ppb,
            footprint_pages=self.footprint,
            max_block_pe=float(self.erases.max()) * self.gc.pec_per_erase,
            blocks_retired=self.blocks_retired,
        )


def build_ftl_schedule(
    trace: RequestTrace, cfg: SSDConfig = DEFAULT_SSD, expansion=None
) -> FTLSchedule:
    """Run a trace through the FTL and emit the combined page-op schedule.

    Deterministic pre-pass in admission order: host ops keep exactly the
    (arrival, rid, die, channel, page type) the in-place expansion gives
    them; GC/erase ops are interleaved right after the host write that
    triggered them, carrying that write's arrival time, ``rid = -1``, and
    the victim block's wear.  The result is shared across every mechanism
    of a sweep, like ``expand_trace``'s output.  Pass ``expansion`` to
    reuse an already-computed ``expand_trace(trace, cfg)`` result.
    """
    from repro_torch.flashsim.ssd import expand_trace  # deferred: ssd imports us

    ex = expansion if expansion is not None else expand_trace(trace, cfg)
    ftl = PageMapFTL(cfg, lpns=ex.page_id)
    tprog = cfg.timing.tprog_us
    terase = cfg.gc.t_erase_us
    n_ch = cfg.n_channels

    arrival: List[float] = []
    rid: List[int] = []
    die: List[int] = []
    chan: List[int] = []
    ptype: List[int] = []
    kind: List[int] = []
    dur: List[float] = []
    wear: List[float] = []
    lpns: List[int] = []

    def emit(a, r, d, pt, k, du, w, lp=-1):
        arrival.append(a)
        rid.append(r)
        die.append(d)
        chan.append(d % n_ch)
        ptype.append(pt)
        kind.append(k)
        dur.append(du)
        wear.append(w)
        lpns.append(lp)

    arr_l = ex.arrival_us.tolist()
    rid_l = ex.rid.tolist()
    lpn_l = ex.page_id.tolist()
    read_l = ex.is_read.tolist()
    n_dies = cfg.n_dies
    host_reads = 0
    for i in range(ex.n_ops):
        lpn = lpn_l[i]
        a = arr_l[i]
        d = lpn % n_dies
        if read_l[i]:
            w = ftl.host_read(lpn)
            emit(a, rid_l[i], d, lpn % 3, OP_READ, 0.0, w, lpn)
            host_reads += 1
        else:
            ftl.host_write(lpn)
            emit(a, rid_l[i], d, lpn % 3, OP_PROG, tprog, 0.0, lpn)
        for (k, gd, pt, gw, _blk) in ftl.drain_events():
            gdur = tprog if k == OP_GC_PROG else (terase if k == OP_ERASE else 0.0)
            emit(a, -1, gd, pt, k, gdur, gw)

    return FTLSchedule(
        arrival_us=np.asarray(arrival, np.float64),
        rid=np.asarray(rid, np.int64),
        die=np.asarray(die, np.int64),
        chan=np.asarray(chan, np.int64),
        ptype=np.asarray(ptype, np.int64),
        kind=np.asarray(kind, np.int64),
        dur_us=np.asarray(dur, np.float64),
        wear_pec=np.asarray(wear, np.float64),
        n_requests=ex.n_requests,
        stats=ftl.stats(host_reads=host_reads),
        lpn=np.asarray(lpns, np.int64),
    )
