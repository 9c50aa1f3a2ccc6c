"""Event-driven multi-queue SSD simulator (MQSim-analogue), run APIs.

The same simulator as the reference package's ``ssd`` module, with the
characterization read through :mod:`repro_torch.core.characterize` on a
torch device:

  * 8 channels x 8 dies; per-die queues under a pluggable scheduling
    policy and FCFS channel arbitration;
  * every retry attempt senses on the die, transfers over the shared
    channel, and decodes on the channel's LDPC engine (folded in as a
    fixed +tECC after each transfer);
  * CACHE READ semantics for PR²: sensing of attempt i+1 overlaps the
    transfer+decode of attempt i; one speculative sense is charged to
    die occupancy when a retried sequence terminates;
  * AR² scales every attempt's tR by the characterized safe scale for
    the operating condition and samples attempt counts from the
    reduced-tR retry distribution;
  * the SOTA baseline starts the retry search at its predicted entry.

Per-read attempt counts are sampled from the 160-chip characterization
histograms for the simulated (retention, P/E) condition.

Engines: ``engine="array"`` (default) runs the host interpreter
(:mod:`repro_torch.flashsim.engine`); ``engine="batched"`` runs every
channel as one lane of the shard-core kernel
(:mod:`repro_torch.flashsim.engine_batched` — the CUDA kernel on the
card, its plain torch version on the CPU), bit-identical to the array
engine; ``engine="auto"`` picks batched when the configuration is inside
its matrix and records the decision on :class:`SimStats`.

``engine="reference"`` runs the seed closure engine
(:mod:`repro_torch.flashsim.engine_ref`) on the host.  ``workers > 1``
and ``journal=`` hand the sweep to :mod:`repro_torch.flashsim.runtime`.

``gc="prepass"`` runs the trace through the page-mapping FTL
(:mod:`repro_torch.flashsim.ftl`) once per trace; its schedule of host
ops, GC copy-back reads and programs, and erases is shared by every
mechanism, and worn blocks sample their attempts and AR² scale from the
characterization of their own P/E bin.  ``gc="online"`` advances the
FTL inside the run instead (:mod:`repro_torch.flashsim.gc_online`):
pages map when the die takes the program, collection starts when a
die's free pool falls to the watermark, and an erased block returns
only when its erase completes.

``faults=`` attaches the fault model and its recovery ladder
(:mod:`repro_torch.flashsim.faults`): AR² mispredictions, escalation
re-reads, parity rebuilds and block retirement, planned before the run
in place and under prepass GC, drawn at the simulated instants under
online GC.

``ncq_depth=`` runs the trace through the closed-loop frontend
(:func:`repro_torch.flashsim.engine.run_closed_loop`): at most
``ncq_depth`` requests in flight, admitted as earlier ones complete, on
the array interpreter; ``host_cache=`` adds the host write-back cache
(:mod:`repro_torch.flashsim.hostcache`).  The batched engine is
open-loop only, so ``engine="auto"`` runs closed cells on the array
interpreter and records why.

Online GC and faults run on the host interpreter, as in the reference:
``engine="batched"`` raises
:class:`~repro_torch.flashsim.engine_batched.BatchedUnsupported` for
them and ``engine="auto"`` records why it ran the array interpreter.

Every run API takes ``device=`` and runs on the CUDA card unless told
otherwise; ``device=None`` without CUDA raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import characterize as CH
from repro_torch.core.retry import RetryPolicy
from repro_torch.device import resolve_device
from repro_torch.flashsim.config import (
    DEFAULT_SSD,
    OperatingCondition,
    SSDConfig,
)
from repro_torch.flashsim import ftl as FTL
from repro_torch.flashsim.engine import make_buffers, run_event_core
from repro_torch.flashsim.faults import FaultModel, plan_faults
from repro_torch.flashsim.gc_online import OnlineGC
from repro_torch.flashsim.sched import get_scheduler
from repro_torch.flashsim.workloads import (
    RequestTrace,
    SyntheticSource,
    TraceSource,
    Truncate,
    Workload,
    cached_trace,
    get_source,
)

PAGE_TYPE_ORDER = ("lsb", "csb", "msb")

#: What the run APIs accept as a workload: a synthetic profile, a
#: registry spec string ("websearch", "msr:web_0?rescale=0.5", ...), or
#: any TraceSource.
WorkloadLike = Union[Workload, str, TraceSource]

def _pctl(a: np.ndarray, qs) -> np.ndarray:
    """``np.percentile(a, qs)`` for 1-D float64 without the per-call
    dispatch machinery (argument normalization costs more than the
    partition on sweep-cell-sized arrays).  Bit-identical to numpy's
    default linear method: same ``q/100 * (n-1)`` virtual indexes, the
    same shared partition across quantiles, and numpy's own two-sided
    lerp (the ``t >= 0.5`` branch computes ``b - (b-a)*(1-t)``).
    """
    n = a.size
    virt = np.true_divide(np.asarray(qs, np.float64), 100) * (n - 1)
    prev = np.floor(virt)
    nxt = np.minimum(prev + 1, n - 1)
    pi = prev.astype(np.intp)
    ni = nxt.astype(np.intp)
    part = np.partition(a, np.concatenate([pi, ni]))
    va, vb = part[pi], part[ni]
    t = virt - prev
    diff = vb - va
    out = va + diff * t
    hi = t >= 0.5
    out[hi] = vb[hi] - diff[hi] * (1 - t[hi])
    return out



def resolve_trace(
    workload: WorkloadLike, seed: int = 0, n_requests: Optional[int] = None
) -> RequestTrace:
    """Resolve a workload-like argument to a (cached, frozen) trace.

    :class:`Workload` profiles take the exact legacy path —
    ``dataclasses.replace(n_requests=...)`` + :func:`cached_trace` — so
    synthetic runs stay bit-identical to the pre-package module.  Spec
    strings resolve through :func:`repro_torch.flashsim.workloads.registry.
    get_source`; for sources, ``n_requests`` adds a ``Truncate``
    transform (first N requests in arrival order), slotted *before* any
    dense footprint remap so the registry's canonical order — and the
    dense ``[0, footprint)`` guarantee — hold exactly as they would for
    ``?limit=N``.
    """
    if isinstance(workload, Workload):
        if n_requests is not None:
            workload = dataclasses.replace(workload, n_requests=n_requests)
        return cached_trace(workload, seed=seed)
    src = workload if isinstance(workload, TraceSource) else \
        get_source(workload)
    if n_requests is not None:
        if isinstance(src, SyntheticSource) and not src.transforms:
            # A bare profile spelled as a string regenerates at length N
            # exactly like the Workload-object call — the two spellings
            # must never diverge (truncating the full default-length
            # trace would give different arrays AND cost a 40x build).
            w = dataclasses.replace(src.workload, n_requests=n_requests)
            return cached_trace(w, seed=seed)
        from repro_torch.flashsim.workloads.registry import POST_LIMIT_TRANSFORMS

        tfs = list(src.transforms)
        # Canonical ?limit=N position (defined by the registry order).
        at = next((i for i, t in enumerate(tfs)
                   if isinstance(t, POST_LIMIT_TRANSFORMS)), len(tfs))
        tfs.insert(at, Truncate(n_requests))
        src = dataclasses.replace(src, transforms=tuple(tfs))
    return src.trace(seed)



@dataclasses.dataclass
class SimStats:
    """Response-time statistics over completed requests.

    All times are microseconds; utilizations are fractions of the trace
    span.  The field set is the reference's, so the two packages' stats
    compare field by field.  The GC block is filled by prepass- and
    online-GC runs, the fault block by runs with ``faults=`` (its
    defaults are the failure-free facts) and the closed-loop block by
    ``ncq_depth`` runs (zero on open-loop runs).  ``gc_suspensions``
    counts preempt-scheduler suspend events.
    """

    mean_us: float            # mean response time over ALL requests (us)
    p50_us: float             # response-time percentiles, all requests (us)
    p95_us: float
    p99_us: float
    read_mean_us: float       # mean response time over host READS only (us)
    n_requests: int           # completed requests (reads + writes)
    mean_read_attempts: float # read attempts per host read page (>= 1)
    die_util: float           # busy fraction, averaged over dies [0, 1]
    channel_util: float       # busy fraction, averaged over channels [0, 1]
    read_p99_us: float = 0.0  # p99 response time over host READS only (us)
    wa: float = 1.0           # write amplification: phys/host programs
    gc_invocations: int = 0   # GC victim-collection passes
    gc_page_reads: int = 0    # pages read back by GC copy-back
    gc_page_progs: int = 0    # pages re-programmed by GC copy-back
    blocks_erased: int = 0    # blocks erased by GC
    gc_suspensions: int = 0   # preempt: GC ops suspended for host reads
    write_stalls: int = 0     # online GC: host writes stalled on free pool
    mispredicted_reads: int = 0  # AR² reduced-tR decode failures (re-read)
    rescued_reads: int = 0    # uncorrectables recovered by escalation
    parity_rebuilds: int = 0  # superpage stripe rebuilds run
    rebuild_reads: int = 0    # stripe-peer read page-ops issued
    retired_blocks: int = 0   # bad blocks retired
    program_fails: int = 0    # host programs that needed a reprogram
    erase_fails: int = 0      # erases that failed verification
    unrecoverable: int = 0    # reads lost after the full recovery ladder
    recovery_p99_us: float = 0.0  # p99 response over recovery-affected reqs
    # Closed-loop block: populated only when the NCQ frontend is on
    # (``SSDConfig.ncq_depth`` / the run APIs' ``ncq_depth=`` knob).
    # Response time decomposes exactly:  response = hostq wait
    # + device time + host_overhead_us.
    hostq_wait_mean_us: float = 0.0   # mean admission wait in the host queue
    hostq_wait_p99_us: float = 0.0    # p99 admission wait
    device_mean_us: float = 0.0       # mean admit -> complete device time
    read_device_p99_us: float = 0.0   # p99 device time over host reads —
    #                                   the QD-bounded latency figure
    throughput_iops: float = 0.0      # sustained n_requests / makespan
    max_inflight: int = 0             # peak admitted-and-incomplete requests
    cache_hit_reads: int = 0          # reads served entirely from the cache
    cache_hit_pages: int = 0          # read pages served from dirty lines
    cache_absorbed_writes: int = 0    # writes absorbed by the write cache
    cache_flush_pages: int = 0        # page programs issued by cache flushes
    cache_stalled_writes: int = 0     # writes that waited on cache capacity
    die_sense_util: float = 0.0       # fraction of span dies spent sensing
    #: Events retired by the batched shard-core kernel — 0 for
    #: interpreter runs, ``== n_events`` for ``engine="batched"`` runs.
    #: Observability only: excluded from equality so batched-vs-array
    #: bit-identity asserts compare the simulation outcome, not the
    #: engine that produced it.
    fast_path_events: int = dataclasses.field(default=0, compare=False)
    #: Engine that actually ran this cell — the resolved concrete engine
    #: for ``engine="auto"``, the engine's own name for explicit
    #: selections.  ``engine_fallback_reason`` is non-empty exactly when
    #: auto fell back to the interpreter: it carries the
    #: ``BatchedUnsupported`` message the explicit batched engine would
    #: have raised, so auto documents rather than hides its decision.
    #: Observability only (``compare=False``): auto-vs-explicit equality
    #: asserts compare the simulation outcome, not the selection path.
    engine_selected: str = dataclasses.field(default="", compare=False)
    engine_fallback_reason: str = dataclasses.field(default="",
                                                    compare=False)
    #: Number of sweep cells that shared this cell's kernel dispatch
    #: (0 = the cell ran alone).  Observability only (``compare=False``):
    #: fused-vs-sequential bit-identity asserts compare the simulation
    #: outcome, not the dispatch grouping.
    fused_cells: int = dataclasses.field(default=0, compare=False)

    def as_row(self) -> str:
        row = (
            f"mean={self.mean_us:9.1f}us p50={self.p50_us:8.1f} p95={self.p95_us:9.1f} "
            f"p99={self.p99_us:9.1f} attempts={self.mean_read_attempts:5.2f} "
            f"die_u={self.die_util:.2f} ch_u={self.channel_util:.2f}"
        )
        if self.wa > 1.0 or self.gc_invocations:
            row += f" wa={self.wa:.2f} gc={self.gc_invocations}"
        return row



@dataclasses.dataclass(frozen=True)
class TraceExpansion:
    """Mechanism-independent flat page-op view of a trace (admission order).

    Shared across all mechanisms of a sweep: only the per-op attempt counts
    and sense times depend on the policy, and those are sampled separately.
    """

    arrival_us: np.ndarray   # (P,) op admission time = its request's arrival (us)
    rid: np.ndarray          # (P,) owning request index
    die: np.ndarray          # (P,) die id
    chan: np.ndarray         # (P,) channel id
    ptype: np.ndarray        # (P,) page type index into PAGE_TYPE_ORDER
    is_read: np.ndarray      # (P,) bool
    page_id: np.ndarray      # (P,) logical page number (FTL input)
    n_requests: int

    @property
    def n_ops(self) -> int:
        return int(self.rid.shape[0])

    @functools.cached_property
    def admission_lists(self):
        """Mechanism-independent per-op buffers as plain Python lists.

        The event loop reads flat lists (scalar list indexing is ~4x faster
        than ndarray scalar access); converting once here instead of per
        ``run()`` lets a mechanism sweep reuse the views.
        """
        return (
            self.arrival_us.tolist(),
            self.rid.tolist(),
            self.die.tolist(),
            self.chan.tolist(),
            self.is_read.tolist(),
        )

    @functools.cached_property
    def admission_arrays(self):
        """The same per-op buffers as dtype-pinned numpy columns.

        The batched engine consumes whole columns (``_lane_tables``
        re-``asarray``s every buffer), so batched-resolved runs take the
        expansion's own arrays and skip the list round-trip entirely;
        the interpreter keeps :attr:`admission_lists` (scalar list
        indexing is faster there).  Values are identical either way.
        """
        return (
            np.asarray(self.arrival_us, np.float64),
            np.asarray(self.rid, np.int64),
            np.asarray(self.die, np.int64),
            np.asarray(self.chan, np.int64),
            np.asarray(self.is_read, bool),
        )


def expand_trace(trace: RequestTrace, cfg: SSDConfig = DEFAULT_SSD) -> TraceExpansion:
    """Vectorized request -> page-op expansion (no per-request Python loop).

    Ops come out in admission order.  Traces from :func:`generate_trace`
    arrive sorted; externally-supplied traces (e.g. future MSR/blktrace
    ingestion) may not, so unsorted arrivals are stably sorted here —
    matching the retired heap engine's (time, request-index) admission
    order exactly.
    """
    arrival = trace.arrival_us
    n = len(arrival)
    if np.any(np.diff(arrival) < 0):
        req_order = np.argsort(arrival, kind="stable")
    else:
        req_order = np.arange(n)
    n_pages = trace.n_pages[req_order]
    rid = np.repeat(req_order, n_pages)
    # Within-request page offsets 0..n_pages[r]-1, flattened.
    starts = np.cumsum(n_pages) - n_pages
    off = np.arange(int(n_pages.sum()), dtype=np.int64) - np.repeat(starts, n_pages)
    page_ids = trace.start_page[rid] + off
    die = (page_ids % cfg.n_dies).astype(np.int64)
    return TraceExpansion(
        arrival_us=trace.arrival_us[rid],
        rid=rid,
        die=die,
        chan=cfg.channel_of(die),
        ptype=(page_ids % 3).astype(np.int64),
        is_read=trace.is_read[rid],
        page_id=page_ids.astype(np.int64),
        n_requests=n,
    )




class SSDSim:
    """One simulation run = (workload trace, operating condition, policy),
    characterized and (for ``engine="batched"``) simulated on ``device``."""

    def __init__(
        self,
        cfg: SSDConfig = DEFAULT_SSD,
        condition: OperatingCondition = OperatingCondition(),
        policy: RetryPolicy = RetryPolicy("baseline"),
        seed: int = 0,
        engine: str = "array",
        device=None,
    ):
        self.device = resolve_device(device)
        if engine not in ("array", "batched", "auto"):
            raise ValueError(
                f"SSDSim engine must be 'array', 'batched' or 'auto', got "
                f"{engine!r} (engine='reference' is SSDSimRef)"
            )
        if engine == "batched":
            from repro_torch.flashsim.engine_batched import (
                check_batched_config)

            check_batched_config(cfg, self.device)
        # engine="auto" defers resolution to run(), where validate= is
        # known; it never raises BatchedUnsupported — the decision (and
        # any fallback reason) is recorded on the returned SimStats.
        self.cfg = cfg
        self.cond = condition
        self.policy = policy
        self.seed = seed
        self.engine = engine
        self.rng = np.random.default_rng(seed)
        self.events_processed = 0
        # AR² tR scale for this operating condition (characterized table).
        if policy.adaptive_tr:
            if policy.tr_scale == "auto":
                self.tr_scale = CH.characterize_condition(
                    condition.retention_days, condition.pec,
                    device=self.device,
                ).safe_tr_scale
            else:
                self.tr_scale = float(policy.tr_scale)
        else:
            self.tr_scale = 1.0
        # Per-block AR² scale memo: snapped effective P/E -> safe scale.
        self._wear_scales: Dict[float, float] = {}
        # Worn-block attempt-CDF memo: (page type, wear) -> CDF, one
        # resolution per distinct wear for the whole run.
        self._wear_cdfs: Dict[Tuple[str, float], np.ndarray] = {}
        # Unscaled per-page-type tR (scale applied per op: device-level for
        # unworn blocks, per-block for GC-worn ones).
        self._tr_base = np.array(
            [cfg.timing.tr_us[pt] for pt in PAGE_TYPE_ORDER]
        )
        # Per-page-type attempt-count CDFs under this mechanism (memoized
        # across SSDSim instances in repro_torch.core.characterize).
        self._attempt_cdfs = {
            pt: CH.attempt_cdf(
                condition.retention_days,
                condition.pec,
                page_type=pt,
                sota=policy.sota_start,
                tr_scale=self.tr_scale,
                device=self.device,
            )
            for pt in PAGE_TYPE_ORDER
        }

    # -- attempt sampling ----------------------------------------------------

    def _scale_for(self, wear_pec: float) -> float:
        """AR² tR scale at a block's effective wear.

        Zero wear, or a non-adaptive or pinned-scale policy, uses the
        device-condition scale.  A worn block resolves its condition
        (``OperatingCondition.with_wear``), snaps the effective P/E count
        up to the characterization grid and takes *that* bin's safe
        scale (:meth:`_bin_scale`).
        """
        if (wear_pec <= 0.0 or not self.policy.adaptive_tr
                or self.policy.tr_scale != "auto"):
            return self.tr_scale
        return self._bin_scale(CH.snap_pec(self.cond.with_wear(wear_pec).pec))

    def _bin_scale(self, pec_bin: float) -> float:
        """Safe AR² scale of one P/E bin at this run's retention,
        characterized on ``self.device``; memoized per bin."""
        s = self._wear_scales.get(pec_bin)
        if s is None:
            s = CH.characterize_condition(
                self.cond.retention_days, pec_bin, device=self.device
            ).safe_tr_scale
            self._wear_scales[pec_bin] = s
        return s

    def _cdf_for(self, page_type: str, wear_pec: float) -> np.ndarray:
        """Attempt CDF for one page type at a block's effective wear.

        Zero wear uses the device-condition table untouched.  A worn
        block snaps its effective P/E count up to the characterization
        grid and samples that bin's table (:meth:`_bin_cdf`); memoized
        per (page type, wear).
        """
        if wear_pec <= 0.0:
            return self._attempt_cdfs[page_type]
        key = (page_type, wear_pec)
        cdf = self._wear_cdfs.get(key)
        if cdf is None:
            cdf = self._bin_cdf(
                page_type, CH.snap_pec(self.cond.with_wear(wear_pec).pec))
            self._wear_cdfs[key] = cdf
        return cdf

    def _bin_cdf(self, page_type: str, pec_bin: float) -> np.ndarray:
        """Attempt CDF of one page type in one P/E bin: for adaptive-tR
        policies the search runs at the bin's own AR² scale, so a worn
        block's attempts and sense time come from one characterization
        bin."""
        scale = (self._bin_scale(pec_bin) if self.policy.adaptive_tr
                 and self.policy.tr_scale == "auto" else self.tr_scale)
        return CH.attempt_cdf(
            self.cond.retention_days, pec_bin, page_type=page_type,
            sota=self.policy.sota_start, tr_scale=scale, device=self.device)

    def _draw_attempts(self, ptype_idx: int, wear_pec: float,
                       rng: Optional[np.random.Generator] = None) -> int:
        """One attempt count at (page type, block wear), from ``rng``
        (default: the run's ``self.rng``)."""
        pt = PAGE_TYPE_ORDER[ptype_idx]
        r = self.rng if rng is None else rng
        a = int(np.searchsorted(self._cdf_for(pt, wear_pec), r.random()))
        return a if a > 1 else 1

    def _tr_for(self, ptype_idx: int, wear_pec: float) -> float:
        """Per-attempt sense time at (page type, block wear)."""
        return float(self._tr_base[ptype_idx]) * self._scale_for(wear_pec)

    def _sample_attempts(
        self,
        page_types: np.ndarray,
        wear_pec: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Inverse-CDF attempt counts for a batch of page-type indices,
        one uniform per read page in admission order.  With ``wear_pec``
        (FTL runs) each read samples the CDF of its block's wear; the
        uniform stream is the same either way."""
        u = self.rng.random(page_types.shape)
        out = np.empty(page_types.shape, np.int64)
        for i, pt in enumerate(PAGE_TYPE_ORDER):
            m = page_types == i
            if not m.any():
                continue
            if wear_pec is None:
                out[m] = np.searchsorted(self._attempt_cdfs[pt], u[m])
            else:
                um, wm = u[m], wear_pec[m]
                om = np.empty(um.shape, np.int64)
                for wv in np.unique(wm):
                    sel = wm == wv
                    om[sel] = np.searchsorted(self._cdf_for(pt, float(wv)),
                                              um[sel])
                out[m] = om
        return np.maximum(out, 1)

    # -- run orchestration ---------------------------------------------------

    def _tr_scales_for_schedule(self, schedule, read_like: np.ndarray):
        """Per-op AR² scale over an FTL schedule (per-block resolution)."""
        P = schedule.n_ops
        scale = np.full(P, self.tr_scale)
        if self.policy.adaptive_tr and self.policy.tr_scale == "auto":
            wear = schedule.wear_pec
            worn = read_like & (wear > 0.0)
            if worn.any():
                for wv in np.unique(wear[worn]):
                    scale[worn & (wear == wv)] = self._scale_for(float(wv))
        return scale

    def _prepare(
        self,
        trace: RequestTrace,
        expansion: Optional[TraceExpansion] = None,
        schedule: Optional[FTL.FTLSchedule] = None,
        validate: bool = False,
    ) -> "_PreparedRun":
        """Everything :meth:`run` does before the engine dispatch.

        Resolves the engine, builds the FTL schedule under prepass GC when
        none is given, samples the attempt schedule (consuming
        ``self.rng`` in admission order), plans the faults of a run with
        ``cfg.faults`` (:func:`repro_torch.flashsim.faults.plan_faults`)
        or attaches the online-GC controller, and builds the admission
        buffers, with the per-op logical pages a closed run's host cache
        reads.  Split out so the fused sweep path can prepare many
        cells, run them in one kernel launch, and :meth:`_finalize` each.
        """
        cfg, t = self.cfg, self.cfg.timing
        tprog = t.tprog_us
        sched_policy = get_scheduler(cfg.scheduler)
        gc_mode = cfg.gc.mode if cfg.gc.enabled else None
        closed = cfg.ncq_depth is not None
        engine_selected = self.engine
        engine_reason = ""
        if self.engine == "auto":
            from repro_torch.flashsim.engine_batched import resolve_engine

            engine_selected, engine_reason = resolve_engine(cfg, validate,
                                                           self.device)
        batched = engine_selected == "batched"
        if closed:
            if gc_mode == "online":
                raise NotImplementedError(
                    "closed-loop frontend (ncq_depth) does not support "
                    "online GC yet — use gc='prepass'"
                )
            if sched_policy.preemptive:
                raise NotImplementedError(
                    "closed-loop frontend (ncq_depth) does not support "
                    "the preempt scheduler"
                )
        if schedule is None and gc_mode == "prepass":
            schedule = FTL.build_ftl_schedule(trace, cfg)

        fm = None
        if cfg.faults is not None:
            # Fresh model per run: per-die fault substreams seeded
            # (run seed, salt, die), separate from the attempt streams.
            fm = FaultModel(cfg.faults, cfg, self.cond, self.policy,
                            self.seed, self)

        online = None
        if schedule is not None:
            # Prepass FTL path: host and GC page-ops, attempts and AR² tR
            # scale resolved per block wear.
            P = schedule.n_ops
            read_like = schedule.kind <= FTL.OP_GC_READ
            host_read = schedule.kind == FTL.OP_READ
            attempts_np = np.ones(P, np.int64)
            attempts_np[read_like] = self._sample_attempts(
                schedule.ptype[read_like], schedule.wear_pec[read_like])
            tr_np = (self._tr_base[schedule.ptype]
                     * self._tr_scales_for_schedule(schedule, read_like))
            n_requests = schedule.n_requests
            op_lpn = (schedule.lpn.tolist()
                      if closed and schedule.lpn is not None else None)
            if fm is not None:
                bufs, op_lpn = self._plan(
                    fm, schedule.admission_lists, attempts_np, tr_np,
                    schedule.ptype, schedule.wear_pec.tolist(), op_lpn)
            elif batched:
                bufs = make_buffers(*schedule.admission_arrays,
                                    attempts_np, tr_np)
            else:
                bufs = make_buffers(*schedule.admission_lists,
                                    attempts_np.tolist(), tr_np.tolist())
        elif gc_mode == "online":
            # Online FTL path: host ops only in the admission stream;
            # attempt counts and tR resolve at admission, GC injects live.
            ex = (expansion if expansion is not None
                  else expand_trace(trace, cfg))
            P = ex.n_ops
            adm_t, op_rid, op_die, op_ch, op_read = ex.admission_lists
            # The buffers grow (GC injection): copy the shared views.
            bufs = make_buffers(
                adm_t, list(op_rid), list(op_die), list(op_ch),
                list(op_read), [False] * P, [tprog] * P,
                [1] * P, [0.0] * P,
            )
            if fm is not None:
                bufs.xa = [0] * P
                bufs.xtr = [0.0] * P
            online = OnlineGC(cfg, ex, self, faults=fm)
            n_requests = ex.n_requests
            op_lpn = None
        else:
            ex = (expansion if expansion is not None
                  else expand_trace(trace, cfg))
            P = ex.n_ops
            host_read = ex.is_read
            attempts_np = np.ones(P, np.int64)
            attempts_np[host_read] = self._sample_attempts(
                ex.ptype[host_read])
            tr_np = (self._tr_base * self.tr_scale)[ex.ptype]
            n_requests = ex.n_requests
            op_lpn = ex.page_id.tolist() if closed else None
            if fm is not None:
                bufs, op_lpn = self._plan(
                    fm, ex.admission_lists + ([False] * P, [tprog] * P),
                    attempts_np, tr_np, ex.ptype, None, op_lpn)
            elif batched:
                # Batched runs read whole columns: hand them numpy views.
                adm_a, rid_a, die_a, ch_a, read_a = ex.admission_arrays
                bufs = make_buffers(adm_a, rid_a, die_a, ch_a, read_a,
                                    np.zeros(P, bool),
                                    np.full(P, tprog, np.float64),
                                    attempts_np, tr_np)
            else:
                adm_t, op_rid, op_die, op_ch, op_read = ex.admission_lists
                bufs = make_buffers(adm_t, op_rid, op_die, op_ch, op_read,
                                    [False] * P,    # no erases without FTL
                                    [tprog] * P,    # write-like ops: tPROG
                                    attempts_np.tolist(), tr_np.tolist())
        # Online reads draw their attempts at admission: the engine counts.
        total_read_pages = total_attempts = 0
        if online is None:
            total_read_pages = int(host_read.sum())
            total_attempts = int(attempts_np[host_read].sum())
        return _PreparedRun(
            trace=trace, validate=validate, pipelined=self.policy.pipelined,
            sched_policy=sched_policy, closed=closed, batched=batched,
            engine_selected=engine_selected, engine_reason=engine_reason,
            bufs=bufs, n_requests=n_requests,
            total_read_pages=total_read_pages,
            total_attempts=total_attempts,
            schedule=schedule, online=online, fm=fm, op_lpn=op_lpn,
        )

    @staticmethod
    def _plan(fm, admission, attempts_np, tr_np, ptype, wear, op_lpn):
        """Run the fault pre-pass over an admission stream (the
        ``admission_lists`` 7-tuple) and build the engine buffers from
        its plan, recovery tails included.  Returns ``(bufs, op_lpn)``:
        the plan's per-op logical pages when ``op_lpn`` was given."""
        plan = plan_faults(fm, *admission, attempts_np.tolist(),
                           tr_np.tolist(), ptype.tolist(), wear,
                           lpn=op_lpn)
        bufs = make_buffers(plan.arrival, plan.rid, plan.die, plan.ch,
                            plan.read, plan.erase, plan.dur, plan.a,
                            plan.tr)
        bufs.xa, bufs.xtr = plan.xa, plan.xtr
        return bufs, plan.lpn

    def run(
        self,
        trace: RequestTrace,
        expansion: Optional[TraceExpansion] = None,
        schedule: Optional[FTL.FTLSchedule] = None,
        validate: bool = False,
        shard: bool = False,
        trace_phases: bool = False,
    ) -> SimStats:
        """Simulate one trace.

        ``expansion`` (in-place and online-GC runs) or ``schedule`` (an
        :class:`~repro_torch.flashsim.ftl.FTLSchedule`, prepass-GC runs)
        may be shared across the mechanisms of a sweep; under prepass GC
        without a schedule the run builds one, and under online GC an
        :class:`~repro_torch.flashsim.gc_online.OnlineGC` controller rides in
        the event core.  ``cfg.faults`` draws the recovery ladder: planned
        before the run (in place, prepass) or at the simulated instants
        (online).  ``shard=True`` runs the array event core as one loop
        per channel with a deterministic merge — bit-identical to the
        monolithic default.
        ``validate=True`` turns on the array engine's work-conservation
        checks (test instrumentation).

        With ``cfg.ncq_depth`` set the run goes through the closed-loop
        frontend (:func:`repro_torch.flashsim.engine.run_closed_loop`):
        NCQ-gated admission, the optional write-back cache
        (``cfg.host_cache``), an explicit channel transfer phase.  It
        takes prepass GC and faults but not online GC or the preempt
        scheduler; ``shard=`` is
        ignored (the NCQ couples channels through the shared slot pool).
        ``trace_phases=True`` (closed loop only) records each op's
        sense, transfer, program and erase intervals in
        ``self.last_phases``.
        """
        cfg = self.cfg
        prep = self._prepare(trace, expansion=expansion, schedule=schedule,
                             validate=validate)
        if prep.closed:
            from repro_torch.flashsim.engine import run_closed_loop

            cache = None
            if cfg.host_cache is not None:
                from repro_torch.flashsim.hostcache import WriteCache

                cache = WriteCache(cfg.host_cache)
            res = run_closed_loop(
                cfg, prep.pipelined, prep.sched_policy, prep.bufs,
                prep.n_requests, trace.arrival_us.tolist(),
                trace.is_read.tolist(), cfg.ncq_depth, op_lpn=prep.op_lpn,
                cache=cache, validate=validate, trace_phases=trace_phases,
            )
        elif prep.batched:
            from repro_torch.flashsim.engine_batched import (
                run_event_core_batched)

            res = run_event_core_batched(
                cfg, prep.pipelined, prep.sched_policy, prep.bufs,
                prep.n_requests, online=prep.online, validate=validate,
                device=self.device)
        else:
            res = run_event_core(cfg, prep.pipelined,
                                 prep.sched_policy, prep.bufs,
                                 prep.n_requests, online=prep.online,
                                 validate=validate, shard=shard)
        return self._finalize(prep, res)

    def _finalize(self, prep: "_PreparedRun", res) -> SimStats:
        """Assemble :class:`SimStats` from one engine result."""
        cfg = self.cfg
        trace = prep.trace
        online, fm = prep.online, prep.fm
        total_attempts = prep.total_attempts
        total_read_pages = prep.total_read_pages
        closed_kw = {}
        if prep.closed:
            gc_suspensions = 0
            # Reads a cache hit served never reached the device.
            total_attempts = res.attempts_issued
            total_read_pages = res.read_pages_issued
            self.last_phases = res.phases
        else:
            gc_suspensions = res.gc_suspensions
            self.last_phases = None
            if online is not None:
                # Online reads draw their attempts at admission.
                total_attempts = res.online_attempts
                total_read_pages = res.online_read_pages
        self.events_processed = res.n_events
        self.last_gc_suspensions = gc_suspensions
        self.last_die_busy_us = float(sum(res.die_tot))

        req_done_at = np.asarray(res.req_done)
        self.last_req_done_us = req_done_at
        response = req_done_at - trace.arrival_us + cfg.host_overhead_us
        read_resp = response[trace.is_read]
        span = float(req_done_at.max())
        if prep.closed:
            # Closed-loop span: the makespan of everything the device did
            # (flush programs and GC can outlive the last host completion).
            span = max(span, max(res.die_busy), max(res.ch_busy))
            admit_at = np.asarray(res.req_admit)
            wait = admit_at - trace.arrival_us
            device = req_done_at - admit_at
            read_dev = device[trace.is_read]
            closed_kw = dict(
                hostq_wait_mean_us=float(wait.mean()),
                hostq_wait_p99_us=float(np.percentile(wait, 99)),
                device_mean_us=float(device.mean()),
                read_device_p99_us=(
                    float(np.percentile(read_dev, 99))
                    if read_dev.size else 0.0
                ),
                throughput_iops=prep.n_requests / span * 1e6,
                max_inflight=res.max_inflight,
                cache_hit_reads=res.full_hit_reads,
                cache_hit_pages=res.hit_pages,
                cache_absorbed_writes=res.absorbed_writes,
                cache_flush_pages=res.flush_pages,
                cache_stalled_writes=res.stalled_writes,
                die_sense_util=sum(res.die_sense_tot) / (span * cfg.n_dies),
            )
        gc_kw = {}
        if prep.schedule is not None or online is not None:
            # GC traffic can outlive the last host completion (an erase
            # triggered by the final write holds its die past it), so the
            # utilization span extends to the last die or channel release;
            # in-place runs keep the host-completion span.
            span = max(span, max(res.die_busy), max(res.ch_busy))
            fs = (prep.schedule.stats if prep.schedule is not None
                  else online.stats())
            gc_kw = dict(
                wa=fs.write_amplification,
                gc_invocations=fs.gc_invocations,
                gc_page_reads=fs.gc_page_reads,
                gc_page_progs=fs.gc_page_progs,
                blocks_erased=fs.blocks_erased,
                gc_suspensions=gc_suspensions,
                write_stalls=online.write_stalls if online is not None else 0,
            )
        elif gc_suspensions:
            gc_kw = dict(gc_suspensions=gc_suspensions)
        fault_kw = {}
        if fm is not None:
            oc = fm.outcome
            rec_p99 = 0.0
            if oc.affected_rids:
                idx = np.fromiter(oc.affected_rids, np.int64,
                                  len(oc.affected_rids))
                rec_p99 = float(np.percentile(response[idx], 99))
            fault_kw = dict(
                mispredicted_reads=oc.mispredicted_reads,
                rescued_reads=oc.rescued_reads,
                parity_rebuilds=oc.parity_rebuilds,
                rebuild_reads=oc.rebuild_reads,
                retired_blocks=oc.retired_blocks,
                program_fails=oc.program_fails,
                erase_fails=oc.erase_fails,
                unrecoverable=oc.unrecoverable,
                recovery_p99_us=rec_p99,
            )
        # One percentile call shares the partition pass across the three
        # quantiles (bit-identical to three separate calls).
        p50, p95, p99 = _pctl(response, (50.0, 95.0, 99.0))
        return SimStats(
            mean_us=float(response.mean()),
            p50_us=float(p50),
            p95_us=float(p95),
            p99_us=float(p99),
            read_mean_us=float(read_resp.mean()) if read_resp.size else 0.0,
            n_requests=prep.n_requests,
            mean_read_attempts=(
                total_attempts / total_read_pages if total_read_pages
                else 0.0
            ),
            die_util=sum(res.die_tot) / (span * cfg.n_dies),
            channel_util=sum(res.ch_tot) / (span * cfg.n_channels),
            read_p99_us=(
                float(_pctl(read_resp, (99.0,))[0]) if read_resp.size
                else 0.0
            ),
            fast_path_events=getattr(res, "fast_path_events", 0),
            engine_selected=prep.engine_selected,
            engine_fallback_reason=prep.engine_reason,
            fused_cells=getattr(res, "fused_cells", 0),
            **gc_kw,
            **fault_kw,
            **closed_kw,
        )


@dataclasses.dataclass
class _PreparedRun:
    """Inputs of one engine dispatch, held between :meth:`SSDSim._prepare`
    and :meth:`SSDSim._finalize` so the fused sweep path can batch many
    cells into one kernel launch."""

    trace: RequestTrace
    validate: bool
    pipelined: bool
    sched_policy: object
    closed: bool
    batched: bool
    engine_selected: str
    engine_reason: str
    bufs: object
    n_requests: int
    total_read_pages: int
    total_attempts: int
    schedule: Optional[FTL.FTLSchedule] = None
    #: The online-GC controller of an online run.
    online: Optional[OnlineGC] = None
    #: The fault model of a run with ``cfg.faults``.
    fm: Optional[FaultModel] = None
    #: Logical page of every op (closed runs only: the host cache's key).
    op_lpn: Optional[list] = None


def _run_prepared_fused(items, device):
    """Run many prepared batched-eligible cells in fused kernel launches.

    ``items``: sequence of ``(sim, prep)`` pairs, every cell resolved to
    the batched engine.  Bit-identical to calling ``sim.run(...)`` per
    cell (the cell-axis law).  Returns one :class:`SimStats` per item,
    in order.
    """
    from repro_torch.flashsim.engine_batched import (FusedRun,
                                                     run_event_cores_fused)

    runs = [FusedRun(sim.cfg, prep.pipelined, prep.sched_policy,
                     prep.bufs, prep.n_requests) for sim, prep in items]
    res_list = run_event_cores_fused(runs, device=device)
    return [sim._finalize(prep, res)
            for (sim, prep), res in zip(items, res_list)]


# -- run API ---------------------------------------------------------------


def _with_knobs(cfg: SSDConfig, scheduler: Optional[str],
                gc: Optional[str], faults=None,
                ncq_depth: Optional[int] = None,
                host_cache=None) -> SSDConfig:
    """Overlay the run-API knobs onto a config: ``scheduler`` picks the
    die-queue policy; ``gc`` is ``"off"`` (the in-place FTL-less
    device), ``"prepass"`` or ``"online"`` (both imply
    ``gc.enabled=True``); ``faults`` attaches a
    :class:`~repro_torch.flashsim.config.FaultConfig`; ``ncq_depth`` /
    ``host_cache`` switch on the closed-loop frontend
    (:class:`~repro_torch.flashsim.config.HostCacheConfig`).  None leaves
    the config untouched.
    """
    if scheduler is not None:
        cfg = dataclasses.replace(cfg, scheduler=scheduler)
    if faults is not None:
        cfg = dataclasses.replace(cfg, faults=faults)
    if ncq_depth is not None:
        cfg = dataclasses.replace(cfg, ncq_depth=ncq_depth)
    if host_cache is not None:
        cfg = dataclasses.replace(cfg, host_cache=host_cache)
    if gc is not None:
        if gc == "off":
            gcc = dataclasses.replace(cfg.gc, enabled=False)
        elif gc in ("prepass", "online"):
            gcc = dataclasses.replace(cfg.gc, enabled=True, mode=gc)
        else:
            raise ValueError(
                f"gc knob must be 'off', 'prepass' or 'online', got {gc!r}"
            )
        cfg = dataclasses.replace(cfg, gc=gcc)
    return cfg


def _fuse_resolved(cfg, engine: str, fuse: Optional[bool],
                   device) -> bool:
    """Whether a sweep over ``cfg`` takes the fused batched path: fusion
    enabled (``fuse=``, default ``cfg.fuse``) *and* the config resolves
    inside the batched matrix.  ``engine="batched"`` with an ineligible
    config returns False so the sequential loop raises the exact
    :class:`BatchedUnsupported` the non-fused path would."""
    if engine not in ("batched", "auto"):
        return False
    if not (cfg.fuse if fuse is None else fuse):
        return False
    from repro_torch.flashsim.engine_batched import resolve_engine

    return resolve_engine(cfg, device=device)[0] == "batched"


def _shared_views(trace, cfg):
    """(expansion, schedule) pair shared by every mechanism of a sweep:
    the schedule is the FTL pre-pass's under prepass GC, else ``None``
    (online GC advances the FTL inside each run, so only the expansion
    is shared there)."""
    expansion = expand_trace(trace, cfg)
    if not cfg.gc.enabled or cfg.gc.mode != "prepass":
        return expansion, None
    return expansion, FTL.build_ftl_schedule(trace, cfg, expansion=expansion)


def _make_sim(cfg, condition, mechanism, seed, engine, device):
    """The simulator of one cell: :class:`SSDSim` for the array, batched
    and auto engines (``"batched"`` raises ``BatchedUnsupported`` outside
    its matrix), the seed closure engine for ``"reference"``."""
    if engine in ("array", "batched", "auto"):
        return SSDSim(cfg, condition, RetryPolicy(mechanism), seed=seed,
                      engine=engine, device=device)
    if engine == "reference":
        if cfg.faults is not None:
            raise NotImplementedError(
                "faults require the array engine (the reference engine "
                "predates the fault-injection subsystem)"
            )
        if cfg.ncq_depth is not None:
            raise NotImplementedError(
                "the closed-loop frontend (ncq_depth) requires the array "
                "engine"
            )
        from repro_torch.flashsim.engine_ref import SSDSimRef

        return SSDSimRef(cfg, condition, RetryPolicy(mechanism), seed=seed,
                         device=device)
    raise ValueError(
        f"unknown engine {engine!r} (use 'array', 'batched', 'auto' or "
        f"'reference')"
    )


def _reject_reference_shard(engine: str) -> None:
    if engine == "reference":
        raise NotImplementedError(
            "shard=True requires the array engine (the reference engine "
            "predates the sharded event core)"
        )


def simulate(
    workload: WorkloadLike,
    condition: OperatingCondition,
    mechanism: str,
    seed: int = 0,
    cfg: SSDConfig = DEFAULT_SSD,
    n_requests: Optional[int] = None,
    trace: Optional[RequestTrace] = None,
    engine: Optional[str] = None,
    scheduler: Optional[str] = None,
    gc: Optional[str] = None,
    shard: bool = False,
    faults=None,
    ncq_depth: Optional[int] = None,
    host_cache=None,
    validate: bool = False,
    device=None,
) -> SimStats:
    """One (workload, condition, mechanism) cell.

    ``workload`` is a synthetic :class:`Workload` profile, a trace-source
    spec string, or any :class:`TraceSource`; ``trace=`` reuses a
    pre-generated trace.  ``scheduler=`` overlays the die-queue policy.
    ``engine="batched"`` runs every channel as one lane of the
    shard-core kernel — bit-identical to the array engine on its matrix
    (fcfs / host_prio / host_prio_aged[:bound], no validate) and raising
    :class:`~repro_torch.flashsim.engine_batched.BatchedUnsupported`
    elsewhere; ``engine="auto"`` picks it when eligible;
    ``engine="reference"`` runs the seed closure engine (fcfs only).
    ``shard=True`` runs the array engine as one loop per channel (a
    no-op for batched; the reference engine rejects it).  ``gc=
    "prepass"`` or ``"online"`` runs the trace through the FTL
    (:mod:`repro_torch.flashsim.ftl`, :mod:`repro_torch.flashsim.
    gc_online`) and the stats carry WA and GC counters; the reference
    engine rejects both.  ``device`` places the characterization and the
    batched kernel (default: the CUDA card).  ``ncq_depth=`` switches
    on the closed-loop frontend (bounded NCQ admission, explicit channel
    transfer phase; array engine only: ``"batched"`` raises
    :class:`~repro_torch.flashsim.engine_batched.BatchedUnsupported` and
    ``"auto"`` records the fallback); ``host_cache=`` adds the host
    write-back cache.  ``faults=`` attaches a
    :class:`~repro_torch.flashsim.config.FaultConfig`
    (:mod:`repro_torch.flashsim.faults`; the array engine only, as for
    online GC: ``"batched"`` raises and ``"auto"`` records why).
    """
    engine = cfg.engine if engine is None else engine
    cfg = _with_knobs(cfg, scheduler, gc, faults, ncq_depth, host_cache)
    if trace is None:
        trace = resolve_trace(workload, seed=seed, n_requests=n_requests)
    sim = _make_sim(cfg, condition, mechanism, seed + 7, engine, device)
    if shard:
        _reject_reference_shard(engine)
        return sim.run(trace, shard=True, validate=validate)
    return sim.run(trace, validate=validate)


def compare_mechanisms(
    workload: WorkloadLike,
    condition: OperatingCondition,
    mechanisms=("baseline", "sota", "pr2", "ar2", "pr2ar2", "sota+pr2ar2"),
    seed: int = 0,
    cfg: SSDConfig = DEFAULT_SSD,
    n_requests: Optional[int] = None,
    engine: Optional[str] = None,
    scheduler: Optional[str] = None,
    gc: Optional[str] = None,
    shard: bool = False,
    workers: int = 1,
    faults=None,
    ncq_depth: Optional[int] = None,
    host_cache=None,
    fuse: Optional[bool] = None,
    device=None,
) -> Dict[str, SimStats]:
    """All mechanisms over ONE shared trace (resolved once, expanded once;
    under prepass GC its FTL schedule is built once and shared too, so
    every mechanism sees the same GC traffic and block wear; online GC
    advances the FTL inside each run, so its GC timing answers each
    mechanism's latencies).

    ``fuse=`` (default ``cfg.fuse``): when the config resolves inside
    the batched matrix, the mechanisms' op tables are stacked along the
    kernel's lane axis and launched together — results bit-identical
    to the sequential batched runs.  ``workers > 1`` fans the mechanisms
    over a forked pool (:func:`repro_torch.flashsim.runtime.run_compare`,
    results identical to the inline run) for the array, batched and auto
    engines; ``engine="reference"`` runs its mechanisms one by one.
    ``ncq_depth=`` / ``host_cache=`` run every mechanism through the
    closed-loop frontend on the array interpreter (never fused).
    """
    engine = cfg.engine if engine is None else engine
    cfg = _with_knobs(cfg, scheduler, gc, faults, ncq_depth, host_cache)
    if workers > 1 and engine in ("array", "batched", "auto"):
        from repro_torch.flashsim.runtime import run_compare

        return run_compare(workload, condition, mechanisms, seed, cfg,
                           n_requests, None, None, shard, workers,
                           engine=engine, fuse=fuse, device=device)
    dev = resolve_device(device)
    trace = resolve_trace(workload, seed=seed, n_requests=n_requests)
    if engine == "reference":
        return {
            m: simulate(workload, condition, m, seed, cfg, trace=trace,
                        engine=engine, shard=shard, device=dev)
            for m in mechanisms
        }
    expansion, schedule = _shared_views(trace, cfg)
    sims = [_make_sim(cfg, condition, m, seed + 7, engine, dev)
            for m in mechanisms]
    if _fuse_resolved(cfg, engine, fuse, dev) and len(sims) > 1:
        items = [(sim, sim._prepare(trace, expansion=expansion,
                                    schedule=schedule))
                 for sim in sims]
        return dict(zip(mechanisms, _run_prepared_fused(items, dev)))
    return {m: sim.run(trace, expansion=expansion, schedule=schedule,
                       shard=shard)
            for m, sim in zip(mechanisms, sims)}


def simulate_batch(
    workload: WorkloadLike,
    conditions: Iterable[OperatingCondition],
    mechanisms: Sequence[str] = (
        "baseline", "sota", "pr2", "ar2", "pr2ar2", "sota+pr2ar2",
    ),
    seeds: Sequence[int] = (0,),
    cfg: SSDConfig = DEFAULT_SSD,
    n_requests: Optional[int] = None,
    engine: Optional[str] = None,
    scheduler: Optional[str] = None,
    gc: Optional[str] = None,
    shard: bool = False,
    workers: int = 1,
    faults=None,
    journal=None,
    ncq_depth: Optional[int] = None,
    host_cache=None,
    fuse: Optional[bool] = None,
    device=None,
) -> Dict[Tuple[str, OperatingCondition, int], SimStats]:
    """Sweep (mechanism x condition x seed) cells for one workload.

    Each seed's trace is generated and expanded once (and, under prepass
    GC, run through the FTL once) and shared by every (mechanism,
    condition) cell; characterization tables are memoized
    per condition.  ``fuse=`` stacks every cell of the grid on the
    kernel's lane axis when the config is batched-eligible (results
    identical for any fusion decision).  ``workers > 1`` schedules seed
    groups across a process pool and ``journal=`` names a checkpoint
    file a re-run resumes from
    (:func:`repro_torch.flashsim.runtime.run_sweep`); cell values and
    dict order are identical for every worker count.  ``ncq_depth=`` /
    ``host_cache=`` run every cell through the closed-loop frontend on
    the array interpreter (never fused).  Returns
    ``{(mechanism, condition, seed): SimStats}`` in seed-major order.
    """
    engine = cfg.engine if engine is None else engine
    if shard:
        _reject_reference_shard(engine)
    cfg = _with_knobs(cfg, scheduler, gc, faults, ncq_depth, host_cache)
    if workers > 1 or journal is not None:
        from repro_torch.flashsim.runtime import run_sweep

        # Seed-group cells re-enter this function with workers=1 inside
        # each worker, reference engine included.
        return run_sweep(workload, conditions, mechanisms, seeds, cfg,
                         n_requests, engine, None, None, shard, workers,
                         journal=journal, fuse=fuse, device=device)
    dev = resolve_device(device)
    conditions = tuple(conditions)
    seeds = tuple(seeds)
    fused = (_fuse_resolved(cfg, engine, fuse, dev)
             and len(conditions) * len(mechanisms) * len(seeds) > 1)
    keys, items = [], []
    out: Dict[Tuple[str, OperatingCondition, int], SimStats] = {}
    for s in seeds:
        trace = resolve_trace(workload, seed=s, n_requests=n_requests)
        expansion = schedule = None
        if engine != "reference":
            expansion, schedule = _shared_views(trace, cfg)
        for cond in conditions:
            for m in mechanisms:
                sim = _make_sim(cfg, cond, m, s + 7, engine, dev)
                if fused:
                    keys.append((m, cond, s))
                    items.append((sim, sim._prepare(
                        trace, expansion=expansion, schedule=schedule)))
                elif expansion is None:
                    out[(m, cond, s)] = sim.run(trace)
                else:
                    out[(m, cond, s)] = sim.run(trace, expansion=expansion,
                                                schedule=schedule,
                                                shard=shard)
    if fused:
        return dict(zip(keys, _run_prepared_fused(items, dev)))
    return out
