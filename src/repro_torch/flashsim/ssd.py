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

Every run API takes ``device=`` and runs on the CUDA card unless told
otherwise; ``device=None`` without CUDA raises.  Knobs whose subsystems
are not ported yet (the FTL and GC, faults, the closed-loop frontend
and host cache, the reference engine, the sweep runtime's workers and
journal) raise :class:`NotImplementedError` naming their ROADMAP item.
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
from repro_torch.flashsim.engine import make_buffers, run_event_core
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

#: Deferred parts of this slice, as numbered in ROADMAP.md.
_DEFERRED = {
    "ncq_depth": "D1 (closed-loop frontend: run_closed_loop)",
    "faults": "D2 (faults)",
    "gc=online": "D3 (gc_online)",
    "gc=prepass": "D4 (ftl and prepass GC)",
    "host_cache": "D5 (hostcache)",
    "engine=reference": "D6 (engine_ref)",
    "workers": "D7 (runtime: workers and journal)",
    "journal": "D7 (runtime: workers and journal)",
}


def _unported(knob: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob} is not ported to repro_torch yet "
        f"(ROADMAP.md, deferred item {_DEFERRED[knob]})")


def _check_ported(cfg: SSDConfig) -> None:
    """Raise for a configuration that needs an unported subsystem."""
    if cfg.ncq_depth is not None:
        raise _unported("ncq_depth")
    if cfg.host_cache is not None:
        raise _unported("host_cache")
    if cfg.faults is not None:
        raise _unported("faults")
    if cfg.gc.enabled:
        raise _unported(f"gc={cfg.gc.mode}")


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
    compare field by field.  The GC, fault and closed-loop blocks keep
    their defaults here (the in-place, failure-free, open-loop facts):
    the FTL, the fault model and the closed-loop frontend are not ported
    yet.  ``gc_suspensions`` counts preempt-scheduler suspend events.
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
        if engine == "reference":
            raise _unported("engine=reference")
        if engine not in ("array", "batched", "auto"):
            raise ValueError(
                f"SSDSim engine must be 'array', 'batched' or 'auto', got "
                f"{engine!r}"
            )
        _check_ported(cfg)
        if engine == "batched":
            from repro_torch.flashsim.engine_batched import (
                check_batched_config)

            check_batched_config(cfg)
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
        # Unscaled per-page-type tR.
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

    def _sample_attempts(self, page_types: np.ndarray) -> np.ndarray:
        """Inverse-CDF attempt counts for a batch of page-type indices,
        one uniform per read page in admission order."""
        u = self.rng.random(page_types.shape)
        out = np.empty(page_types.shape, np.int64)
        for i, pt in enumerate(PAGE_TYPE_ORDER):
            m = page_types == i
            if m.any():
                out[m] = np.searchsorted(self._attempt_cdfs[pt], u[m])
        return np.maximum(out, 1)

    # -- run orchestration ---------------------------------------------------

    def _prepare(
        self,
        trace: RequestTrace,
        expansion: Optional[TraceExpansion] = None,
        validate: bool = False,
    ) -> "_PreparedRun":
        """Everything :meth:`run` does before the engine dispatch.

        Resolves the engine, samples the attempt schedule (consuming
        ``self.rng`` in admission order) and builds the admission
        buffers.  Split out so the fused sweep path can prepare many
        cells, run them in one kernel launch, and :meth:`_finalize` each.
        """
        cfg, t = self.cfg, self.cfg.timing
        tprog = t.tprog_us
        engine_selected = self.engine
        engine_reason = ""
        if self.engine == "auto":
            from repro_torch.flashsim.engine_batched import resolve_engine

            engine_selected, engine_reason = resolve_engine(cfg, validate)
        batched = engine_selected == "batched"

        ex = expansion if expansion is not None else expand_trace(trace, cfg)
        P = ex.n_ops
        read_mask = ex.is_read
        attempts_np = np.ones(P, np.int64)
        attempts_np[read_mask] = self._sample_attempts(ex.ptype[read_mask])
        tr_np = (self._tr_base * self.tr_scale)[ex.ptype]
        if batched:
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
        return _PreparedRun(
            trace=trace, validate=validate, pipelined=self.policy.pipelined,
            sched_policy=get_scheduler(cfg.scheduler), batched=batched,
            engine_selected=engine_selected, engine_reason=engine_reason,
            bufs=bufs, n_requests=ex.n_requests,
            total_read_pages=int(read_mask.sum()),
            total_attempts=int(attempts_np[read_mask].sum()),
        )

    def run(
        self,
        trace: RequestTrace,
        expansion: Optional[TraceExpansion] = None,
        validate: bool = False,
        shard: bool = False,
    ) -> SimStats:
        """Simulate one trace.

        ``expansion`` may be shared across the mechanisms of a sweep.
        ``shard=True`` runs the array event core as one loop per channel
        with a deterministic merge — bit-identical to the monolithic
        default.  ``validate=True`` turns on the array engine's
        work-conservation checks (test instrumentation).
        """
        prep = self._prepare(trace, expansion=expansion, validate=validate)
        if prep.batched:
            from repro_torch.flashsim.engine_batched import (
                run_event_core_batched)

            res = run_event_core_batched(
                self.cfg, prep.pipelined, prep.sched_policy, prep.bufs,
                prep.n_requests, validate=validate, device=self.device)
        else:
            res = run_event_core(self.cfg, prep.pipelined,
                                 prep.sched_policy, prep.bufs,
                                 prep.n_requests, validate=validate,
                                 shard=shard)
        return self._finalize(prep, res)

    def _finalize(self, prep: "_PreparedRun", res) -> SimStats:
        """Assemble :class:`SimStats` from one engine result."""
        cfg = self.cfg
        trace = prep.trace
        self.events_processed = res.n_events
        self.last_gc_suspensions = res.gc_suspensions
        self.last_die_busy_us = float(sum(res.die_tot))

        req_done_at = np.asarray(res.req_done)
        self.last_req_done_us = req_done_at
        response = req_done_at - trace.arrival_us + cfg.host_overhead_us
        read_resp = response[trace.is_read]
        span = float(req_done_at.max())
        gc_kw = {}
        if res.gc_suspensions:
            gc_kw = dict(gc_suspensions=res.gc_suspensions)
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
                prep.total_attempts / prep.total_read_pages
                if prep.total_read_pages else 0.0
            ),
            die_util=sum(res.die_tot) / (span * cfg.n_dies),
            channel_util=sum(res.ch_tot) / (span * cfg.n_channels),
            read_p99_us=(
                float(_pctl(read_resp, (99.0,))[0]) if read_resp.size
                else 0.0
            ),
            fast_path_events=res.fast_path_events,
            engine_selected=prep.engine_selected,
            engine_fallback_reason=prep.engine_reason,
            fused_cells=res.fused_cells,
            **gc_kw,
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
    batched: bool
    engine_selected: str
    engine_reason: str
    bufs: object
    n_requests: int
    total_read_pages: int
    total_attempts: int


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
    """Overlay the run-API knobs onto a config and reject the unported
    ones: ``scheduler`` picks the die-queue policy; ``gc="off"`` keeps
    the in-place FTL-less device; ``faults``, ``ncq_depth``,
    ``host_cache`` and any enabled GC raise :class:`NotImplementedError`
    (:class:`SSDSim` rejects the same fields set on the config itself).
    """
    if scheduler is not None:
        cfg = dataclasses.replace(cfg, scheduler=scheduler)
    if faults is not None:
        raise _unported("faults")
    if ncq_depth is not None:
        raise _unported("ncq_depth")
    if host_cache is not None:
        raise _unported("host_cache")
    if gc is not None:
        if gc == "off":
            cfg = dataclasses.replace(
                cfg, gc=dataclasses.replace(cfg.gc, enabled=False))
        elif gc in ("prepass", "online"):
            raise _unported(f"gc={gc}")
        else:
            raise ValueError(
                f"gc knob must be 'off', 'prepass' or 'online', got {gc!r}"
            )
    return cfg


def _fuse_resolved(cfg, engine: str, fuse: Optional[bool]) -> bool:
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

    return resolve_engine(cfg)[0] == "batched"


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
    elsewhere; ``engine="auto"`` picks it when eligible.  ``shard=True``
    runs the array engine as one loop per channel (a no-op for
    batched).  ``device`` places the characterization and the batched
    kernel (default: the CUDA card).  ``gc`` other than ``"off"``,
    ``faults``, ``ncq_depth`` and ``host_cache`` are not ported yet and
    raise :class:`NotImplementedError`.
    """
    engine = cfg.engine if engine is None else engine
    cfg = _with_knobs(cfg, scheduler, gc, faults, ncq_depth, host_cache)
    if trace is None:
        trace = resolve_trace(workload, seed=seed, n_requests=n_requests)
    sim = SSDSim(cfg, condition, RetryPolicy(mechanism), seed=seed + 7,
                 engine=engine, device=device)
    return sim.run(trace, shard=shard, validate=validate)


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
    """All mechanisms over ONE shared trace (resolved once, expanded once).

    ``fuse=`` (default ``cfg.fuse``): when the config resolves inside
    the batched matrix, the mechanisms' op tables are stacked along the
    kernel's lane axis and launched together — results bit-identical
    to the sequential batched runs.  ``workers > 1`` is not ported yet.
    """
    engine = cfg.engine if engine is None else engine
    if workers > 1:
        raise _unported("workers")
    cfg = _with_knobs(cfg, scheduler, gc, faults, ncq_depth, host_cache)
    dev = resolve_device(device)
    trace = resolve_trace(workload, seed=seed, n_requests=n_requests)
    expansion = expand_trace(trace, cfg)
    sims = [SSDSim(cfg, condition, RetryPolicy(m), seed=seed + 7,
                   engine=engine, device=dev) for m in mechanisms]
    if _fuse_resolved(cfg, engine, fuse) and len(sims) > 1:
        items = [(sim, sim._prepare(trace, expansion=expansion))
                 for sim in sims]
        return dict(zip(mechanisms, _run_prepared_fused(items, dev)))
    return {m: sim.run(trace, expansion=expansion, shard=shard)
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

    Each seed's trace is generated and expanded once and shared by every
    (mechanism, condition) cell; characterization tables are memoized
    per condition.  ``fuse=`` stacks every cell of the grid on the
    kernel's lane axis when the config is batched-eligible (results
    identical for any fusion decision).  ``workers > 1`` and
    ``journal=`` are not ported yet.  Returns
    ``{(mechanism, condition, seed): SimStats}`` in seed-major order.
    """
    engine = cfg.engine if engine is None else engine
    if workers > 1:
        raise _unported("workers")
    if journal is not None:
        raise _unported("journal")
    cfg = _with_knobs(cfg, scheduler, gc, faults, ncq_depth, host_cache)
    dev = resolve_device(device)
    conditions = tuple(conditions)
    seeds = tuple(seeds)
    fused = (_fuse_resolved(cfg, engine, fuse)
             and len(conditions) * len(mechanisms) * len(seeds) > 1)
    keys, items = [], []
    out: Dict[Tuple[str, OperatingCondition, int], SimStats] = {}
    for s in seeds:
        trace = resolve_trace(workload, seed=s, n_requests=n_requests)
        expansion = expand_trace(trace, cfg)
        for cond in conditions:
            for m in mechanisms:
                sim = SSDSim(cfg, cond, RetryPolicy(m), seed=s + 7,
                             engine=engine, device=dev)
                if fused:
                    keys.append((m, cond, s))
                    items.append((sim, sim._prepare(trace,
                                                    expansion=expansion)))
                else:
                    out[(m, cond, s)] = sim.run(trace, expansion=expansion,
                                                shard=shard)
    if fused:
        return dict(zip(keys, _run_prepared_fused(items, dev)))
    return out
