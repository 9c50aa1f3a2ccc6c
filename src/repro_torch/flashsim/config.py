"""SSD organization and simulation configuration (MQSim-analogue)."""

from __future__ import annotations

import dataclasses

from repro_torch.core.timing import DEFAULT_TIMING, TimingParams


@dataclasses.dataclass(frozen=True)
class GCConfig:
    """FTL / garbage-collection knobs (see :mod:`repro_torch.flashsim.ftl`).

    With ``enabled=False`` (the default) writes program in place and the
    simulator behaves exactly as before the FTL existed — bit-identical
    event streams, no mapping state.  With ``enabled=True`` host writes go
    through a page-mapping FTL: out-of-place programs, greedy garbage
    collection, and GC copy-back traffic injected into the event core as
    page-ops that contend with host reads on die/channel queues.
    """

    #: Master switch for the page-mapping FTL + garbage collection.
    enabled: bool = False
    #: GC trigger mode.  ``"prepass"`` (default): the deterministic
    #: admission-order pre-pass (:func:`repro_torch.flashsim.ftl.
    #: build_ftl_schedule`) — mapping exact, trigger instants approximated
    #: at write admission; the compatibility mode the equivalence suite
    #: pins.  ``"online"``: completion-time triggering (:mod:`repro_torch.
    #: flashsim.gc_online`) — pages allocate when the die takes the
    #: program, GC fires when the projected free-block pool crosses the
    #: watermark, and erased blocks return to the pool only when their
    #: erase *completes* on the simulated die.
    mode: str = "prepass"
    #: Online mode only: collect while (free + in-flight-erase) blocks per
    #: die <= this watermark.  None uses ``gc_threshold_blocks``.  Raise it
    #: to start reclaim earlier (fewer write stalls, more copy-back).
    watermark_blocks: int | None = None
    #: Over-provisioning: fraction of *physical* capacity held as spare
    #: (industry-typical 7% ~ 0.07).  Used when ``blocks_per_die`` is None
    #: (auto-sizing from the trace footprint); smaller OP -> earlier and
    #: heavier GC.
    op_ratio: float = 0.07
    #: Physical pages per erase block (pages).  Sim-scaled: real TLC
    #: erase blocks hold hundreds-to-thousands of pages, but with 64-way
    #: die parallelism and 10^4-request traces, small blocks let the FTL
    #: reach steady-state GC within a trace; the WA/contention dynamics
    #: are geometry-relative (utilization decides them, not block size).
    pages_per_block: int = 16
    #: Blocks per die; None auto-sizes from the trace's logical footprint
    #: so physical capacity = footprint / (1 - op_ratio).
    blocks_per_die: int | None = None
    #: GC runs while a die's free-block count is <= this (blocks).
    gc_threshold_blocks: int = 2
    #: Block erase latency charged to the die (us; TLC-class ~3 ms).
    t_erase_us: float = 3000.0
    #: P/E cycles a block accrues per erase.  1.0 is physical; larger
    #: values accelerate wear so short traces exercise per-block retry
    #: growth (the wear axis of Cai et al., arXiv:1706.08642).
    pec_per_erase: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.op_ratio < 1.0:
            raise ValueError(f"op_ratio must be in (0, 1), got {self.op_ratio}")
        if self.pages_per_block < 1:
            raise ValueError("pages_per_block must be >= 1")
        if self.gc_threshold_blocks < 1:
            raise ValueError("gc_threshold_blocks must be >= 1")
        if self.mode not in ("prepass", "online"):
            raise ValueError(
                f"GCConfig.mode must be 'prepass' or 'online', "
                f"got {self.mode!r}"
            )
        if self.watermark_blocks is not None and self.watermark_blocks < 1:
            raise ValueError("watermark_blocks must be >= 1 (or None)")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Device fault-injection knobs (see :mod:`repro_torch.flashsim.faults`).

    Attached via ``SSDConfig.faults`` (or the run APIs' ``faults=`` knob);
    ``None`` — the default everywhere — disables the whole failure path
    and keeps runs bit-identical to a fault-free build.  All injection is
    seeded and deterministic: draws come from per-die RNG substreams
    seeded ``(run seed, salt, die)``, separate from the attempt-sampling
    streams, so identical ``(seed, FaultConfig)`` produce identical
    failure sets under any ``shard=`` / ``workers=`` setting — and
    enabling faults never changes which retry-attempt counts are drawn.

    Probabilities default to *derived* values: the uncorrectable-read
    probability comes from :func:`repro_torch.core.ecc.page_fail_probability`
    at the block's wear-resolved condition, and the AR² misprediction
    probability from the mean final-step margin shaved by the reduced-tR
    sense.  Explicit ``*_prob`` overrides replace the derivation (fault-
    matrix sweeps); ``*_scale`` multiplies whichever is in effect.
    """

    #: Probability a read's *final* retry step is uncorrectable.  None
    #: derives it from the ECC page-failure model at the block's
    #: wear-resolved condition (effectively ~0 at paper-default margins).
    uncorrectable_prob: float | None = None
    #: Multiplier on the uncorrectable probability (derived or explicit).
    uncorrectable_scale: float = 1.0
    #: Probability an AR² reduced-tR read exceeds the shaved ECC margin
    #: and must re-read at nominal tR.  None derives it from the mean
    #: final-step margin at the reduced scale; only adaptive-tR policies
    #: sensing below scale 1.0 can mispredict.
    mispredict_prob: float | None = None
    #: Multiplier on the misprediction probability.
    mispredict_scale: float = 1.0
    #: Escalation re-reads (full-strength, nominal tR) attempted before
    #: the controller falls back to a superpage-parity rebuild.
    escalation_attempts: int = 4
    #: Rebuild an uncorrectable page from its superpage stripe peers
    #: (real reads on the other dies of the channel).  False counts the
    #: read as unrecoverable once escalation is exhausted.
    parity_rebuild: bool = True
    #: Retire the failing block after a parity rebuild (FTL relocates its
    #: valid pages; the block never returns to the free pool).
    retire_blocks: bool = True
    #: Fail-slow dies: ``((die, multiplier), ...)`` — the die's sense and
    #: program/erase durations are multiplied (>= 1.0).
    failslow_dies: tuple[tuple[int, float], ...] = ()
    #: Probability a host program fails and is retried (+tPROG latency).
    program_fail_prob: float = 0.0
    #: Probability an erase fails verification: the block is retired
    #: instead of returning to the free pool (online GC only).
    erase_fail_prob: float = 0.0
    #: Seed salt separating fault streams from attempt-sampling streams.
    salt: int = 0x5EED

    def __post_init__(self):
        for name in ("uncorrectable_prob", "mispredict_prob"):
            v = getattr(self, name)
            if v is not None and not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1] or None, got {v}")
        for name in ("program_fail_prob", "erase_fail_prob"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        for name in ("uncorrectable_scale", "mispredict_scale"):
            if getattr(self, name) < 0.0:
                raise ValueError(f"{name} must be >= 0, got "
                                 f"{getattr(self, name)}")
        if self.escalation_attempts < 1:
            raise ValueError("escalation_attempts must be >= 1")
        for d, m in self.failslow_dies:
            if d < 0:
                raise ValueError(f"failslow die id must be >= 0, got {d}")
            if m < 1.0:
                raise ValueError(
                    f"failslow multiplier must be >= 1.0 (fail-SLOW), got {m}"
                )


@dataclasses.dataclass(frozen=True)
class HostCacheConfig:
    """Host write-back cache knobs (see :mod:`repro_torch.flashsim.hostcache`).

    Only meaningful on the closed-loop path (``SSDConfig.ncq_depth`` set):
    writes that fit are absorbed into a host-side DRAM cache and complete
    at cache speed; their flash programs are issued later ("flushed") when
    the dirty watermark is crossed, entering the device through the normal
    scheduler/GC machinery as low-priority (non-host-read) programs.
    Reads that hit a dirty/flushing line are served from the cache.
    """

    #: Cache capacity in flash pages.  Occupancy counts every absorbed
    #: page-program until its flush completes on the die.
    capacity_pages: int = 4096
    #: Flushing starts when dirty (not-yet-issued) pages exceed
    #: ``flush_high * capacity_pages`` ...
    flush_high: float = 0.75
    #: ... and stops once they drop to ``flush_low * capacity_pages``.
    flush_low: float = 0.5
    #: Host-side service time (us) for a cache-absorbed write or a
    #: full-cache-hit read (DRAM access; no flash op, no tDMA).
    hit_us: float = 2.0
    #: Flush-order / eviction policy.  ``"fifo"`` (default) flushes
    #: cache lines in absorption order; ``"lru"`` flushes the least
    #: recently *used* line first — read hits and rewrites refresh a
    #: line's recency, so hot dirty lines stay cached longer and keep
    #: serving hits.  Write-amplification accounting is identical under
    #: both (every absorbed page flushes exactly once; only the order
    #: changes).
    eviction: str = "fifo"

    def __post_init__(self):
        if self.capacity_pages < 1:
            raise ValueError("capacity_pages must be >= 1")
        if not 0.0 < self.flush_low <= self.flush_high <= 1.0:
            raise ValueError(
                "need 0 < flush_low <= flush_high <= 1, got "
                f"low={self.flush_low} high={self.flush_high}"
            )
        if self.hit_us < 0.0:
            raise ValueError("hit_us must be >= 0")
        if self.eviction not in ("fifo", "lru"):
            raise ValueError(
                f"HostCacheConfig.eviction must be 'fifo' or 'lru', "
                f"got {self.eviction!r}"
            )


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """High-end NVMe SSD organization, matching the paper's MQSim setup.

    8 channels x 8 dies (64-way die parallelism), NV-DDR3-class channel
    bandwidth (folded into tDMA), one LDPC engine per channel.
    """

    #: Number of flash channels (each: one shared bus + one LDPC engine).
    n_channels: int = 8
    #: Dies per channel; total die parallelism = n_channels * dies_per_channel.
    dies_per_channel: int = 8
    #: LDPC decoders per channel (modeled as a fixed +tECC; see ssd.py).
    ecc_engines_per_channel: int = 1
    #: Physical page size (KiB); one page-op senses/transfers one page.
    page_kib: int = 16
    #: Host-interface constant overhead per request (us): NVMe submission/
    #: completion, FTL lookup.
    host_overhead_us: float = 8.0
    #: NAND operation latencies (tR / tDMA / tECC / tPROG, all us).
    timing: TimingParams = DEFAULT_TIMING
    #: FTL / garbage-collection configuration (disabled by default).
    gc: GCConfig = GCConfig()
    #: Die-queue scheduling policy (:mod:`repro_torch.flashsim.sched`):
    #: ``"fcfs"`` (strict arrival order — bit-identical to the original
    #: engine), ``"host_prio"`` (host reads jump GC/program ops),
    #: ``"host_prio_aged"`` (host_prio with a starvation bound — GC and
    #: program ops age to the front after ``:N`` bypassing host reads,
    #: e.g. ``"host_prio_aged:8"``), ``"tokens"`` (per-die read/write
    #: token budgets — up to ``r`` host reads then up to ``w`` other ops
    #: per contended round, e.g. ``"tokens:6,2"``), or ``"preempt"``
    #: (host_prio + read-suspend of in-flight GC ops).
    scheduler: str = "fcfs"
    #: Device fault model (:mod:`repro_torch.flashsim.faults`).  ``None`` (the
    #: default) disables fault injection entirely — no failure draws, no
    #: recovery traffic, bit-identical to a fault-free run.
    faults: FaultConfig | None = None
    #: Host NCQ depth for the CLOSED-LOOP frontend.  ``None`` (the
    #: default) keeps the simulator open-loop — every request admitted at
    #: its trace arrival time, bit-identical to all prior output.  An
    #: integer ``>= 1`` bounds the number of in-flight requests: arrivals
    #: wait in a host queue until a device slot frees, `SimStats` gains
    #: queue-wait vs device-time decomposition and throughput counters,
    #: and the engine runs the explicit sense/transfer channel model.
    ncq_depth: int | None = None
    #: Host write-back cache (closed-loop only; requires ``ncq_depth``).
    #: ``None`` sends every write straight to the device.
    host_cache: HostCacheConfig | None = None
    #: Event-core implementation the run APIs select when their
    #: ``engine=`` argument is left unset: ``"array"`` (the bit-pinned
    #: default interpreter), ``"batched"`` (all channel loops advance in
    #: lockstep inside one compiled kernel — bit-identical on its
    #: supported matrix, rejects everything else), ``"auto"`` (resolve
    #: per run: ``batched`` when the config is inside the batched
    #: matrix, else ``array`` — the choice and any fallback reason are
    #: recorded on ``SimStats.engine_selected`` /
    #: ``engine_fallback_reason``, never hidden), or ``"reference"``
    #: (the retired seed engine).  An explicit ``engine=`` on
    #: ``simulate``/``compare_mechanisms``/``simulate_batch`` overrides
    #: this.
    engine: str = "array"
    #: Fused sweep dispatch policy for the batched engine: when a sweep
    #: (``simulate_batch``/``compare_mechanisms``/``runtime.run_cells``)
    #: resolves a grid of cells inside the batched matrix, stack their
    #: op tables along the kernel's lane axis and launch each
    #: static-shape group once instead of dispatching per cell.  Cell
    #: results are bit-identical either way (the cell-axis law; see
    #: :mod:`repro_torch.flashsim.engine_batched`); ``False`` forces one
    #: dispatch per cell.  A ``fuse=`` argument on the sweep APIs
    #: overrides this.
    fuse: bool = True

    def __post_init__(self):
        if self.engine not in ("array", "batched", "auto", "reference"):
            raise ValueError(
                f"SSDConfig.engine must be 'array', 'batched', 'auto', "
                f"or 'reference', got {self.engine!r}"
            )
        if self.n_channels < 1 or self.dies_per_channel < 1:
            raise ValueError(
                f"SSDConfig needs >=1 channel and >=1 die per channel, got "
                f"{self.n_channels}x{self.dies_per_channel}"
            )
        if self.ncq_depth is not None and self.ncq_depth < 1:
            raise ValueError(
                f"ncq_depth must be >= 1 or None, got {self.ncq_depth}"
            )
        if self.host_cache is not None and self.ncq_depth is None:
            raise ValueError(
                "host_cache requires the closed-loop frontend: set "
                "ncq_depth as well"
            )
        from repro_torch.flashsim.sched import get_scheduler

        get_scheduler(self.scheduler)   # raises ValueError on unknown names

    @property
    def n_dies(self) -> int:
        return self.n_channels * self.dies_per_channel

    def channel_of(self, die):
        """Die -> channel mapping (interleaved).  Accepts int or ndarray —
        the single striping rule both simulator engines and the vectorized
        trace expansion share."""
        return die % self.n_channels


@dataclasses.dataclass(frozen=True)
class OperatingCondition:
    """Retention age + wear state the SSD is simulated under.

    Without an FTL this is a *device-global* condition.  With the FTL/GC
    layer enabled it is the **base** condition of the whole device, and
    blocks that garbage collection has erased resolve to a *per-block*
    condition via :meth:`with_wear` — their retry-attempt distributions
    are characterized at the block's higher effective P/E count.
    """

    #: Data retention age (days since program).
    retention_days: float = 90.0
    #: Program/erase cycles endured (device-wide baseline wear).
    pec: float = 0.0

    def with_wear(self, extra_pec: float) -> "OperatingCondition":
        """Per-block resolution: this condition plus block-local wear.

        ``extra_pec`` is the additional P/E cycles a specific block has
        accumulated (e.g. from GC erases) on top of the device baseline.
        Returns ``self`` unchanged for non-positive wear, so the common
        unworn path stays identical to the global-condition path.
        """
        if extra_pec <= 0:
            return self
        return dataclasses.replace(self, pec=self.pec + extra_pec)

    def label(self) -> str:
        if self.retention_days >= 30:
            age = f"{self.retention_days / 30:.0f}mo"
        else:
            age = f"{self.retention_days:.0f}d"
        return f"{age}/{self.pec:.0f}PEC"


DEFAULT_SSD = SSDConfig()
