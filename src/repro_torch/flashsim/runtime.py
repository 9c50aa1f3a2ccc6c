"""Parallel sweep runtime: grid cells scheduled across a process pool.

The reference package's sweep runtime, ported: a sweep's (mechanism x
condition x seed x trace) grid cells are scheduled across a process
pool with deterministic assembly, so a ``workers=4`` sweep returns
exactly what ``workers=1`` returns — byte-identical once serialized
(:func:`sweep_to_json`).  The run APIs of :mod:`repro_torch.flashsim.ssd`
delegate their ``workers=`` / ``journal=`` knobs here.

Scheduling unit
---------------
A :class:`Cell` is one schedulable unit.  ``kind="batch"`` cells are one
*seed group* of a ``simulate_batch`` grid, which keeps the single-seed
trace generation and page-op expansion shared across that group's
(mechanism x condition) cells inside one worker, and fuses the group's
batched cells into shard-core launches there.  ``simulate`` and
``compare`` cells wrap the corresponding run APIs.  A cell carries its
``device`` (``None`` is the CUDA card, as for every entry point); a
worker resolves it itself and raises without CUDA, never running a
card cell on the CPU.

Workers and the card
--------------------
A forked child of a parent that has initialized CUDA cannot use CUDA,
so the pool forks only for CPU cells in a parent that has not touched
CUDA (the reference's default, which keeps CPU sweeps cheap); any cell
on the card, or a CUDA-initialized parent, takes a ``spawn`` pool, and
each spawned worker opens its own CUDA context on the card.  Spawned
workers start with empty characterization memos, so the pool's
initializer hands every worker a snapshot of the parent's tables, taken
after :func:`prewarm_characterization`: workers never characterize
again and read bit for bit what the parent read, tables placed by
``load_tables`` included.  :func:`prewarm_batched` builds the shard
core's CUDA library in the parent, so workers load it instead of
running nvcc at once.  Force a start method with
``REPRO_SWEEP_START_METHOD`` (a forced ``fork`` with cells on the card
raises); force inline execution (no pool, e.g. on hosts without
working semaphores) with ``REPRO_SWEEP_INLINE=1``.

Determinism
-----------
Cell *results* never depend on the worker count — each cell runs the
identical code path a ``workers=1`` run executes — and cell *ordering*
is fixed by the caller's input order (:func:`run_cells` returns results
positionally; :func:`run_sweep` assembles its dict in canonical
seed -> condition -> mechanism order).  :func:`sweep_to_json` is the
canonical serialization: byte-identical output for any ``workers``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
import platform
import threading
import time
from concurrent.futures import (
    FIRST_COMPLETED,
    BrokenExecutor,
    ProcessPoolExecutor,
    wait,
)
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import characterize as CH
from repro_torch.device import resolve_device
from repro_torch.flashsim.config import (
    DEFAULT_SSD,
    FaultConfig,
    OperatingCondition,
    SSDConfig,
)

__all__ = [
    "Cell",
    "host_fingerprint",
    "prewarm_batched",
    "prewarm_characterization",
    "run_cells",
    "run_compare",
    "run_sweep",
    "sweep_cell_key",
    "sweep_to_json",
]


@dataclasses.dataclass(frozen=True)
class Cell:
    """One schedulable unit of a sweep.

    ``kind`` selects the run API the worker executes:

      * ``"simulate"`` — one (mechanism, condition, seed) run; returns
        a :class:`repro_torch.flashsim.ssd.SimStats`;
      * ``"compare"`` — all ``mechanisms`` over one shared trace
        (:func:`repro_torch.flashsim.ssd.compare_mechanisms`); returns
        ``{mechanism: SimStats}``;
      * ``"batch"`` — one full single-seed ``simulate_batch`` group
        (shares trace and expansion across mechanisms x conditions);
        returns the batch dict.

    Cells must be picklable: ``workload`` is a
    :class:`~repro_torch.flashsim.workloads.Workload`, a registry spec
    string, or a picklable :class:`~repro_torch.flashsim.workloads.
    TraceSource`.  ``device`` is ``None`` (the CUDA card) or a device
    name; a ``torch.device`` is stored as its name.
    """

    kind: str
    workload: object
    conditions: Tuple[OperatingCondition, ...]
    mechanisms: Tuple[str, ...]
    seed: int
    cfg: SSDConfig = DEFAULT_SSD
    n_requests: Optional[int] = None
    #: ``None`` defers to ``cfg.engine`` (itself ``"array"`` by default).
    engine: Optional[str] = None
    scheduler: Optional[str] = None
    gc: Optional[str] = None
    shard: bool = False
    faults: Optional[FaultConfig] = None
    ncq_depth: Optional[int] = None
    host_cache: object = None
    #: Fused-sweep dispatch policy (``None`` defers to ``cfg.fuse``).
    #: ``"batch"``/``"compare"`` cells fuse their inner grid inside
    #: ``simulate_batch``/``compare_mechanisms``; eligible
    #: ``"simulate"`` cells sharing a device are additionally fused
    #: *across cells* by :func:`run_cells` (same results either way —
    #: the fused path is bit-identical).
    fuse: Optional[bool] = None
    #: Where the cell runs: ``None`` is the CUDA card.
    device: Optional[str] = None

    def __post_init__(self):
        if self.kind not in ("simulate", "compare", "batch"):
            raise ValueError(
                f"Cell.kind must be 'simulate', 'compare' or 'batch', "
                f"got {self.kind!r}"
            )
        if self.kind == "simulate" and len(self.mechanisms) != 1:
            raise ValueError(
                "a 'simulate' cell takes exactly one mechanism, got "
                f"{self.mechanisms!r}"
            )
        if self.kind != "batch" and len(self.conditions) != 1:
            raise ValueError(
                f"a {self.kind!r} cell takes exactly one condition, got "
                f"{len(self.conditions)}"
            )
        if self.device is not None:
            object.__setattr__(self, "device",
                               str(torch.device(self.device)))


def _engine(cell: Cell) -> str:
    return cell.engine if cell.engine is not None else cell.cfg.engine


def _on_card(cell: Cell) -> bool:
    """Whether the cell runs on a CUDA device (``None`` is the card)."""
    return cell.device is None or torch.device(cell.device).type != "cpu"


def _run_cell(cell: Cell):
    """Execute one cell (in a worker or inline) — pure in its argument."""
    from repro_torch.flashsim.ssd import (
        compare_mechanisms,
        simulate,
        simulate_batch,
    )

    if cell.kind == "simulate":
        return simulate(
            cell.workload, cell.conditions[0], cell.mechanisms[0],
            seed=cell.seed, cfg=cell.cfg, n_requests=cell.n_requests,
            engine=cell.engine, scheduler=cell.scheduler, gc=cell.gc,
            shard=cell.shard, faults=cell.faults,
            ncq_depth=cell.ncq_depth, host_cache=cell.host_cache,
            device=cell.device,
        )
    if cell.kind == "compare":
        return compare_mechanisms(
            cell.workload, cell.conditions[0], mechanisms=cell.mechanisms,
            seed=cell.seed, cfg=cell.cfg, n_requests=cell.n_requests,
            engine=cell.engine, scheduler=cell.scheduler, gc=cell.gc,
            shard=cell.shard, faults=cell.faults,
            ncq_depth=cell.ncq_depth, host_cache=cell.host_cache,
            fuse=cell.fuse, device=cell.device,
        )
    return simulate_batch(
        cell.workload, cell.conditions, mechanisms=cell.mechanisms,
        seeds=(cell.seed,), cfg=cell.cfg, n_requests=cell.n_requests,
        engine=cell.engine, scheduler=cell.scheduler, gc=cell.gc,
        shard=cell.shard, faults=cell.faults,
        ncq_depth=cell.ncq_depth, host_cache=cell.host_cache,
        fuse=cell.fuse, device=cell.device,
    )


def _fusable_cfg(cell: Cell):
    """Knob-overlaid config when a ``"simulate"`` cell is eligible for
    cross-cell fusion, else ``None``.

    Eligibility mirrors the inline sweeps: the cell's engine must be
    ``"batched"``/``"auto"``, fusion enabled (``cell.fuse``, defaulting
    to ``cfg.fuse``), and the overlaid config must resolve inside the
    batched matrix on the cell's device.  Ineligible cells run
    :func:`_run_cell` alone — ``"auto"`` fallbacks record their reason
    on ``SimStats`` exactly as without fusion, and explicit-``"batched"``
    misconfigurations raise the same :class:`BatchedUnsupported` they
    always did.
    """
    if cell.kind != "simulate":
        return None
    from repro_torch.flashsim.ssd import _fuse_resolved, _with_knobs

    cfg = _with_knobs(cell.cfg, cell.scheduler, cell.gc, cell.faults,
                      cell.ncq_depth, cell.host_cache)
    return cfg if _fuse_resolved(cfg, _engine(cell), cell.fuse,
                                 cell.device) else None


def _fusion_groups(items: Sequence[Tuple[int, Cell]]):
    """Partition (index, cell) pairs into host-prep groups and leftovers.

    A group is a maximal set of eligible ``"simulate"`` cells sharing
    the *resolved trace object* (cached and frozen, so equal
    (workload, seed, n_requests) cells resolve to one identity), the
    knob-overlaid config (compared by ``repr`` — configs carry an
    unhashable timing dict) and the device; the shared trace and
    expansion are then computed once per group.  The grouping only
    decides host-side sharing — the kernel dispatch fuses *across*
    groups of one device (:func:`_run_items_fused`).  Returns
    ``(groups, singles)`` where each group is
    ``(trace, cfg, device, [(index, cell), ...])``.
    """
    from repro_torch.flashsim.ssd import resolve_trace

    buckets: Dict[Tuple, list] = {}
    singles: List[Tuple[int, Cell]] = []
    for i, cell in items:
        cfg = _fusable_cfg(cell)
        if cfg is None:
            singles.append((i, cell))
            continue
        trace = resolve_trace(cell.workload, seed=cell.seed,
                              n_requests=cell.n_requests)
        # Trace identity, not content hash: resolved traces are cached
        # frozen objects, so equal (workload, seed, n) cells share one.
        # Grouping only decides host-prep sharing — results are
        # grouping-invariant (the cell-axis law), so a cache miss can
        # only cost sharing, never correctness.
        key = (id(trace), repr(cfg), cell.device)
        buckets.setdefault(key, []).append((i, cell, cfg, trace))
    groups = []
    for members in buckets.values():
        _, cell, cfg, trace = members[0]
        groups.append((trace, cfg, cell.device,
                       [(i, c) for i, c, _, _ in members]))
    return groups, singles


def _run_items_fused(items: Sequence[Tuple[int, Cell]]) -> Dict[int, object]:
    """Results for the fused-eligible subset of ``items`` (cross-cell
    fusion); cells not covered by the returned dict run per-cell.

    Host prep is shared per trace/config group, then every prepared
    cell of one device goes through ONE fused engine call — cells of
    different workloads and seeds stack along the kernel's cell axis
    whenever their static shapes line up.  A device with a lone eligible
    cell runs it per-cell (nothing to amortize).  A batch that turns out
    unsupported at dispatch time (a guard the pre-filter should make
    unreachable) falls back to per-cell runs of the same cells on the
    same device by simply not contributing results.
    """
    from repro_torch.flashsim.engine_batched import BatchedUnsupported
    from repro_torch.flashsim.ssd import (_make_sim, _run_prepared_fused,
                                          _shared_views)

    groups, _ = _fusion_groups(items)
    by_device: Dict[Optional[str], list] = {}
    for group in groups:
        by_device.setdefault(group[2], []).append(group)
    out: Dict[int, object] = {}
    for device, dev_groups in by_device.items():
        if sum(len(members) for *_, members in dev_groups) < 2:
            continue
        dev = resolve_device(device)
        prepped: List[Tuple[int, object, object]] = []
        for trace, cfg, _, members in dev_groups:
            expansion, schedule = _shared_views(trace, cfg)
            for i, cell in members:
                sim = _make_sim(cfg, cell.conditions[0], cell.mechanisms[0],
                                cell.seed + 7, _engine(cell), dev)
                prepped.append((i, sim, sim._prepare(
                    trace, expansion=expansion, schedule=schedule)))
        try:
            stats = _run_prepared_fused([(s, p) for _, s, p in prepped],
                                        dev)
        except BatchedUnsupported:
            continue
        out.update({i: st for (i, _, _), st in zip(prepped, stats)})
    return out


def _worn_bins(cell: Cell, schedules: Optional[Dict] = None
               ) -> Dict[OperatingCondition, Tuple[float, ...]]:
    """P/E bins the reads of ``cell``'s worn blocks are sampled from, by
    condition.

    A read (host or GC copy-back) of a block that GC erased before is
    sampled at the condition's P/E count plus the block's added wear,
    snapped up to the characterization grid (``SSDSim._cdf_for``).
    Under prepass GC the wear comes from the cell's FTL schedule, host
    code with no RNG, built here as the run builds it; ``schedules``
    shares it between cells of one trace and config, and only the bins
    its reads reach are listed.  Online GC wears blocks at simulated
    instants no pre-pass can see, so every bin a worn block can snap to
    is listed: each grid P/E count above the condition's (the top bin
    when none is).  No bins with GC off or at ``pec_per_erase`` 0.
    """
    gc = cell.cfg.gc
    mode = cell.gc if cell.gc is not None else (
        gc.mode if gc.enabled else "off")
    if mode == "off" or gc.pec_per_erase <= 0.0:
        return {cond: () for cond in cell.conditions}
    if mode == "online":
        return {cond: tuple(float(p) for p in CH.PEC_GRID if p > cond.pec)
                or (float(CH.PEC_GRID[-1]),)
                for cond in cell.conditions}
    from repro_torch.flashsim import ftl as FTL
    from repro_torch.flashsim.ssd import _with_knobs, resolve_trace

    trace = resolve_trace(cell.workload, seed=cell.seed,
                          n_requests=cell.n_requests)
    cfg = _with_knobs(cell.cfg, None, cell.gc)
    schedules = {} if schedules is None else schedules
    key = (id(trace), repr(cfg))
    if key not in schedules:
        s = FTL.build_ftl_schedule(trace, cfg)
        worn = (s.kind <= FTL.OP_GC_READ) & (s.wear_pec > 0.0)
        # The trace rides along so its id stays unique while keyed.
        schedules[key] = (trace, np.unique(s.wear_pec[worn]))
    wear = schedules[key][1]
    return {cond: tuple(sorted({CH.snap_pec(cond.with_wear(float(w)).pec)
                                for w in wear}))
            for cond in cell.conditions}


def prewarm_characterization(cells: Iterable[Cell]) -> int:
    """Build every (condition, mechanism) table the cells will touch, on
    each cell's device: the worn-block bins of GC cells included
    (:func:`_worn_bins`: the bins a prepass schedule's reads reach, every
    bin above the condition under online GC), and for cells with
    ``faults`` the condition record of each bin the fault model derives
    its rates from (the condition's own bin and the worn ones).

    Called in the parent before the pool is created; the pool hands the
    resulting memos to every worker (see the module docstring), so a
    worker never characterizes.  Returns the number of distinct
    (condition, mechanism) pairs touched, as the reference counts them.
    """
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.flashsim.ssd import PAGE_TYPE_ORDER, SSDSim

    seen = set()
    worn = set()
    schedules: Dict = {}
    for cell in cells:
        bins = _worn_bins(cell, schedules)
        for cond in cell.conditions:
            if cell.faults is not None or cell.cfg.faults is not None:
                for pec in {CH.snap_pec(cond.pec), *bins[cond]}:
                    CH.characterize_condition(cond.retention_days, pec,
                                              device=cell.device)
            for mech in cell.mechanisms:
                sim = None
                if (cond, mech) not in seen:
                    seen.add((cond, mech))
                    sim = SSDSim(cell.cfg, cond, RetryPolicy(mech),
                                 device=cell.device)
                for pec in bins[cond]:
                    if (cond, mech, pec, cell.device) in worn:
                        continue
                    worn.add((cond, mech, pec, cell.device))
                    sim = sim or SSDSim(cell.cfg, cond, RetryPolicy(mech),
                                        device=cell.device)
                    for pt in PAGE_TYPE_ORDER:
                        sim._bin_cdf(pt, pec)
    return len(seen)


def _batched_sigs(cells: Iterable[Cell]):
    """Distinct shard-core signatures the cells will (or may) run, as
    the reference counts them.

    A cell contributes when its engine is ``"batched"`` or ``"auto"``
    *and* its knob-overlaid config resolves inside the batched matrix on
    its device (auto cells that fall back contribute nothing).
    Signature = (lane count, local die count, pipelined, scheduler
    lowering mode).  Fusion-enabled cells additionally contribute their
    *fused* lane counts under the CPU chunking rule: a batch/compare
    cell's inner grid at ``min(C, cap) * n_channels`` lanes per
    pipelined class, and fusable simulate cells sharing a (workload,
    n_requests, config) proxy key as one cross-cell chunk.  The CUDA
    kernel compiles no variant per signature (one library serves them
    all); the count is what :func:`prewarm_batched` reports.
    """
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.flashsim.engine_batched import (_fuse_cell_cap,
                                                     dies_per_lane,
                                                     resolve_engine)
    from repro_torch.flashsim.sched import get_scheduler
    from repro_torch.flashsim.ssd import _with_knobs

    sigs = set()
    cross: Dict[Tuple, Tuple[int, int, int]] = {}
    for cell in cells:
        if _engine(cell) not in ("batched", "auto"):
            continue
        cfg = _with_knobs(cell.cfg, cell.scheduler, cell.gc, cell.faults,
                          cell.ncq_depth, cell.host_cache)
        if resolve_engine(cfg, device=cell.device)[0] != "batched":
            continue
        mode, _ = get_scheduler(cfg.scheduler).ring_lowering
        n_ch = cfg.n_channels
        n_dies_local = dies_per_lane(cfg)
        for mech in cell.mechanisms:
            sigs.add((n_ch, n_dies_local, RetryPolicy(mech).pipelined, mode))
        if not (cfg.fuse if cell.fuse is None else cell.fuse):
            continue
        if cell.kind in ("batch", "compare"):
            # Inner-grid fusion: one dispatch per pipelined class, cell
            # axis = conditions x same-class mechanisms.
            for pipe in (False, True):
                n_mech = sum(1 for m in cell.mechanisms
                             if RetryPolicy(m).pipelined == pipe)
                grid = len(cell.conditions) * n_mech
                if grid > 1:
                    grid = min(grid, _fuse_cell_cap(n_ch))
                    sigs.add((grid * n_ch, n_dies_local, pipe, mode))
        else:
            # Cross-cell fusion stacks simulate cells whenever their
            # static kernel shapes line up; the (workload, n_requests,
            # config) proxy is seed-blind, so it avoids resolving traces.
            pipe = RetryPolicy(cell.mechanisms[0]).pipelined
            key = (repr(cell.workload), cell.n_requests,
                   repr(cfg), pipe, mode)
            count, _, _ = cross.get(key, (0, 0, 0))
            cross[key] = (count + 1, n_ch, n_dies_local)
    for (_, _, _, pipe, mode), (count, n_ch, n_dl) in cross.items():
        if count > 1:
            count = min(count, _fuse_cell_cap(n_ch))
            sigs.add((count * n_ch, n_dl, pipe, mode))
    return sigs


def prewarm_batched(cells: Iterable[Cell]) -> int:
    """Build and load the shard core's CUDA library before the pool
    starts, when a batched cell runs on the card.

    The kernel is one library (``kernels/fcfs_core/csrc/fcfs_core.cu``)
    for every signature, built with nvcc at first use; building it in
    the parent means every spawned worker loads the finished ``.so``
    instead of all of them running nvcc at once.  CPU cells warm
    nothing.  Returns the number of signatures :func:`_batched_sigs`
    counts (0 when no cell may run the batched engine).
    """
    cells = list(cells)
    sigs = _batched_sigs(cells)
    if sigs and any(map(_on_card, cells)):
        from repro_torch.kernels.fcfs_core import ops

        ops._lib()
    return len(sigs)


def _mp_context(cells: Iterable[Cell] = ()):
    """Pool start method: fork for CPU cells, spawn for the card.

    A forked child of a parent that has initialized CUDA cannot use
    CUDA, so any cell on the card — or a parent where
    ``torch.cuda.is_initialized()`` — takes ``spawn``.  Fork stays the
    default for CPU cells in a parent that has not touched CUDA (cheap
    workers that inherit the parent's caches).
    ``REPRO_SWEEP_START_METHOD`` overrides both, except that forcing
    ``fork`` with cells on the card raises :class:`ValueError` (their
    workers would break, and the retry loop would quietly finish the
    sweep inline).
    """
    card = any(_on_card(c) for c in cells)
    method = os.environ.get("REPRO_SWEEP_START_METHOD")
    if method == "fork" and card:
        raise ValueError(
            "REPRO_SWEEP_START_METHOD=fork with cells on a CUDA device: a "
            "forked worker cannot use CUDA; use spawn, or run the cells "
            "on device='cpu'"
        )
    if not method:
        methods = multiprocessing.get_all_start_methods()
        if card or torch.cuda.is_initialized():
            method = "spawn"
        else:
            method = "fork" if "fork" in methods else None
    return multiprocessing.get_context(method)


def _inline_forced() -> bool:
    return os.environ.get("REPRO_SWEEP_INLINE", "0") == "1"


def _init_worker(tables) -> None:
    """Pool initializer: the parent's characterization tables, and one
    intra-op thread.  The pool is the parallelism, and a forked child of
    a parent whose OpenMP pool has run hangs in its first parallel
    region."""
    torch.set_num_threads(1)
    CH.restore_tables(tables)


# -- checkpoint journal ----------------------------------------------------


def _encode_result(r):
    """Cell result -> JSON-safe journal record (floats repr-round-trip)."""
    from repro_torch.flashsim.ssd import SimStats

    if isinstance(r, SimStats):
        return {"t": "stats", "v": dataclasses.asdict(r)}
    if isinstance(r, dict):
        if all(isinstance(k, str) for k in r):       # compare: {mech: stats}
            return {"t": "mechs",
                    "v": {m: dataclasses.asdict(s) for m, s in r.items()}}
        return {"t": "cells",                        # batch: {(m, cond, s): stats}
                "v": [[m, cond.retention_days, cond.pec, s,
                       dataclasses.asdict(st)]
                      for (m, cond, s), st in r.items()]}
    raise TypeError(f"cell result of type {type(r).__name__} cannot be "
                    f"journaled")


def _stats_from_journal(d):
    """Rebuild a SimStats from a journal record, dropping keys this
    build's SimStats does not have (defaults fill in missing ones)."""
    from repro_torch.flashsim.ssd import SimStats

    known = {f.name for f in dataclasses.fields(SimStats)}
    return SimStats(**{k: v for k, v in d.items() if k in known})


def _decode_result(e):
    t, v = e["t"], e["v"]
    if t == "stats":
        return _stats_from_journal(v)
    if t == "mechs":
        return {m: _stats_from_journal(d) for m, d in v.items()}
    return {
        (m, OperatingCondition(ret, pec), s): _stats_from_journal(d)
        for m, ret, pec, s, d in v
    }


class _Journal:
    """Append-only JSONL checkpoint of completed cells.

    Line 0 is a header carrying the *run key* — a hash over the cell
    list's reprs — so a journal can only ever resume the exact sweep
    that wrote it; any other cell list starts the file over.  Each
    subsequent line records one completed cell ``{"i": index, "r":
    encoded result}``, flushed as it lands, so a run killed mid-sweep
    loses at most the in-flight cells.  JSON floats round-trip exactly
    through ``repr``, so a resumed sweep's :func:`sweep_to_json` is
    byte-identical to an uninterrupted run's.  A torn trailing line
    (killed mid-append) is ignored.
    """

    def __init__(self, path, cells: Sequence[Cell]):
        self.path = os.fspath(path)
        self.key = hashlib.sha256(
            "\n".join(repr(c) for c in cells).encode()
        ).hexdigest()
        self.done: Dict[int, object] = {}
        try:
            with open(self.path) as f:
                lines = f.read().splitlines()
        except OSError:
            lines = []
        resumable = False
        if lines:
            try:
                resumable = json.loads(lines[0]).get("run") == self.key
            except ValueError:
                resumable = False
        if resumable:
            for ln in lines[1:]:
                try:
                    ent = json.loads(ln)
                    self.done[int(ent["i"])] = _decode_result(ent["r"])
                except (ValueError, KeyError, TypeError):
                    break                      # torn tail: drop it
            self._f = open(self.path, "a")
        else:
            self._f = open(self.path, "w")
            self._f.write(json.dumps({"run": self.key}) + "\n")
            self._f.flush()

    def record(self, i: int, result) -> None:
        self._f.write(
            json.dumps({"i": i, "r": _encode_result(result)}) + "\n"
        )
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# Oversubscription factor for chunked submission: pending cells are
# grouped into ~workers * _CHUNK_OVERSUB tasks, so one pickled round
# trip carries several small cells while still leaving enough tasks per
# worker for load balancing.
_CHUNK_OVERSUB = 4


def _chunk_pending(pending: Dict[int, Cell],
                   workers: int) -> List[List[Tuple[int, Cell]]]:
    items = sorted(pending.items())
    n_tasks = workers * _CHUNK_OVERSUB
    size = max(1, -(-len(items) // n_tasks))
    return [items[k:k + size] for k in range(0, len(items), size)]


def _run_cell_chunk(items: List[Tuple[int, Cell]]):
    """Worker entry: run a chunk of (index, cell) pairs in order.

    Fusable ``"simulate"`` cells that landed in the same chunk run as
    fused kernel dispatches (:func:`_run_items_fused`); the rest run
    per-cell.  Bit-identical either way, so chunking policy never
    changes results.
    """
    fused = _run_items_fused(items)
    return [(i, fused[i] if i in fused else _run_cell(c))
            for i, c in items]


def _finish_inline(results: List, pending: Dict[int, Cell],
                   jr: Optional[_Journal]) -> List:
    """Run the leftover cells inline (in index order), journaling each.

    Like the chunked worker path, fusable ``"simulate"`` cells run as
    fused dispatches first; journal records are still written in index
    order, so resume semantics are unchanged.
    """
    fused = _run_items_fused(sorted(pending.items()))
    for i in sorted(pending):
        r = fused[i] if i in fused else _run_cell(pending[i])
        results[i] = r
        if jr is not None:
            jr.record(i, r)
    return results


def run_cells(cells: Sequence[Cell], workers: int = 1,
              prewarm: bool = True, journal=None,
              cell_timeout: Optional[float] = None,
              max_retries: int = 2, backoff_s: float = 0.1) -> List:
    """Execute ``cells``; results are returned in input order.

    ``workers <= 1`` runs inline (no pool, no pickling — the exact
    ``workers=1`` code path).  Larger counts fan cells out over a
    process pool (:func:`_mp_context` picks fork or spawn) in *chunks*
    of several cells per task; results are still assembled
    positionally, so the output is independent of completion order,
    worker count, and chunking.

    Self-healing: pool-*infrastructure* failures never cost completed
    work.  Results are harvested per chunk as futures finish, so when
    workers die (``BrokenExecutor`` — an OOM-killed or SIGKILLed child)
    only the genuinely unfinished cells are retried — on a fresh pool,
    up to ``max_retries`` times with exponential backoff
    (``backoff_s * 2**attempt``), then inline as the last resort.
    ``cell_timeout`` (seconds) bounds the wait for *progress*: if no
    chunk completes within it, the pool is declared stalled and
    abandoned and the remainder is retried the same way.  An exception
    raised *by a cell itself* propagates unchanged — it would fail
    inline too, so retrying would only duplicate the work.

    ``journal`` (a path) checkpoints every completed cell to an
    append-only JSONL file keyed by the cell list: a killed sweep
    re-run with the same cells and journal skips the recorded cells and
    returns byte-identical results (:class:`_Journal`).
    """
    cells = list(cells)
    jr = _Journal(journal, cells) if journal is not None else None
    try:
        return _run_pending(cells, workers, prewarm, jr, cell_timeout,
                            max_retries, backoff_s)
    finally:
        if jr is not None:
            jr.close()


def _run_pending(cells, workers, prewarm, jr, cell_timeout, max_retries,
                 backoff_s) -> List:
    results: List = [None] * len(cells)
    pending: Dict[int, Cell] = {}
    for i, c in enumerate(cells):
        if jr is not None and i in jr.done:
            results[i] = jr.done[i]
        else:
            pending[i] = c
    if not pending:
        return results
    workers = min(int(workers), len(pending))
    if workers <= 1 or _inline_forced():
        return _finish_inline(results, pending, jr)
    ctx = _mp_context(pending.values())
    if prewarm:
        prewarm_characterization(pending.values())
        prewarm_batched(pending.values())
    tables = CH.tables_snapshot()
    attempt = 0
    while True:
        try:
            pool = ProcessPoolExecutor(
                max_workers=min(workers, len(pending)), mp_context=ctx,
                initializer=_init_worker, initargs=(tables,))
        except (OSError, PermissionError):
            # Semaphores unavailable on this host: no pool at all.
            break
        stalled = False
        try:
            futures = {pool.submit(_run_cell_chunk, ch): [i for i, _ in ch]
                       for ch in _chunk_pending(pending, workers)}
            not_done = set(futures)
            while not_done:
                done, not_done = wait(not_done, timeout=cell_timeout,
                                      return_when=FIRST_COMPLETED)
                if not done:
                    stalled = True        # no progress within cell_timeout
                    break
                for fut in done:
                    try:
                        chunk_results = fut.result()
                    except BrokenExecutor:
                        # This future's worker died; siblings that DID
                        # complete still carry their results — keep
                        # harvesting, never discard finished work.
                        stalled = True
                        continue
                    for i, r in chunk_results:
                        results[i] = r
                        del pending[i]
                        if jr is not None:
                            jr.record(i, r)
        except BrokenExecutor:
            stalled = True
        except BaseException:
            pool.shutdown(wait=False, cancel_futures=True)
            raise
        # A stalled pool may hold a hung worker: abandon it without
        # waiting (its processes drain in the background).
        pool.shutdown(wait=not stalled, cancel_futures=True)
        if not pending:
            return results
        attempt += 1
        if attempt > max_retries:
            break
        time.sleep(backoff_s * (2 ** (attempt - 1)))
    return _finish_inline(results, pending, jr)


def run_sweep(
    workload,
    conditions: Iterable[OperatingCondition],
    mechanisms: Sequence[str],
    seeds: Sequence[int],
    cfg: SSDConfig = DEFAULT_SSD,
    n_requests: Optional[int] = None,
    engine: str = "array",
    scheduler: Optional[str] = None,
    gc: Optional[str] = None,
    shard: bool = False,
    workers: int = 1,
    faults: Optional[FaultConfig] = None,
    journal=None,
    ncq_depth: Optional[int] = None,
    host_cache=None,
    fuse: Optional[bool] = None,
    device=None,
) -> Dict[Tuple[str, OperatingCondition, int], "object"]:
    """``simulate_batch`` semantics with seed groups fanned over workers.

    One :class:`Cell` per seed keeps each group's trace and expansion
    shared inside its worker, exactly like the inline sweep.  The result
    dict is assembled in the canonical seed -> condition -> mechanism
    order regardless of worker count, so iteration order — and
    :func:`sweep_to_json` output — is byte-stable.  ``journal=`` names a
    checkpoint file: completed seed groups are recorded as they finish
    and a killed sweep re-run with the same arguments resumes from it
    byte-identically (:func:`run_cells`).  ``fuse=`` overrides
    ``cfg.fuse`` per cell.  ``device`` places every cell (default: the
    CUDA card).
    """
    conditions = tuple(conditions)
    mechanisms = tuple(mechanisms)
    seeds = tuple(seeds)
    cells = [
        Cell("batch", workload, conditions, mechanisms, s, cfg, n_requests,
             engine, scheduler, gc, shard, faults=faults,
             ncq_depth=ncq_depth, host_cache=host_cache, fuse=fuse,
             device=device)
        for s in seeds
    ]
    groups = run_cells(cells, workers=workers, journal=journal)
    out: Dict[Tuple[str, OperatingCondition, int], object] = {}
    for s, group in zip(seeds, groups):
        for cond in conditions:
            for mech in mechanisms:
                out[(mech, cond, s)] = group[(mech, cond, s)]
    return out


# -- compare_mechanisms fan-out -------------------------------------------
#
# Mechanisms of one compare share the trace and the expansion.  Shipping
# those to workers by pickle would cost more than it saves, so the
# parallel path forks: the parent builds the simulators (characterized,
# numpy tables only) and the shared views into _COMPARE_PAYLOAD, forks
# the pool, and each task runs one simulator on the host.  A forked
# child must not touch CUDA, so a compare whose cells launch the kernel
# on the card runs inline, as does any compare without fork —
# correctness never depends on the pool.  _COMPARE_LOCK serializes the
# payload's lifetime so concurrent calls from different threads cannot
# fork a pool against each other's views.

_COMPARE_PAYLOAD = None
_COMPARE_LOCK = threading.Lock()


def _run_compare_mech(index: int):
    trace, expansion, schedule, sims, shard = _COMPARE_PAYLOAD
    return sims[index].run(trace, expansion=expansion, schedule=schedule,
                           shard=shard)


def run_compare(
    workload,
    condition: OperatingCondition,
    mechanisms: Sequence[str],
    seed: int,
    cfg: SSDConfig,
    n_requests: Optional[int],
    scheduler: Optional[str],
    gc: Optional[str],
    shard: bool,
    workers: int,
    engine: str = "array",
    fuse: Optional[bool] = None,
    device=None,
) -> Dict[str, "object"]:
    """Parallel ``compare_mechanisms``: one forked worker per mechanism.

    Results match ``compare_mechanisms(..., workers=1)`` exactly, in the
    caller's mechanism order.  The workers run the host interpreter (or
    the batched core's CPU version); a compare that launches the kernel
    on the card — and a fusable batched compare (``fuse=``, default
    ``cfg.fuse``), whose one fused launch beats per-mechanism workers —
    runs in-process through the inline run API, on the same device and
    engine, as does any compare without the ``fork`` start method or
    with a pool that fails.
    """
    global _COMPARE_PAYLOAD
    from repro_torch.flashsim import ssd
    from repro_torch.flashsim.engine_batched import resolve_engine

    mechanisms = tuple(mechanisms)
    dev = resolve_device(device)
    cfg = ssd._with_knobs(cfg, scheduler, gc)
    fused = ssd._fuse_resolved(cfg, engine, fuse, dev) and len(mechanisms) > 1
    kernel_on_card = (dev.type != "cpu" and engine in ("batched", "auto")
                      and resolve_engine(cfg, device=dev)[0] == "batched")
    method = os.environ.get("REPRO_SWEEP_START_METHOD") or (
        "fork" if "fork" in multiprocessing.get_all_start_methods() else None)
    if (fused or kernel_on_card or workers <= 1 or len(mechanisms) <= 1
            or _inline_forced() or method != "fork"):
        return ssd.compare_mechanisms(
            workload, condition, mechanisms=mechanisms, seed=seed, cfg=cfg,
            n_requests=n_requests, engine=engine, shard=shard, fuse=fuse,
            device=dev,
        )
    trace = ssd.resolve_trace(workload, seed=seed, n_requests=n_requests)
    expansion, schedule = ssd._shared_views(trace, cfg)
    # Materialize the lazy list views now so forked children share them.
    expansion.admission_lists
    if schedule is not None:
        schedule.admission_lists
    prewarm_characterization([Cell("compare", workload, (condition,),
                                   mechanisms, seed, cfg, n_requests,
                                   device=dev)])
    sims = [ssd._make_sim(cfg, condition, m, seed + 7, engine, dev)
            for m in mechanisms]
    with _COMPARE_LOCK:
        _COMPARE_PAYLOAD = (trace, expansion, schedule, sims, shard)
        try:
            try:
                pool = ProcessPoolExecutor(
                    max_workers=min(workers, len(mechanisms)),
                    mp_context=multiprocessing.get_context("fork"),
                    initializer=torch.set_num_threads, initargs=(1,))
            except (OSError, PermissionError):
                pool = None
            if pool is None:
                stats = [_run_compare_mech(i) for i in range(len(sims))]
            else:
                try:
                    with pool:
                        futures = [pool.submit(_run_compare_mech, i)
                                   for i in range(len(sims))]
                        stats = [f.result() for f in futures]
                except BrokenExecutor:
                    stats = [_run_compare_mech(i) for i in range(len(sims))]
        finally:
            _COMPARE_PAYLOAD = None
    return dict(zip(mechanisms, stats))


# -- canonical serialization ----------------------------------------------


def sweep_cell_key(mechanism: str, condition: OperatingCondition,
                   seed: int) -> str:
    """Collision-free string key for one sweep cell (JSON dict key).

    Condition floats are rendered with ``repr`` (exact round-trip), so
    two distinct conditions can never collapse to one key.
    """
    return (f"{mechanism}|ret{condition.retention_days!r}"
            f"|pec{condition.pec!r}|seed{seed}")


def _stats_payload(stats) -> Dict[str, object]:
    """SimStats -> JSON dict of *compared* fields only.

    ``compare=False`` fields (engine_selected, fast_path_events,
    fused_cells, ...) describe how a result was computed, not what it
    is — including them would make the serialization depend on engine,
    device and fusion decisions that are defined to be outcome-neutral.
    """
    d = dataclasses.asdict(stats)
    return {f.name: d[f.name] for f in dataclasses.fields(stats)
            if f.compare}


def sweep_to_json(results: Dict) -> str:
    """Canonical, byte-stable serialization of a sweep result dict.

    Keys sort lexicographically and floats serialize via ``repr`` (exact
    round-trip), so two sweeps are byte-identical iff every cell's
    SimStats match exactly.  Observability fields (``compare=False`` on
    :class:`~repro_torch.flashsim.ssd.SimStats`) are excluded, so the
    bytes are invariant across engine selection, worker count, device
    and fusion decisions — and equal to the reference package's for
    equal outcomes.
    """
    payload = {
        sweep_cell_key(m, cond, s): _stats_payload(stats)
        for (m, cond, s), stats in results.items()
    }
    return json.dumps(payload, sort_keys=True, indent=1) + "\n"


# -- host fingerprint ------------------------------------------------------


def host_fingerprint() -> Dict[str, object]:
    """CPU model, core count, and interpreter/library versions, to
    record beside every absolute host timing."""
    cpu_model = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    cpu_model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return {
        "cpu_model": cpu_model or platform.processor() or None,
        "cpu_count": os.cpu_count(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "numpy": np.__version__,
    }
