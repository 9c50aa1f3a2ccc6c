"""Batched shard core: lockstep-vectorized event loops over all channels.

``run_event_core_batched`` is a drop-in replacement for
:func:`repro_torch.flashsim.engine.run_event_core` on the **open-loop fast
path**: every per-channel shard loop runs as one lane of the shard-core
kernel (:mod:`repro_torch.kernels.fcfs_core` — the CUDA kernel on the
card, its plain torch version on the CPU) instead of sequentially in
Python.  The result is bit-identical to the interpreter
— the kernel replays the exact event order (push-order seq discipline)
and the exact float arithmetic (the busy-until collapse's add/max
sequence) of :func:`repro_torch.flashsim.engine._run_shard` per lane; see the
kernel module docstring for the construction.

Eligibility (the supported matrix) is checked **explicitly** — an
unsupported configuration raises :class:`BatchedUnsupported` rather
than silently falling back to the interpreter:

  ===================  ========================================
  scheduler            any policy with a ring lowering —
                       ``fcfs`` (single FIFO ring),
                       ``host_prio`` and ``host_prio_aged[:b]``
                       (dual priority rings, per-lane aging
                       bound); ``tokens`` and ``preempt`` have
                       none and are rejected
  GC                   ``none`` or ``prepass`` (the prepass
                       schedule is just a longer admission
                       stream); ``online`` injects ops mid-loop
  faults               ``None`` (recovery ladders are serial
                       continuations the kernel doesn't model)
  validate             ``False`` (work-conservation asserts are
                       interpreter instrumentation)
  ===================  ========================================

Prepass GC is inside the matrix: its schedule's GC copy-back reads
(``rid = -1``, the low scheduling class), GC programs and erases (op
kind 2) are ordinary rows of the op table.  The closed-loop frontend
(``ncq_depth``) is outside it: :func:`check_batched_config` raises
:class:`BatchedUnsupported` for it, so ``engine="auto"`` records the
reason and runs the array interpreter.  So are online GC (its ops are
injected mid-loop) and faults (recovery ladders are serial continuations
the kernel does not model): both packages run them on the host
interpreter, and :func:`check_batched_config` refuses them in the
reference's words.

``engine="auto"`` resolution lives here too (:func:`resolve_engine`):
it runs the same checks non-fatally and returns ``("batched", "")``
when eligible, else ``("array", reason)`` — the recorded reason string
is the matching ``BatchedUnsupported`` message, so auto documents
rather than hides its fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.flashsim.engine import EngineResult
from repro_torch.flashsim.sched import SchedulerPolicy


class BatchedUnsupported(NotImplementedError):
    """Raised when a run configuration is outside the batched core's
    supported matrix (never a silent fallback)."""


def dies_per_lane(cfg) -> int:
    """Dies one channel (one shard-core lane) holds: ``n_dies`` spread
    over ``n_channels``, rounded up."""
    return -(-cfg.n_dies // cfg.n_channels)


def check_batched_config(cfg, device=None) -> None:
    """Config-level eligibility for ``engine='batched'`` on ``device``
    (``None`` is the CUDA card, as for every entry point; fail fast at
    construction; run-time state is checked again by
    :func:`check_batched_supported`).  Online GC, faults and the
    closed-loop frontend are outside the matrix; a channel may hold any
    number of dies, on the card as on the CPU."""
    from repro_torch.flashsim.sched import get_scheduler

    pol = get_scheduler(cfg.scheduler)
    if pol.ring_lowering is None:
        raise BatchedUnsupported(
            f"engine='batched' supports ring-lowerable schedulers only "
            f"(fcfs, host_prio, host_prio_aged[:bound]), got "
            f"{cfg.scheduler!r}; use engine='array'"
        )
    if cfg.gc.enabled and cfg.gc.mode == "online":
        raise BatchedUnsupported(
            "engine='batched' does not support online GC (ops are "
            "injected mid-loop); use gc='prepass' or engine='array'"
        )
    if cfg.faults is not None:
        raise BatchedUnsupported(
            "engine='batched' does not support fault injection; use "
            "engine='array'"
        )
    if cfg.ncq_depth is not None:
        raise BatchedUnsupported(
            "engine='batched' is open-loop only (ncq_depth=None); the "
            "closed-loop frontend requires engine='array'"
        )
    resolve_device(device)          # None is the card: raises without one


def check_batched_supported(
    policy: SchedulerPolicy,
    bufs,
    online,
    validate: bool,
) -> None:
    """Raise :class:`BatchedUnsupported` unless this run is eligible."""
    if policy.ring_lowering is None:
        raise BatchedUnsupported(
            f"engine='batched' supports ring-lowerable schedulers only "
            f"(fcfs, host_prio, host_prio_aged[:bound]), got "
            f"{policy.name!r}; run this scheduler with engine='array'"
        )
    if online is not None:
        raise BatchedUnsupported(
            "engine='batched' does not support online GC (ops are "
            "injected mid-loop); use gc='prepass' or engine='array'"
        )
    if bufs.xa is not None:
        raise BatchedUnsupported(
            "engine='batched' does not support fault injection "
            "(recovery-ladder continuations); use engine='array'"
        )
    if validate:
        raise BatchedUnsupported(
            "validate=True is interpreter instrumentation; use "
            "engine='array' for work-conservation checks"
        )


def resolve_engine(cfg, validate: bool = False,
                   device=None) -> Tuple[str, str]:
    """Resolve ``engine="auto"`` for a config on ``device`` (``None`` is
    the CUDA card): ``(engine, reason)``.

    Returns ``("batched", "")`` when the config is inside the batched
    matrix, else ``("array", reason)`` where ``reason`` is the exact
    :class:`BatchedUnsupported` message the explicit engine would have
    raised — auto records, never hides, its fallback.  ``validate=True``
    always resolves to the instrumented interpreter.
    """
    if validate:
        return ("array", "validate=True is interpreter instrumentation")
    try:
        check_batched_config(cfg, device)
    except BatchedUnsupported as e:
        return ("array", str(e))
    return ("batched", "")


def _lane_tables(cfg, bufs):
    """Build the per-channel (P_l, 7) op tables of one run.

    Returns ``(tables, lane_idx, rid)`` — the per-lane tables in
    admission order, the per-channel index partition, and the op→request
    id map (used to reassemble ``req_done``).  This is the shared front
    half of both the per-run and the fused batched runners.
    """
    n_ch = cfg.n_channels
    P = len(bufs.arrival)

    arrival = np.asarray(bufs.arrival, dtype=np.float64)
    rid = np.asarray(bufs.rid, dtype=np.int64)
    die = np.asarray(bufs.die, dtype=np.int64)
    ch = np.asarray(bufs.ch, dtype=np.int64)
    read = np.asarray(bufs.read, dtype=bool)
    erase = np.asarray(bufs.erase, dtype=bool)
    dur = np.asarray(bufs.dur, dtype=np.float64)
    att = np.asarray(bufs.a, dtype=np.float64)
    tr = np.asarray(bufs.tr, dtype=np.float64)

    if P and not np.array_equal(ch, die % n_ch):
        # The lockstep decomposition leans on the static die stripe the
        # same way shard=True does; an op off its die's channel would
        # break lane ownership.
        raise BatchedUnsupported(
            "engine='batched' requires the die->channel stripe "
            "(ch == die % n_channels) for every op"
        )

    kind = np.where(read, 0.0, np.where(erase, 2.0, 1.0))
    die_local = (die // n_ch).astype(np.float64)
    # Scheduling class: the interpreter's host_read table is
    # ``read and rid >= 0`` (GC copy-back reads carry rid = -1; the
    # fault ladder's parity reads are excluded from this matrix).
    hp = (read & (rid >= 0)).astype(np.float64)
    table = np.stack([arrival, kind, die_local, dur, att, tr, hp],
                     axis=1)

    # Per-channel admission substreams, original order preserved — the
    # same partition run_event_core's shard path builds.
    lane_idx = [np.flatnonzero(ch == c) for c in range(n_ch)]
    return [table[idx] for idx in lane_idx], lane_idx, rid


def _assemble_result(cfg, rid, lane_idx, fin, diestat, lane,
                     n_requests: int, fused_cells: int = 0) -> EngineResult:
    """Reassemble an :class:`EngineResult` from one cell's kernel rows
    exactly as ``merge_shard_results`` would."""
    n_dies = cfg.n_dies

    req_done = np.zeros(n_requests, dtype=np.float64)
    live = [(c, idx) for c, idx in enumerate(lane_idx) if idx.size]
    if live:
        # One flat scatter-max over every lane's ops (max is
        # order-free, so flattening the per-channel loop is exact).
        rid_all = np.concatenate([rid[idx] for _, idx in live])
        fin_all = np.concatenate([fin[c, : idx.size] for c, idx in live])
        sel = rid_all >= 0
        np.maximum.at(req_done, rid_all[sel], fin_all[sel])

    # diestat rows are (lane c, local die j) for die d = j*n_ch + c;
    # transpose to d-order and trim the padding rows past n_dies.
    ds = np.asarray(diestat).transpose(1, 0, 2).reshape(-1, 2)[:n_dies]
    die_tot = ds[:, 0].tolist()
    die_busy = ds[:, 1].tolist()

    n_events = int(lane[:, 2].sum())
    return EngineResult(
        req_done=req_done.tolist(),
        die_tot=die_tot,
        ch_tot=lane[:, 1].tolist(),
        die_busy=die_busy,
        ch_busy=lane[:, 0].tolist(),
        n_events=n_events,
        gc_suspensions=0,
        online_attempts=0,
        online_read_pages=0,
        fast_path_events=n_events,
        fused_cells=fused_cells,
    )


def run_event_core_batched(
    cfg,
    pipelined: bool,
    policy: SchedulerPolicy,
    bufs,
    n_requests: int,
    online=None,
    validate: bool = False,
    device=None,
) -> EngineResult:
    """Run the admission stream through the shard-core kernel on
    ``device`` (the CUDA card by default).

    Same contract as ``run_event_core(..., shard=True)`` on the
    supported matrix: one lane per channel, results merged exactly as
    :func:`repro_torch.flashsim.engine.merge_shard_results` would.
    """
    check_batched_supported(policy, bufs, online, validate)

    t = cfg.timing
    tables, lane_idx, rid = _lane_tables(cfg, bufs)

    from repro_torch.kernels.fcfs_core import fcfs_core
    from repro_torch.kernels.fcfs_core.ops import pad_ops

    mode, bound = policy.ring_lowering
    ops = pad_ops(tables)
    fin, diestat, lane = fcfs_core(
        ops, dies_per_lane(cfg), pipelined, t.tdma_us, t.tecc_us,
        age_bound=bound if mode == "prio" else None, device=device)
    return _assemble_result(cfg, rid, lane_idx, fin, diestat, lane,
                            n_requests)


@dataclasses.dataclass
class FusedRun:
    """One prepared cell of a fused sweep dispatch: the same inputs
    ``run_event_core_batched`` takes, held so many cells can share one
    kernel launch."""

    cfg: object
    pipelined: bool
    policy: SchedulerPolicy
    bufs: object
    n_requests: int


#: Lane budget of one fused dispatch on the CPU.  Kept at the
#: reference's value, which was measured for its CPU lowering; fusion
#: decisions never change results (the cell-axis law).  On a CUDA card
#: :func:`_card_chunks` chunks by the lanes the card holds at once.
_FUSE_LANE_CAP = 64

#: Step-homogeneity bound of one CPU chunk: chunks split when the next
#: cell's step bound exceeds the chunk minimum by more than this ratio.
#: The reference's CPU-measured value, semantics-neutral; the CUDA
#: kernel has no lockstep, so the card's chunks ignore it.
_FUSE_STEP_RATIO = 1.5


def _fuse_cell_cap(n_channels: int) -> int:
    """Max cells of one fused chunk for an ``n_channels``-lane cell."""
    return max(1, _FUSE_LANE_CAP // max(1, n_channels))


def _fuse_chunks(cells, n_channels: int):
    """Split one static-shape group into step-homogeneous chunks (the
    CPU rule, the reference's).

    ``cells`` is a sequence of ``(steps, index, payload)`` triples; the
    split is deterministic — sort by (steps, index), then greedily chunk
    while the cell count stays under :func:`_fuse_cell_cap` and the step
    bound within ``_FUSE_STEP_RATIO`` of the chunk minimum.  Chunking
    never affects results (the cell-axis law), only which cells share a
    dispatch.
    """
    cap = _fuse_cell_cap(n_channels)
    chunks, cur = [], []
    for steps, idx, payload in sorted(cells, key=lambda t: t[:2]):
        if cur and (len(cur) >= cap
                    or steps > cur[0][0] * _FUSE_STEP_RATIO):
            chunks.append(cur)
            cur = []
        cur.append((steps, idx, payload))
    if cur:
        chunks.append(cur)
    return chunks


def _card_chunks(cells, n_channels: int, resident_lanes: int):
    """Split one group into chunks for the CUDA kernel (the card's rule).

    The kernel runs each lane in its own block and a launch costs its
    longest lane while every lane is resident, so a chunk holds as many
    cells as fit ``resident_lanes`` (the card's resident blocks for the
    group's shapes, :func:`repro_torch.kernels.fcfs_core.ops.
    resident_lanes`), whatever their step bounds.  Cells are taken in
    (steps, index) order, so a group past one wave puts cells of like
    length together.  ``cells`` as for :func:`_fuse_chunks`.
    """
    cap = max(1, resident_lanes // max(1, n_channels))
    ordered = sorted(cells, key=lambda t: t[:2])
    return [ordered[i:i + cap] for i in range(0, len(ordered), cap)]


def run_event_cores_fused(runs, device=None) -> list:
    """Run many eligible cells in as few kernel launches as possible, on
    ``device`` (the CUDA card by default).

    Stacks the per-cell padded op tables of ``runs`` (a sequence of
    :class:`FusedRun`) along the lane axis — cell c's channels occupy
    lane rows [c*L, (c+1)*L) — and dispatches each *chunk* once.  A
    group is the maximal sub-grid sharing every static kernel parameter:
    (n_channels, local die count, scheduler lowering mode, padded-width
    bucket), and on the CPU also ``pipelined``; the CUDA kernel takes
    ``pipelined`` per lane, so on the card serial and pipelined cells
    share a launch.  On the CPU each group chunks by the reference's two
    limits (:func:`_fuse_chunks`): at most ``_FUSE_LANE_CAP`` stacked
    lanes per launch and step bounds within ``_FUSE_STEP_RATIO`` of each
    other; on the card by the lanes it holds at once
    (:func:`_card_chunks`).  Ring capacities and the step bound are
    chunk maxima on the CPU and group maxima on the card — all
    semantics-neutral, so each cell's rows are bit-identical to its own
    :func:`run_event_core_batched` run (the cell-axis law; see
    :func:`fused_core_ref`).  Per-cell scalars (tdma, tecc, aging bound,
    pipelined) ride as per-lane timing rows, so cells with different
    timing models or ``host_prio_aged`` bounds still fuse.

    Eligibility is checked per cell up front —
    :class:`BatchedUnsupported` propagates before any dispatch (callers
    route ineligible cells to their own engine runs and record the
    reason; nothing silently falls back here).  Returns one
    :class:`EngineResult` per run, in order, each with
    ``fused_cells = len(its chunk)``.
    """
    from repro_torch.kernels.fcfs_core.ops import (
        count_steps, fused_core, pad_ops, pad_width, resident_lanes,
        ring_caps)

    dev = resolve_device(device)
    card = dev.type == "cuda"
    prepped = []
    for r in runs:
        check_batched_supported(r.policy, r.bufs, None, False)
        tables, lane_idx, rid = _lane_tables(r.cfg, r.bufs)
        mode, bound = r.policy.ring_lowering
        widest = max((t.shape[0] for t in tables), default=0)
        prepped.append((r, tables, lane_idx, rid, mode, bound, widest))

    # Group key = every static kernel parameter; per-cell dynamics
    # (timing, bound, pipelined on the card, table contents) ride in the
    # operands.
    groups = {}
    for i, (r, tables, lane_idx, rid, mode, bound, widest) in \
            enumerate(prepped):
        n_ch = r.cfg.n_channels
        key = (n_ch, dies_per_lane(r.cfg), mode, pad_width(widest),
               None if card else r.pipelined)
        groups.setdefault(key, []).append(i)

    results = [None] * len(prepped)
    for (n_ch, n_dies_local, mode, maxp, _), idxs in groups.items():
        prio = mode == "prio"
        cells = []
        for i in idxs:
            _, tables, _, _, _, _, _ = prepped[i]
            ops_c = pad_ops(tables, maxp=maxp)
            cells.append((count_steps(ops_c), i, ops_c))
        if card:
            # Group-wide ring caps fix the shared-memory footprint, and
            # with it the lanes the card holds at once.
            caps = ring_caps(np.concatenate([c for _, _, c in cells]),
                             n_dies_local)
            chunks = _card_chunks(cells, n_ch, resident_lanes(
                maxp, n_dies_local, *caps, prio, dev))
        else:
            chunks = _fuse_chunks(cells, n_ch)
        for chunk in chunks:
            C = len(chunk)
            cell_ops = [ops_c for _, _, ops_c in chunk]
            timing_rows, pip = [], []
            for _, i, _ in chunk:
                r, _, _, _, _, bound, _ = prepped[i]
                b = bound if prio else 0.0
                timing_rows.append(np.tile(
                    [[r.cfg.timing.tdma_us, r.cfg.timing.tecc_us, b]],
                    (n_ch, 1)))
                pip += [r.pipelined] * n_ch
            stacked = np.concatenate(cell_ops, axis=0)
            timing = np.concatenate(timing_rows,
                                    axis=0).astype(np.float64)

            # Ring bounds read off the stacked table in one pass on the
            # CPU (growing a cap never changes a cell's rows).  The
            # chunk-max step count is the stacked table's exact step
            # bound (max over lanes), so the launch skips its recount.
            steps = max(st for st, _, _ in chunk)
            fin, diestat, lane = fused_core(
                stacked, n_dies_local, np.asarray(pip), timing, prio=prio,
                caps=caps if card else ring_caps(stacked, n_dies_local),
                steps=steps, device=dev)
            for j, (_, i, _) in enumerate(chunk):
                r, _, lane_idx, rid, _, _, _ = prepped[i]
                rows = slice(j * n_ch, (j + 1) * n_ch)
                results[i] = _assemble_result(
                    r.cfg, rid, lane_idx, fin[rows], diestat[rows],
                    lane[rows], r.n_requests, fused_cells=C)
    return results
