"""Dispatch wrapper for the lockstep sched-aware shard core.

``fcfs_core`` / ``fused_core`` take the padded per-lane op table as
numpy (what the batched engine builds on the host), place it on a torch
device and run :func:`fcfs_core_fwd`, which picks the implementation by
the tensors' device:

  * CUDA tensors launch the hand-written kernel (``csrc/fcfs_core.cu``,
    built with nvcc at first use) — or raise; there is no fallback;
  * CPU tensors run the plain torch version
    (:func:`repro_torch.kernels.fcfs_core.plain.fcfs_core_plain`).

Both are bit-identical to :func:`ref.fcfs_core_ref`.  ``launches``
counts the CUDA kernel launches of this process, and nothing else.
The table bucketing (``pad_ops``, ``ring_caps``) keeps the reference's
powers of two so both packages see the same padded shapes.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.fcfs_core.plain import fcfs_core_plain

#: CUDA launches of the shard-core kernel in this process (every entry
#: point goes through :func:`fcfs_core_fwd`).
launches = 0

_SOURCE = Path(__file__).resolve().parent / "csrc" / "fcfs_core.cu"
#: Largest per-lane die count the kernel holds (``kMaxDies`` in the source).
MAX_DIES = 16


def pad_width(widest: int) -> int:
    """Padded-table width bucket: next power of two strictly above
    ``widest`` (floor 16), the :func:`pad_ops` policy."""
    maxp = 16
    while maxp <= widest:
        maxp *= 2
    return maxp


def pad_ops(lanes_ops, maxp: Optional[int] = None) -> np.ndarray:
    """Stack per-lane (P_l, 7) op tables into one padded (L, MAXP, 7).

    Pad rows carry ``arrival = inf`` (the admission cursor's stop
    sentinel) and ``hp = 0.0``; the padded width is the next power of
    two strictly above the widest lane (floor 16), so the cursor always
    lands on a pad row.  ``maxp`` forces a wider bucket (the fused sweep
    pads every cell of a group to the group-wide bucket); it must still
    exceed the widest lane.
    """
    L = len(lanes_ops)
    widest = max((t.shape[0] for t in lanes_ops), default=0)
    if maxp is None:
        maxp = pad_width(widest)
    elif maxp <= widest:
        raise ValueError(f"maxp {maxp} <= widest lane {widest}")
    ops = np.full((L, maxp, 7), np.inf, dtype=np.float64)
    ops[:, :, 1] = 3.0          # kind: pad
    ops[:, :, 2] = 0.0          # pad die: keep int casts well-defined
    ops[:, :, 6] = 0.0          # pad hp: low class, never enqueued
    for l, t in enumerate(lanes_ops):
        ops[l, :t.shape[0]] = t
    return ops


def augment_ops(ops: np.ndarray, pipelined: bool) -> np.ndarray:
    """Append the host-precomputed grant-attribute columns.

    ``gdt`` — delta from grant time to the op's first event (tR for
    reads, dur for writes/erases); ``gk0`` — the first event's kind
    (0 sense, 1 release), which doubles as the op's non-read flag;
    ``grem0`` — initial remaining-attempt counter (serial mode counts
    down from ``attempts``; pipelined counts issued copies up from 0).
    """
    kind = ops[:, :, 1]
    is_read = kind == 0.0
    gdt = np.where(is_read, ops[:, :, 5], ops[:, :, 3])
    gk0 = np.where(is_read, 0.0, 1.0)
    if pipelined:
        grem0 = np.zeros_like(gdt)
    else:
        grem0 = np.where(is_read, ops[:, :, 4], 0.0)
    return np.concatenate(
        [ops, np.stack([gdt, gk0, grem0], axis=2)], axis=2)


def count_steps(ops: np.ndarray) -> int:
    """Lockstep step bound: max over lanes of admissions + events.

    Per op a read pops ``attempts + 1`` events (senses + release), a
    write 2 (transfer landed + release) and an erase 1 (release).
    Priority policies reorder events but never change their count.
    """
    kind = ops[:, :, 1]
    att = ops[:, :, 4]
    is_r = kind == 0.0
    per_op = np.where(is_r, np.where(np.isfinite(att), att, 0.0) + 1.0,
                      np.where(kind == 1.0, 2.0,
                               np.where(kind == 2.0, 1.0, 0.0)))
    n_adm = (kind != 3.0).sum(axis=1)
    return int((n_adm + per_op.sum(axis=1)).max(initial=0.0))


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def ring_caps(ops: np.ndarray, n_dies: int) -> Tuple[int, int]:
    """Static FIFO/ACQ ring capacities for a padded op table.

    ``capq`` bounds the deepest per-die FIFO (also each class of the
    dual priority rings); ``capw`` bounds the in-flight write transfers
    of a lane.  Powers of two with a floor of 4.
    """
    kind = ops[:, :, 1]
    real = kind != 3.0
    per_die = 0
    if real.any():
        lane_of = np.broadcast_to(
            np.arange(ops.shape[0])[:, None], kind.shape)
        flat = lane_of[real] * n_dies + ops[:, :, 2][real].astype(np.int64)
        per_die = int(np.bincount(flat).max())
    writes = int((kind == 1.0).sum(axis=1).max(initial=0.0))
    return _pow2_at_least(max(per_die, 4)), _pow2_at_least(max(writes, 4))


def _kernel_fn():
    """The C entry point of the built kernel library, typed for ctypes."""
    from repro_torch.kernels import build

    fn = build.load(_SOURCE).fcfs_core_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, ci, ci, vp, ctypes.c_longlong, ci, ci, ci, ci,
                   vp, vp, vp, vp, vp, vp]
    fn.restype = ci
    return fn


def _launch_cuda(ops: torch.Tensor, timing: torch.Tensor, steps: int,
                 n_dies: int, capq: int, capw: int, pipelined: bool,
                 prio: bool):
    """Launch the CUDA kernel on the current stream (no synchronize)."""
    global launches
    if n_dies > MAX_DIES:
        raise ValueError(f"fcfs_core kernel holds at most {MAX_DIES} dies "
                         f"per lane, got {n_dies}")
    fn = _kernel_fn()
    L, maxp, _ = ops.shape
    dev = ops.device
    fifo = torch.empty((L, n_dies, capq * (2 if prio else 1)),
                       dtype=torch.int32, device=dev)
    acq = torch.empty((L, capw, 3), dtype=torch.float64, device=dev)
    fin = torch.zeros((L, maxp + 1), dtype=torch.float64, device=dev)
    diestat = torch.empty((L, n_dies, 2), dtype=torch.float64, device=dev)
    lane = torch.empty((L, 4), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(ops.data_ptr(), L, maxp, n_dies, timing.data_ptr(), steps,
             capq, capw, int(pipelined), int(prio), fifo.data_ptr(),
             acq.data_ptr(), fin.data_ptr(), diestat.data_ptr(),
             lane.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fcfs_core kernel launch failed: CUDA error {err}")
    launches += 1
    return fin, diestat, lane


def fcfs_core_fwd(ops: torch.Tensor, timing: torch.Tensor, steps: int, *,
                  n_dies: int, capq: int, capw: int, pipelined: bool,
                  prio: bool):
    """Run the shard core on device tensors.

    ``ops`` (L, MAXP, 10) float64 augmented table, ``timing`` (L, 3)
    float64 per-lane [tdma, tecc, age_bound], ``steps`` the lockstep
    step bound (:func:`count_steps`).  CUDA tensors launch the kernel;
    CPU tensors run the plain version.  Returns float64 tensors
    ``(fin (L, MAXP+1), diestat (L, n_dies, 2), lane (L, 4))`` on the
    input's device.
    """
    L = ops.shape[0]
    if ops.dim() != 3 or ops.shape[2] != 10 or ops.dtype != torch.float64:
        raise ValueError(f"ops must be (L, MAXP, 10) float64, got "
                         f"{tuple(ops.shape)} {ops.dtype}")
    if timing.shape != (L, 3) or timing.dtype != torch.float64:
        raise ValueError(f"timing must be ({L}, 3) float64, got "
                         f"{tuple(timing.shape)} {timing.dtype}")
    if timing.device != ops.device:
        raise ValueError("ops and timing must share a device")
    kw = dict(n_dies=n_dies, capq=capq, capw=capw, pipelined=pipelined,
              prio=prio)
    if ops.device.type == "cuda":
        return _launch_cuda(ops.contiguous(), timing.contiguous(), steps,
                            **kw)
    if ops.device.type == "cpu":
        return fcfs_core_plain(ops, timing, steps, **kw)
    raise ValueError(f"fcfs_core runs on cuda or cpu, not {ops.device}")


def _dispatch(ops: np.ndarray, n_dies: int, pipelined: bool,
              timing: np.ndarray, prio: bool, caps=None, steps=None,
              device=None):
    """One run on a padded numpy table with per-lane timing rows.

    ``caps`` optionally forces ``(capq, capw)`` (the fused sweep buckets
    them group-wide; capacity is semantics-neutral because the rings
    pair via monotone counters).  ``steps`` skips the recount when the
    caller already knows the bound.  Returns numpy ``(fin, diestat,
    lane)``.
    """
    dev = resolve_device(device)
    if steps is None:
        steps = count_steps(ops)
    capq, capw = ring_caps(ops, n_dies) if caps is None else caps
    aug = torch.as_tensor(augment_ops(ops, pipelined), dtype=torch.float64,
                          device=dev)
    tim = torch.as_tensor(np.asarray(timing, np.float64), device=dev)
    fin, diestat, lane = fcfs_core_fwd(aug, tim, steps, n_dies=n_dies,
                                       capq=capq, capw=capw,
                                       pipelined=pipelined, prio=prio)
    return fin.cpu().numpy(), diestat.cpu().numpy(), lane.cpu().numpy()


def fcfs_core(ops: np.ndarray, n_dies: int, pipelined: bool,
              tdma: float, tecc: float,
              age_bound: Optional[float] = None, device=None):
    """Run the lockstep shard core on a padded op table.

    ``age_bound`` selects the scheduler lowering: ``None`` = single
    FIFO ring (fcfs); a float (``inf`` = plain host_prio) = dual
    priority rings with that aging bound, classified by the op table's
    ``hp`` column.  Returns numpy ``(fin, diestat, lane)`` — per-op
    completion times (L, MAXP+1), per-die [busy_total, last_release]
    (L, n_dies, 2), and per-lane [ch_busy, ch_tot, n_events, seq]
    (L, 4).  Bit-identical to :func:`ref.fcfs_core_ref`.
    """
    prio = age_bound is not None
    bound = float(age_bound) if prio else 0.0
    timing = np.tile(
        np.asarray([[float(tdma), float(tecc), bound]], np.float64),
        (ops.shape[0], 1))
    return _dispatch(ops, n_dies, pipelined, timing, prio, device=device)


def fused_core(ops: np.ndarray, n_dies: int, pipelined: bool,
               timing: np.ndarray, prio: bool, caps=None, steps=None,
               device=None):
    """Run one launch over the lanes of many stacked cells.

    ``ops`` is the (C*L, MAXP, 7) cell-stacked padded table (cell c's
    lanes occupy rows [c*L, (c+1)*L)), ``timing`` the matching (C*L, 3)
    per-lane [tdma, tecc, age_bound] rows.  ``pipelined`` and ``prio``
    must be uniform across the stacked cells.  Returns the same triple
    as :func:`fcfs_core`; rows [c*L, (c+1)*L) are cell c's, bit-identical
    to a separate :func:`fcfs_core` run (the cell-axis law restated by
    :func:`ref.fused_core_ref`).
    """
    if timing.shape != (ops.shape[0], 3):
        raise ValueError(
            f"timing shape {timing.shape} != ({ops.shape[0]}, 3)")
    return _dispatch(ops, n_dies, pipelined, np.asarray(timing, np.float64),
                     prio, caps=caps, steps=steps, device=device)
