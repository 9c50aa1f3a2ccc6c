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
counts the CUDA kernel launches of this process, and nothing else;
``smem_launches`` those of them whose op table and rings sat in shared
memory (:func:`placement` decides from the shapes before the launch).
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
#: point goes through :func:`fcfs_core_fwd`), and of those the launches
#: with the op table and rings in shared memory.
launches = 0
smem_launches = 0

_SOURCE = Path(__file__).resolve().parent / "csrc" / "fcfs_core.cu"
#: Die slots of the kernel's instances with their die state in static
#: shared memory (``slots_of`` in the source); a lane of more dies runs
#: the generic instance, its die state beside the rings.
DIE_SLOTS = (8, 16, 32, 64)
#: Bytes of one die's state in the kernel (``kDieBytes``).
DIE_BYTES = 104


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


def augment_ops(ops: np.ndarray, pipelined) -> np.ndarray:
    """Append the host-precomputed grant-attribute columns.

    ``gdt`` — delta from grant time to the op's first event (tR for
    reads, dur for writes/erases); ``gk0`` — the first event's kind
    (0 sense, 1 release), which doubles as the op's non-read flag;
    ``grem0`` — initial remaining-attempt counter (serial mode counts
    down from ``attempts``; pipelined counts issued copies up from 0).
    ``pipelined`` is one flag for every lane or an (L,) array of flags.
    """
    kind = ops[:, :, 1]
    is_read = kind == 0.0
    gdt = np.where(is_read, ops[:, :, 5], ops[:, :, 3])
    gk0 = np.where(is_read, 0.0, 1.0)
    pip = np.asarray(pipelined, bool)
    grem0 = np.where(pip[:, None] if pip.ndim else pip, 0.0,
                     np.where(is_read, ops[:, :, 4], 0.0))
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


#: Bit layout of the packed op word (``csrc/fcfs_core.cu``): kind in
#: bits 0-1, hp in bit 2, attempts in bits 3-26.  The local die is a
#: column of its own, so any die count fits.
_HP_SHIFT, _ATT_SHIFT = 2, 3
#: Attempts must stay below this to fit the word's attempts field.
MAX_ATTEMPTS = 1 << 24

#: ``placement`` of a launch: the op table and the rings in the block's
#: shared memory, or both in global memory (``csrc/fcfs_core.cu``).
SMEM, GLOBAL = 3, 0


def _check_ops(ops: torch.Tensor, n_dies: int) -> None:
    """Raise unless every row of the augmented table is one the kernel
    takes: kind 0-3, pads (kind 3) at ``arrival = inf``, and on real rows
    an integral die in [0, n_dies) and integral attempts in
    [0, MAX_ATTEMPTS).  One device-to-host read for all four checks."""
    arr, kind, die, att = (ops[:, :, c] for c in (0, 1, 2, 4))
    real = kind != 3.0
    bad = torch.stack([
        ((kind != 0.0) & (kind != 1.0) & (kind != 2.0) & real).any(),
        (~real & (arr != float("inf"))).any(),
        (real & ~((die >= 0) & (die < n_dies) & (die == die.floor()))).any(),
        (real & ~((att >= 0) & (att < MAX_ATTEMPTS)
                  & (att == att.floor()))).any(),
    ]).tolist()
    for failed, msg in zip(bad, (
            "op kinds must be 0 (read), 1 (write), 2 (erase) or 3 (pad)",
            "pad rows (kind 3) must have arrival = inf",
            f"every op's die must be an integer in [0, {n_dies})",
            f"every op's attempts must be an integer in "
            f"[0, {MAX_ATTEMPTS})")):
        if failed:
            raise ValueError(msg)


def pack_ops(ops: torch.Tensor, n_dies: int):
    """The kernel's compressed op table, 24 bytes a row.

    From the augmented (L, MAXP, 10) float64 table of a lane of
    ``n_dies`` dies, on its device: ``arr`` (L, MAXP) float64 arrivals,
    ``gdt`` (L, MAXP) float64 grant deltas (tR for reads, dur for writes
    and erases; column 7 of :func:`augment_ops`), ``pk`` (L, MAXP) int32
    words holding kind, ``hp == 1`` and attempts, and ``die`` (L, MAXP)
    int32 local dies (pad rows: kind 3 and zeros).  Raises
    ``ValueError`` for a row the kernel does not take (:func:`_check_ops`).
    """
    _check_ops(ops, n_dies)
    kind = ops[:, :, 1]
    real = kind != 3.0
    i64 = torch.int64
    die = torch.where(real, ops[:, :, 2], 0.0).to(torch.int32)
    att = torch.where(real, ops[:, :, 4], 0.0).to(i64)
    hp = (ops[:, :, 6] == 1.0).to(i64)
    pk = (kind.to(i64) | (hp << _HP_SHIFT)
          | (att << _ATT_SHIFT)).to(torch.int32)
    return ops[:, :, 0].contiguous(), ops[:, :, 7].contiguous(), pk, die


def die_slots(n_dies: int) -> int:
    """Die slots of the kernel instance that runs a lane of ``n_dies``
    dies: the least of :data:`DIE_SLOTS` that holds them, or 0 past 64
    dies (the generic instance)."""
    return next((s for s in DIE_SLOTS if n_dies <= s), 0)


def static_smem_bytes(n_dies: int) -> int:
    """Static shared memory of ``n_dies``' instance: its die state."""
    return DIE_BYTES * die_slots(n_dies)


def smem_bytes(maxp: int, n_dies: int, capq: int, capw: int,
               prio: bool) -> int:
    """Dynamic shared memory of one shared-memory block: past 64 dies
    the die state, then the ACQ ring, the packed op table and the FIFO
    rings (``layout`` in the source)."""
    dies = 0 if die_slots(n_dies) else DIE_BYTES * n_dies
    return (dies + 24 * capw + 24 * maxp
            + 4 * n_dies * capq * (2 if prio else 1))


def placement(maxp: int, n_dies: int, capq: int, capw: int, prio: bool,
              budget: int) -> int:
    """:data:`SMEM` when one lane's table and rings fit ``budget`` bytes
    of dynamic shared memory, else :data:`GLOBAL` (the same kernel code
    with them in global memory)."""
    fits = smem_bytes(maxp, n_dies, capq, capw, prio) <= budget
    return SMEM if fits else GLOBAL


def _lib():
    """The built kernel library, its C entry points typed for ctypes."""
    from repro_torch.kernels import build

    lib = build.load(_SOURCE)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fcfs_core_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, ll, ci,
                                     ci, ci, ci, vp, vp, vp, vp, vp, vp, vp]
    lib.fcfs_core_launch.restype = ci
    lib.fcfs_core_smem_budget.argtypes = [ci, ci, ctypes.POINTER(ll)]
    lib.fcfs_core_smem_budget.restype = ci
    lib.fcfs_core_static_smem.argtypes = [ci, ctypes.POINTER(ll)]
    lib.fcfs_core_static_smem.restype = ci
    lib.fcfs_core_resident_blocks.argtypes = [ci, ci, ci, ll,
                                              ctypes.POINTER(ci)]
    lib.fcfs_core_resident_blocks.restype = ci
    lib.fcfs_core_smem_bytes.argtypes = [ci, ci, ci, ci, ci, ci]
    lib.fcfs_core_smem_bytes.restype = ll
    return lib


def _device_index(device) -> int:
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


def smem_budget(device, n_dies: int) -> int:
    """Dynamic shared memory one block of ``n_dies``' kernel instance may
    take on a CUDA ``device``: the opt-in limit less the instance's
    static die state."""
    out = ctypes.c_longlong()
    err = _lib().fcfs_core_smem_budget(_device_index(device), n_dies,
                                       ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"fcfs_core shared-memory query failed: CUDA "
                           f"error {err}")
    return out.value


def resident_lanes(maxp: int, n_dies: int, capq: int, capw: int,
                   prio: bool, device) -> int:
    """Lanes the card holds at once for these shapes: blocks per SM of
    the variant :func:`placement` picks, at its shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), times the SMs."""
    place = placement(maxp, n_dies, capq, capw, prio,
                      smem_budget(device, n_dies))
    nbytes = smem_bytes(maxp, n_dies, capq, capw, prio) if place else 0
    out = ctypes.c_int()
    err = _lib().fcfs_core_resident_blocks(_device_index(device), place,
                                           n_dies, nbytes, ctypes.byref(out))
    if err != 0 or out.value < 1:
        raise RuntimeError(f"fcfs_core occupancy query failed: CUDA error "
                           f"{err}")
    return out.value


def _launch_cuda(ops: torch.Tensor, timing: torch.Tensor, steps: int,
                 n_dies: int, capq: int, capw: int, prio: bool):
    """Launch the CUDA kernel on the current stream (no synchronize)."""
    global launches, smem_launches
    if n_dies < 1:
        raise ValueError(f"fcfs_core kernel takes at least one die a lane, "
                         f"got {n_dies}")
    for name, cap in (("capq", capq), ("capw", capw)):
        if cap < 1 or cap & (cap - 1):
            raise ValueError(f"fcfs_core kernel takes power-of-two ring "
                             f"capacities, got {name} = {cap}")
    arr, gdt, pk, die = pack_ops(ops, n_dies)
    L, maxp, _ = ops.shape
    dev = ops.device
    place = placement(maxp, n_dies, capq, capw, prio,
                      smem_budget(dev, n_dies))
    fifo = acq = dies = None
    if place != SMEM:
        fifo = torch.empty((L, n_dies, capq * (2 if prio else 1)),
                           dtype=torch.int32, device=dev)
        acq = torch.empty((L, capw, 3), dtype=torch.float64, device=dev)
        if not die_slots(n_dies):
            dies = torch.empty((L, DIE_BYTES // 8 * n_dies),
                               dtype=torch.float64, device=dev)
    fin = torch.zeros((L, maxp + 1), dtype=torch.float64, device=dev)
    diestat = torch.empty((L, n_dies, 2), dtype=torch.float64, device=dev)
    lane = torch.empty((L, 4), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().fcfs_core_launch(
        arr.data_ptr(), gdt.data_ptr(), pk.data_ptr(), die.data_ptr(), L,
        maxp, n_dies, timing.data_ptr(), steps, capq, capw, int(prio), place,
        *(None if t is None else t.data_ptr() for t in (fifo, acq, dies)),
        fin.data_ptr(), diestat.data_ptr(), lane.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fcfs_core kernel launch failed: CUDA error {err}")
    launches += 1
    smem_launches += place == SMEM
    return fin, diestat, lane


def fcfs_core_fwd(ops: torch.Tensor, timing: torch.Tensor, steps: int, *,
                  n_dies: int, capq: int, capw: int, prio: bool):
    """Run the shard core on device tensors.

    ``ops`` (L, MAXP, 10) float64 augmented table, ``timing`` (L, 4)
    float64 per-lane [tdma, tecc, age_bound, pipelined] (pipelined 1.0
    or 0.0), ``steps`` the lockstep step bound (:func:`count_steps`).
    CUDA tensors launch the kernel for any ``n_dies`` (its table and
    rings in shared memory where they fit, counted in ``smem_launches``,
    else in global memory); CPU tensors run the plain version.  Returns
    float64 tensors ``(fin (L, MAXP+1), diestat (L, n_dies, 2), lane (L,
    4))`` on the input's device.
    """
    L = ops.shape[0]
    if ops.dim() != 3 or ops.shape[2] != 10 or ops.dtype != torch.float64:
        raise ValueError(f"ops must be (L, MAXP, 10) float64, got "
                         f"{tuple(ops.shape)} {ops.dtype}")
    if timing.shape != (L, 4) or timing.dtype != torch.float64:
        raise ValueError(f"timing must be ({L}, 4) float64, got "
                         f"{tuple(timing.shape)} {timing.dtype}")
    if timing.device != ops.device:
        raise ValueError("ops and timing must share a device")
    kw = dict(n_dies=n_dies, capq=capq, capw=capw, prio=prio)
    if ops.device.type == "cuda":
        return _launch_cuda(ops.contiguous(), timing.contiguous(), steps,
                            **kw)
    if ops.device.type == "cpu":
        _check_ops(ops, n_dies)
        return fcfs_core_plain(ops, timing, steps, **kw)
    raise ValueError(f"fcfs_core runs on cuda or cpu, not {ops.device}")


def _dispatch(ops: np.ndarray, n_dies: int, pipelined, timing: np.ndarray,
              prio: bool, caps=None, steps=None, device=None):
    """One run on a padded numpy table with per-lane timing rows.

    ``pipelined`` is one flag for every lane or an (L,) array of per-lane
    flags; ``timing`` the (L, 3) [tdma, tecc, age_bound] rows.  ``caps``
    optionally forces ``(capq, capw)`` (the fused sweep buckets them
    group-wide; capacity is semantics-neutral because the rings pair via
    monotone counters).  ``steps`` skips the recount when the caller
    already knows the bound.  Returns numpy ``(fin, diestat, lane)``.
    """
    dev = resolve_device(device)
    if steps is None:
        steps = count_steps(ops)
    capq, capw = ring_caps(ops, n_dies) if caps is None else caps
    pip = np.broadcast_to(np.asarray(pipelined, np.float64),
                          (ops.shape[0],))
    aug = torch.as_tensor(augment_ops(ops, pipelined), dtype=torch.float64,
                          device=dev)
    tim = torch.as_tensor(np.concatenate(
        [np.asarray(timing, np.float64), pip[:, None]], axis=1), device=dev)
    fin, diestat, lane = fcfs_core_fwd(aug, tim, steps, n_dies=n_dies,
                                       capq=capq, capw=capw, prio=prio)
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


def fused_core(ops: np.ndarray, n_dies: int, pipelined,
               timing: np.ndarray, prio: bool, caps=None, steps=None,
               device=None):
    """Run one launch over the lanes of many stacked cells.

    ``ops`` is the (C*L, MAXP, 7) cell-stacked padded table (cell c's
    lanes occupy rows [c*L, (c+1)*L)), ``timing`` the matching (C*L, 3)
    per-lane [tdma, tecc, age_bound] rows, ``pipelined`` one flag or a
    (C*L,) array of per-lane flags.  ``prio`` must be uniform across the
    stacked cells.  Returns the same triple
    as :func:`fcfs_core`; rows [c*L, (c+1)*L) are cell c's, bit-identical
    to a separate :func:`fcfs_core` run (the cell-axis law restated by
    :func:`ref.fused_core_ref`).
    """
    if timing.shape != (ops.shape[0], 3):
        raise ValueError(
            f"timing shape {timing.shape} != ({ops.shape[0]}, 3)")
    return _dispatch(ops, n_dies, pipelined, np.asarray(timing, np.float64),
                     prio, caps=caps, steps=steps, device=device)
