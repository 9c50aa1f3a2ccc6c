"""Per-rank cost of one step, counted while it runs: the port's
counterpart of the reference's ``launch/hlo_cost.py``.

The reference parses the partitioned HLO text of a compiled cell.  The
port has no HLO: it runs the step eagerly, on fake tensors over a fake
process group in the dry-run (``launch.dryrun``), or on real tensors,
and counts what it dispatches, rank 0's share:

  * FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``: the
    products (``mm``, ``bmm``, ``addmm``, ...: 2 * M * N * K, the
    reference's ``dot``) and the two custom ops of the model steps
    (``repro_torch::flash_attention``, B4, and ``repro_torch::ssd_scan``,
    B5) by their FLOP formulas, which are the reference's analytic
    counts of its kernel stand-ins (``custom-call(kernel)``).
    :func:`breakdown` splits them into ``dot`` and ``kernel``.
    Elementwise arithmetic is not counted (the reference's ``analyze``
    adds one per element, its ``breakdown`` does not);
  * bytes are the eager, unfused bytes: every dispatched op that is not
    a view or an allocation adds its tensor operands' and outputs'
    bytes (a kernel's, like the reference's custom-call, its operands
    and results).  A fused program moves fewer;
  * transcendentals: one per output element of exp, log, tanh, rsqrt,
    sqrt, sigmoid, sin, cos, erf, pow and their kin, softmax included;
  * collectives: every one the step issues, functional
    (``_c10d_functional``: DTensor's redistributions) or c10d
    (``torch.distributed.all_reduce``, ``broadcast``), by kind: its
    output bytes on this rank and its ring traffic for a group of k
    (:data:`RING`, the reference's multipliers); a broadcast counts as
    a collective-permute (it moves its output once), and a collective
    over a group of one rank moves nothing and is not counted (XLA drops
    it from the reference's program);
  * memory: the peak of the live storages the step made, outputs
    included while they live (the eager ``temp``).

Python loops run unrolled, so every layer and every trip is counted as
it runs: nothing needs the trip-count repair that ``hlo_cost`` makes for
``while`` bodies.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: Ring traffic per output byte of a collective over a group of k ranks
#: (the reference's ``launch/dryrun.py:collective_bytes``): all-gather's
#: output is the gathered tensor, reduce-scatter's the shard.
RING = {
    "all-gather": lambda k: (k - 1) / k,
    "reduce-scatter": lambda k: float(k - 1),
    "all-reduce": lambda k: 2.0 * (k - 1) / k,
    "all-to-all": lambda k: (k - 1) / k,
    "collective-permute": lambda k: 1.0,
}

#: Collective ops by name (in the ``_c10d_functional`` and ``c10d``
#: namespaces), and their kind.
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d")

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "rsqrt", "sqrt", "sigmoid", "sin", "cos", "tan", "erf", "erfc", "pow",
    "silu", "gelu", "_softmax", "_log_softmax", "softplus", "logit",
}
#: Ops that move no bytes: allocations and bookkeeping.
_NO_BYTES = {
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "wait_tensor", "_local_scalar_dense", "item",
    "lift_fresh", "lift_fresh_copy", "detach", "alias",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> list:
    """The tensors in nested tuples, lists and dicts (an op's arguments
    and outputs), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


def _group_size(args, kwargs) -> int:
    """Ranks of the collective's process group (1 if it names none)."""
    for a in tree_flatten((args, kwargs))[0]:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject):      # a c10d op's group
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue
        if isinstance(a, str) and dist.is_initialized():
            try:
                return dist.distributed_c10d._resolve_process_group(
                    a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
    return 1


@dataclasses.dataclass
class Cost:
    """One rank's cost of a step (the reference's ``hlo_cost.Cost``)."""

    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in KINDS})
    coll_traffic: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in KINDS})
    coll_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in KINDS})


_DEVICE = torch.ops.prim.device.default


def _op_info(func) -> tuple:
    """(op key, collective kind or None, moves bytes, transcendental,
    outputs are fresh storages) of an op: an output that aliases an
    input (a view, an in-place or ``out=`` op) is not a storage the op
    made."""
    ns, _, op = func._schema.name.partition("::")
    kind = COLLECTIVES.get(op) if ns in _COLLECTIVE_NS else None
    aliased = func.is_view or any(r.alias_info is not None
                                  for r in func._schema.returns)
    return (f"{ns}.{op}", kind, not (func.is_view or op in _NO_BYTES),
            op in _TRANSCENDENTAL, not aliased)


class _Counter(TorchDispatchMode):
    """Counts bytes, transcendentals, collectives, op calls and the live
    storages of every op dispatched below it."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.bytes_by = collections.Counter()
        self.calls = collections.Counter()
        self.live = 0
        self.peak = 0
        self._info = {}
        self._refs = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _DEVICE:          # most calls of a fake trace; no cost
            return out
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _op_info(func)
        key, kind, moves, trans, fresh = info
        self.calls[key] += 1
        outs = _tensors(out)
        out_b = sum(_nbytes(t) for t in outs)
        k = _group_size(args, kwargs) if kind is not None else 1
        if k > 1:
            c = self.cost
            c.coll_bytes[kind] += out_b
            c.coll_traffic[kind] += out_b * RING[kind](k)
            c.coll_counts[kind] += 1
        if moves:
            moved = out_b + sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.cost.bytes += moved
            self.bytes_by[key] += moved
        if trans:
            self.cost.transcendentals += sum(t.numel() for t in outs)
        if fresh and outs:
            # An output on an input's storage is not one the op made,
            # whatever its schema says (``_unsafe_view``).
            taken = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
            for t in outs:
                st = t.untyped_storage()
                if id(st) in taken:
                    continue
                taken.add(id(st))
                n = st.nbytes()
                self.live += n
                if self.live > self.peak:
                    self.peak = self.live
                self._refs.add(weakref.ref(st, self._freer(n)))
        return out

    def _freer(self, n: int):
        def free(ref):
            self.live -= n
            self._refs.discard(ref)
        return free


@dataclasses.dataclass
class Trace:
    """What :func:`trace` counted: the cost, the FLOPs by op, the bytes
    by op, each op's calls, the peak of the live storages the step made
    (bytes), the step's output and its seconds."""

    cost: Cost
    flops_by_op: Dict[str, int]
    bytes_by_op: Dict[str, float]
    calls: Dict[str, int]
    peak_bytes: int
    out: object
    seconds: float

    def breakdown(self) -> Dict[str, float]:
        """FLOPs as the reference's ``breakdown`` splits them: ``dot``
        (the products) and ``kernel`` (the custom ops of B4 and B5)."""
        kernel = sum(v for k, v in self.flops_by_op.items()
                     if k.startswith("repro_torch."))
        return {"dot": float(sum(self.flops_by_op.values()) - kernel),
                "kernel": float(kernel)}


def trace(fn, *args, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` once under the counters (on one
    thread: the backward runs on the caller's, so the fake tensor mode
    and the counters see it) and return what they counted."""
    counter = _Counter()
    flop = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with torch.autograd.set_multithreading_enabled(False), flop, counter:
        out = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    by_op = {str(k): int(v) for k, v in
             flop.get_flop_counts().get("Global", {}).items()}
    counter.cost.flops = float(sum(by_op.values()))
    return Trace(counter.cost, by_op, dict(counter.bytes_by),
                 dict(counter.calls), counter.peak, out, seconds)


def analyze(fn, *args, **kwargs) -> Cost:
    """One rank's cost of ``fn(*args, **kwargs)`` (the reference's
    ``hlo_cost.analyze``, over a run in place of HLO text)."""
    return trace(fn, *args, **kwargs).cost


def breakdown(fn, *args, top: int = 20, **kwargs):
    """(bytes by op, FLOPs as ``dot`` and ``kernel``), each as the
    ``top`` largest (name, value) pairs: the reference's
    ``hlo_cost.breakdown``, over a run."""
    tr = trace(fn, *args, **kwargs)
    bytes_by = collections.Counter(tr.bytes_by_op).most_common(top)
    flops = collections.Counter(tr.breakdown()).most_common(top)
    return bytes_by, flops


def as_dict(cost: Cost) -> dict:
    return {
        "flops": cost.flops,
        "transcendentals": cost.transcendentals,
        "bytes": cost.bytes,
        "collectives": {
            "bytes": dict(cost.coll_bytes),
            "traffic": dict(cost.coll_traffic),
            "counts": dict(cost.coll_counts),
        },
    }
