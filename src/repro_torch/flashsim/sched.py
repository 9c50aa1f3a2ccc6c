"""Die-queue scheduling policies for the array event-core.

The event core (:mod:`repro_torch.flashsim.engine`) serves each die through one
queue object.  This module is the policy layer: it defines the queue
disciplines and the registry the config/run API validates against.  Three
policies ship:

``fcfs``
    Strict arrival order — the pre-refactor behavior, bit-identical to
    the original monolithic engine (the queue *is* a ``collections.deque``
    and the event core drives it with the same append/popleft sequence).

``host_prio``
    Two-class priority: host reads always dequeue before anything else
    (host programs, GC copy-back reads/programs, erases).  Within a
    class, order stays FIFO.  This models firmware that reorders the die
    command queue in favor of latency-critical host reads but never
    interrupts an operation already on the die.

``host_prio_aged``
    ``host_prio`` with a **starvation bound**: under a sustained
    100%-read phase plain host_prio can park a queued GC program or
    erase forever (free blocks never reclaim, and with online GC the
    device eventually wedges on writes).  Here a waiting low-priority op
    *ages*: once ``age_bound`` host reads have dequeued past a waiting
    GC/program op, the next dispatch serves the low class first.  The
    head-of-line low op is therefore bypassed at most ``age_bound``
    times — bounded staleness for GC work, near-host_prio read latency
    otherwise.  The bound is configurable through the registry name:
    ``"host_prio_aged:8"`` (default 16).

``tokens``
    Per-die **read/write token budgets** (deficit-round-robin style):
    while both classes are backlogged, each dispatch round serves up to
    ``r`` host reads and then up to ``w`` low-priority ops (host
    programs, GC copy-back, erases), so reads keep priority but writes
    are guaranteed ``w`` slots per ``r + w`` dispatches — a smoother
    bandwidth split than ``host_prio_aged``'s all-or-nothing aging.
    Budgets only meter *contention*: when one class is empty the other
    is served immediately (work conservation) and the round resets, so
    an uncontended die behaves exactly like FIFO-within-class.
    Configured through the registry name: ``"tokens:6,2"``
    (default ``tokens`` = 8 reads / 2 writes).

``preempt``
    ``host_prio`` ordering *plus* read-suspend firmware semantics: an
    in-flight GC operation yields the die to a waiting host read —
    erases and GC programs suspend immediately and later resume with
    their residual time; GC reads suspend at retry-attempt boundaries
    and resume with their remaining attempts (completed attempts are
    never re-executed).  Host operations are never suspended.  Suspended
    ops re-enter at the *front* of the low-priority class so GC work
    resumes in service order.

Queue protocol (duck-typed, engine-facing)
------------------------------------------
``append(op)``      enqueue a ready op (policy decides the class);
``pop_next()``      dequeue the next op to serve;
``resume_push(op)`` re-enqueue a suspended op at the front of its class;
``has_host()``      True when a host read is waiting (preemption probe);
truthiness / ``len()``  queue emptiness / total queued ops.

``FCFSQueue`` subclasses ``deque`` so ``append`` / ``__bool__`` stay
C-speed on the hot path; ``pop_next`` aliases ``deque.popleft``.

Closed-loop frontend
--------------------
The closed-loop interpreter (``engine.run_closed_loop``, selected with
``ncq_depth=``) reuses these same queue objects for die scheduling, so
``fcfs`` / ``host_prio`` / ``host_prio_aged`` / ``tokens`` all work
unchanged under NCQ admission.  ``preempt`` is the exception: its
suspend/resume bookkeeping lives in the open-loop event core only, so
combining ``sched="preempt"`` with ``ncq_depth=`` raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: Registered policy names, in documentation order.  ``host_prio_aged``
#: also accepts a bound suffix (``"host_prio_aged:8"``); ``tokens`` a
#: budget suffix (``"tokens:6,2"``).
SCHEDULERS: Tuple[str, ...] = (
    "fcfs", "host_prio", "host_prio_aged", "tokens", "preempt"
)

#: Host reads that dequeue past a waiting low-priority op before it ages
#: to the front (``host_prio_aged`` default).
DEFAULT_AGE_BOUND = 16

#: Default per-round (read, write) dispatch budgets for ``tokens``.
DEFAULT_TOKEN_BUDGETS = (8, 2)


class FCFSQueue(deque):
    """Strict-FIFO die queue — a ``deque`` with the queue protocol.

    ``append``/``__bool__``/``__len__`` are inherited C implementations,
    so the fcfs hot path pays nothing for the abstraction.
    """

    __slots__ = ()

    pop_next = deque.popleft
    resume_push = deque.appendleft  # unused under fcfs (nothing suspends)

    def has_host(self) -> bool:  # pragma: no cover - preempt-only probe
        return False


class HostPrioQueue:
    """Two-class die queue: host reads (hi) jump everything else (lo).

    ``host_read`` is the engine's per-op host-read table (a growing list
    — online GC appends ops mid-run; the reference is shared, so new ops
    classify correctly).  FIFO within each class.  Superpage-parity
    rebuild reads injected by the fault-recovery ladder carry
    ``host_read=True``: they gate a blocked host request, so they jump
    GC traffic exactly like the read they are rebuilding.
    """

    __slots__ = ("hi", "lo", "_host")

    def __init__(self, host_read: Sequence[bool]):
        self.hi: deque = deque()
        self.lo: deque = deque()
        self._host = host_read

    def append(self, op: int) -> None:
        (self.hi if self._host[op] else self.lo).append(op)

    def pop_next(self) -> int:
        hi = self.hi
        return hi.popleft() if hi else self.lo.popleft()

    def resume_push(self, op: int) -> None:
        # Suspended ops are never host reads: front of the low class.
        self.lo.appendleft(op)

    def has_host(self) -> bool:
        return bool(self.hi)

    def __bool__(self) -> bool:
        return bool(self.hi) or bool(self.lo)

    def __len__(self) -> int:
        return len(self.hi) + len(self.lo)


class AgedHostPrioQueue(HostPrioQueue):
    """Host-priority die queue with a starvation bound (GC aging).

    Counts how many high-priority (host-read) dispatches have bypassed
    the waiting low class; at ``age_bound`` the next dispatch serves the
    low class and the counter resets.  The counter also resets whenever
    the low class drains or is served naturally, so the bound is per
    head-of-line wait, not cumulative.
    """

    __slots__ = ("age_bound", "_bypassed")

    def __init__(self, host_read: Sequence[bool],
                 age_bound: int = DEFAULT_AGE_BOUND):
        super().__init__(host_read)
        if age_bound < 1:
            raise ValueError(f"age_bound must be >= 1, got {age_bound}")
        self.age_bound = age_bound
        self._bypassed = 0

    def pop_next(self) -> int:
        hi, lo = self.hi, self.lo
        if hi and lo and self._bypassed >= self.age_bound:
            self._bypassed = 0
            return lo.popleft()       # aged: GC/program jumps the reads
        if hi:
            if lo:
                self._bypassed += 1
            return hi.popleft()
        self._bypassed = 0
        return lo.popleft()


class TokenBudgetQueue(HostPrioQueue):
    """Two-class die queue metered by per-round read/write token budgets.

    Deficit-round-robin over the two classes of :class:`HostPrioQueue`:
    while **both** classes are backlogged, a round spends up to
    ``r_budget`` read tokens (host reads, served first) and then up to
    ``w_budget`` write tokens (everything else); when the write tokens
    exhaust, the round resets.  Budgets meter contention only — a
    dispatch finding one class empty serves the other immediately *and*
    resets the round, so the budget bound is per contention interval:
    once both classes are backlogged, at most ``r_budget`` reads dequeue
    before a write does, and writes can never take more than
    ``w_budget`` consecutive slots from waiting reads.

    Work conservation is structural: ``pop_next`` always dispatches when
    the queue is non-empty, tokens decide only *which class* goes first.
    """

    __slots__ = ("r_budget", "w_budget", "r_tok", "w_tok")

    def __init__(self, host_read: Sequence[bool],
                 r_budget: int = DEFAULT_TOKEN_BUDGETS[0],
                 w_budget: int = DEFAULT_TOKEN_BUDGETS[1]):
        super().__init__(host_read)
        if r_budget < 1 or w_budget < 1:
            raise ValueError(
                f"token budgets must be >= 1, got ({r_budget}, {w_budget})"
            )
        self.r_budget = r_budget
        self.w_budget = w_budget
        self.r_tok = r_budget
        self.w_tok = w_budget

    def pop_next(self) -> int:
        hi, lo = self.hi, self.lo
        if not lo:                       # uncontended: serve, reset round
            self.r_tok = self.r_budget
            self.w_tok = self.w_budget
            return hi.popleft()
        if not hi:
            self.r_tok = self.r_budget
            self.w_tok = self.w_budget
            return lo.popleft()
        if self.r_tok > 0:               # contended: reads spend first
            self.r_tok -= 1
            return hi.popleft()
        self.w_tok -= 1
        op = lo.popleft()
        if self.w_tok <= 0:              # write tokens spent: new round
            self.r_tok = self.r_budget
            self.w_tok = self.w_budget
        return op


@dataclasses.dataclass(frozen=True)
class SchedulerPolicy:
    """One die-queue scheduling policy (registry entry).

    ``prioritized`` selects the two-class queue; ``preemptive`` addition-
    ally arms the engine's suspend/resume paths.  The queue factory gets
    the engine's per-op host-read table (may grow during the run).

    ``ring_lowering`` is the policy's batched-kernel lowering descriptor
    (:mod:`repro_torch.flashsim.engine_batched` /
    :mod:`repro_torch.kernels.fcfs_core`): ``("fifo", 0.0)`` for the single
    FIFO ring, ``("prio", bound)`` for the dual host/low priority rings
    where ``bound`` is the aging bound (``math.inf`` = plain
    ``host_prio`` — the low class never ages to the front), or ``None``
    when the policy has no lockstep lowering (``tokens``, ``preempt``)
    and the batched engine must reject it.  The descriptor is metadata
    only: the Python queue objects above remain the semantic reference
    the kernel is bit-pinned against.
    """

    name: str
    prioritized: bool
    preemptive: bool
    make_queue: Callable[[Sequence[bool]], object]
    ring_lowering: Optional[Tuple[str, float]] = None

    def make_queues(self, n_dies: int, host_read: Sequence[bool]) -> List:
        return [self.make_queue(host_read) for _ in range(n_dies)]


_REGISTRY: Dict[str, SchedulerPolicy] = {
    "fcfs": SchedulerPolicy(
        "fcfs", prioritized=False, preemptive=False,
        make_queue=lambda host_read: FCFSQueue(),
        ring_lowering=("fifo", 0.0),
    ),
    "host_prio": SchedulerPolicy(
        "host_prio", prioritized=True, preemptive=False,
        make_queue=HostPrioQueue,
        # Plain host_prio == aged with an infinite bound: the low class
        # never jumps the reads.  One compiled dual-ring kernel serves
        # both (the bound is a traced scalar).
        ring_lowering=("prio", math.inf),
    ),
    "host_prio_aged": SchedulerPolicy(
        "host_prio_aged", prioritized=True, preemptive=False,
        make_queue=AgedHostPrioQueue,
        ring_lowering=("prio", float(DEFAULT_AGE_BOUND)),
    ),
    "tokens": SchedulerPolicy(
        "tokens", prioritized=True, preemptive=False,
        make_queue=TokenBudgetQueue,
    ),
    "preempt": SchedulerPolicy(
        "preempt", prioritized=True, preemptive=True,
        make_queue=HostPrioQueue,
    ),
}

#: Policies that accept a ``:arg`` suffix (and what the arg means).
_SUFFIXED = ("host_prio_aged", "tokens")


def get_scheduler(name: str) -> SchedulerPolicy:
    """Resolve a policy by name (raises ``ValueError`` on unknown names).

    ``host_prio_aged`` accepts an optional starvation bound suffix —
    ``"host_prio_aged:8"`` ages a waiting GC/program op to the front
    after 8 bypassing host reads (default ``DEFAULT_AGE_BOUND``).
    ``tokens`` accepts a ``:reads,writes`` budget suffix —
    ``"tokens:6,2"`` serves up to 6 host reads then up to 2 low-priority
    ops per contended round (default ``DEFAULT_TOKEN_BUDGETS``).
    """
    base, sep, arg = name.partition(":")
    policy = _REGISTRY.get(base)
    if policy is None or (sep and (base not in _SUFFIXED or not arg)):
        raise ValueError(
            f"unknown scheduler {name!r} (choose from {SCHEDULERS}; only "
            f"host_prio_aged takes a ':bound' suffix and tokens a "
            f"':reads,writes' suffix)"
        )
    if not arg:
        return policy
    if base == "host_prio_aged":
        try:
            bound = int(arg)
        except ValueError:
            raise ValueError(
                f"scheduler {name!r}: age bound must be an integer"
            ) from None
        if bound < 1:
            raise ValueError(
                f"scheduler {name!r}: age bound must be >= 1"
            )
        return dataclasses.replace(
            policy, name=name,
            make_queue=lambda host_read: AgedHostPrioQueue(host_read, bound),
            ring_lowering=("prio", float(bound)),
        )
    parts = arg.split(",")
    try:
        budgets = tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(
            f"scheduler {name!r}: token budgets must be integers "
            f"(expected 'tokens:reads,writes')"
        ) from None
    if len(budgets) != 2:
        raise ValueError(
            f"scheduler {name!r}: token budgets must be 'reads,writes' "
            f"(two comma-separated integers)"
        )
    r, w = budgets
    if r < 1 or w < 1:
        raise ValueError(
            f"scheduler {name!r}: token budgets must be >= 1"
        )
    return dataclasses.replace(
        policy, name=name,
        make_queue=lambda host_read: TokenBudgetQueue(host_read, r, w),
    )
