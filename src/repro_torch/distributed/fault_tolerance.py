"""Fault-tolerance control plane: heartbeats, stragglers, restart policy.

The reference's ``repro.distributed.fault_tolerance``, which is plain
Python: the *policy* layer a launcher runs beside its process group
(``torch.distributed`` runs the ranks; every clock is injectable):

  * ``HeartbeatMonitor`` — workers report per-step heartbeats; a worker
    whose heartbeat age exceeds ``dead_after_s`` is declared dead (node
    failure -> restart from checkpoint on a shrunken mesh, see
    elastic.py); one whose *step time* exceeds ``straggler_factor`` times
    the fleet median is flagged a straggler.
  * ``StragglerMitigator`` — deadline-based re-dispatch of input shards:
    a straggler's next input shard is speculatively duplicated onto the
    fastest healthy worker (work stealing); whichever copy finishes first
    wins.  This is the PR² discipline at the fleet level: the speculative
    duplicate overlaps the slow path instead of waiting for it to fail.
  * ``RestartPolicy`` — decides between in-place retry (transient), mesh
    shrink (dead node), and abort (too many failures in a window).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class WorkerState:
    worker_id: int
    last_heartbeat: float
    last_step: int = 0
    step_times: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=32)
    )
    alive: bool = True

    def mean_step_time(self) -> float:
        return float(np.mean(self.step_times)) if self.step_times else 0.0


class HeartbeatMonitor:
    def __init__(self, n_workers: int, dead_after_s: float = 60.0,
                 straggler_factor: float = 2.0, clock=time.monotonic):
        self.clock = clock
        self.dead_after_s = dead_after_s
        self.straggler_factor = straggler_factor
        now = self.clock()
        self.workers: Dict[int, WorkerState] = {
            i: WorkerState(i, now) for i in range(n_workers)
        }

    def beat(self, worker_id: int, step: int, step_time_s: float):
        w = self.workers[worker_id]
        w.last_heartbeat = self.clock()
        w.last_step = step
        w.step_times.append(step_time_s)
        w.alive = True

    def dead_workers(self) -> List[int]:
        now = self.clock()
        out = []
        for w in self.workers.values():
            if w.alive and now - w.last_heartbeat > self.dead_after_s:
                w.alive = False
            if not w.alive:
                out.append(w.worker_id)
        return out

    def stragglers(self) -> List[int]:
        times = [
            w.mean_step_time() for w in self.workers.values()
            if w.alive and w.step_times
        ]
        if len(times) < 2:
            return []
        median = float(np.median(times))
        if median <= 0:
            return []
        return [
            w.worker_id
            for w in self.workers.values()
            if w.alive and w.step_times
            and w.mean_step_time() > self.straggler_factor * median
        ]


class StragglerMitigator:
    """Deadline-based speculative re-dispatch of input shards."""

    def __init__(self, monitor: HeartbeatMonitor):
        self.monitor = monitor
        self.duplicated: Dict[int, int] = {}   # shard -> backup worker
        self.n_duplicates = 0

    def plan(self, step: int, shard_owner: Dict[int, int]) -> Dict[int, int]:
        """Given shard->owner, return shard->backup for straggler owners."""
        stragglers = set(self.monitor.stragglers())
        if not stragglers:
            return {}
        healthy = sorted(
            (
                w for w in self.monitor.workers.values()
                if w.alive and w.worker_id not in stragglers
            ),
            key=lambda w: w.mean_step_time() or float("inf"),
        )
        if not healthy:
            return {}
        plan = {}
        hi = 0
        for shard, owner in shard_owner.items():
            if owner in stragglers:
                plan[shard] = healthy[hi % len(healthy)].worker_id
                hi += 1
        self.duplicated.update(plan)
        self.n_duplicates += len(plan)
        return plan


@dataclasses.dataclass
class RestartDecision:
    action: str          # "retry" | "shrink" | "abort"
    dead_workers: Tuple[int, ...] = ()
    reason: str = ""


class RestartPolicy:
    def __init__(self, max_failures_per_hour: int = 8):
        self.max_per_hour = max_failures_per_hour
        self.failures: deque = deque()

    def on_failure(
        self, monitor: HeartbeatMonitor, transient: bool, now=None
    ) -> RestartDecision:
        now = time.monotonic() if now is None else now
        self.failures.append(now)
        while self.failures and now - self.failures[0] > 3600.0:
            self.failures.popleft()
        if len(self.failures) > self.max_per_hour:
            return RestartDecision("abort", reason="failure budget exhausted")
        dead = tuple(monitor.dead_workers())
        if transient and not dead:
            return RestartDecision("retry", reason="transient, all alive")
        return RestartDecision(
            "shrink", dead_workers=dead,
            reason=f"{len(dead)} dead worker(s): restart on shrunken mesh",
        )
