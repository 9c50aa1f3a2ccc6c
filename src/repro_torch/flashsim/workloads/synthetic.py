"""Synthetic MMPP workload profiles with distinct I/O characteristics.

The paper evaluates on twelve real-world block traces.  Traces are not
redistributable, so we generate statistically-shaped equivalents covering
the same axes the paper varies: read ratio (read-dominant vs mixed),
request size, arrival burstiness, and intensity — plus a logical-span
axis that the write-heavy FTL/GC profiles (``GC_PROFILES``) shrink to
force overwrites and garbage collection.  Profiles are named after the
MSR-Cambridge / enterprise classes they emulate.

Arrivals are a Markov-modulated Poisson process (bursty <-> idle phases);
sizes are drawn from a small-page-biased geometric mixture, matching the
4-64 KiB concentration of the original traces.

**Stability contract**: :func:`generate_trace` / :func:`cached_trace`
are deterministic per ``(profile, seed)`` and pinned bit-for-bit by
``tests/test_workloads.py`` against checksums recorded before the
workloads package refactor — the generator here is the pre-refactor
module's, moved verbatim.  Real ingested traces validate the generator's
*shapes* through :func:`~repro_torch.flashsim.workloads.stats.trace_stats`.
"""

from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Dict, Tuple

import numpy as np

from repro_torch.flashsim.workloads.base import (
    RequestTrace,
    TraceSource,
    Workload,
    freeze_trace,
)

#: The six profiles (read ratio / intensity / size / burstiness all vary).
PROFILES = (
    Workload("websearch", read_ratio=0.99, iops=14000, burstiness=2.0, mean_pages=1.6),
    Workload("ycsb-b",    read_ratio=0.95, iops=20000, burstiness=1.0, mean_pages=1.0),
    Workload("graph",     read_ratio=0.98, iops=15000, burstiness=3.0, mean_pages=1.2),
    Workload("usr",       read_ratio=0.91, iops=9000,  burstiness=2.5, mean_pages=2.2),
    Workload("oltp",      read_ratio=0.70, iops=18000, burstiness=1.5, mean_pages=1.0),
    Workload("prxy",      read_ratio=0.55, iops=12000, burstiness=2.0, mean_pages=1.4),
)

#: Write-heavy MMPP profiles for the FTL/GC regime (MSR-Cambridge print/
#: research/source-control server classes: write-dominated traffic
#: re-walking a small hot span).  Sustained small-span overwrites are
#: what fill the over-provisioned capacity and keep the garbage
#: collector busy — the contention regime the in-place simulator could
#: never reach.  ``src`` mixes in a substantial read fraction so the
#: scheduler sweep (host-read priority / GC preemption) measures the
#: read tail on a statistically meaningful read population.
GC_PROFILES = (
    Workload("prn",   read_ratio=0.11, iops=16000, burstiness=2.0,
             mean_pages=1.6, span_pages=1 << 13),
    Workload("rsrch", read_ratio=0.09, iops=10000, burstiness=3.0,
             mean_pages=1.1, span_pages=1 << 12),
    Workload("src",   read_ratio=0.30, iops=14000, burstiness=2.0,
             mean_pages=1.3, span_pages=1 << 13),
)


def make_workloads() -> Dict[str, Workload]:
    """Name -> profile map over the paper's six profiles + GC profiles."""
    return {w.name: w for w in PROFILES + GC_PROFILES}


def generate_trace(w: Workload, seed: int = 0) -> RequestTrace:
    """Generate a trace for a profile (deterministic per seed).

    The per-profile salt is a stable CRC32 of the name — ``hash(str)`` is
    randomized per process, which silently made traces unreproducible
    across runs.
    """
    rng = np.random.default_rng(seed ^ zlib.crc32(w.name.encode()))
    n = w.n_requests

    # MMPP arrivals: alternate burst (rate*burstiness) and idle phases so
    # the long-run mean rate is w.iops.
    if w.burstiness > 1.0:
        # Half the *requests* arrive in bursts at r_burst = b * iops; the
        # idle-phase rate is set so the long-run mean gap is 1/iops:
        #   0.5/r_burst + 0.5/r_idle = 1/iops.
        b = w.burstiness
        r_burst = b * w.iops
        r_idle = 0.5 * w.iops / max(1.0 - 0.5 / b, 1e-6)
        # Phases are sustained over runs of ~64 requests.
        run = 64
        idx = np.arange(n) // run
        phase_of_run = rng.random(idx.max() + 1) < 0.5
        burst_mask = phase_of_run[idx]
        gaps = np.where(
            burst_mask,
            rng.exponential(1e6 / r_burst, n),
            rng.exponential(1e6 / r_idle, n),
        )
    else:
        gaps = rng.exponential(1e6 / w.iops, n)
    arrival = np.cumsum(gaps)

    is_read = rng.random(n) < w.read_ratio
    # Geometric page counts with the requested mean (>= 1 page).
    p = min(1.0 / w.mean_pages, 1.0)
    n_pages = rng.geometric(p, n).clip(1, 64)
    start_page = rng.integers(0, w.span_pages, n)
    return RequestTrace(arrival, is_read, n_pages.astype(np.int64), start_page)


@functools.lru_cache(maxsize=128)
def cached_trace(w: Workload, seed: int = 0) -> RequestTrace:
    """Memoized :func:`generate_trace` — one trace per (workload, seed).

    Mechanism sweeps (``compare_mechanisms``/``simulate_batch``) call this
    so every mechanism sees the *same* arrivals without regenerating the
    trace.  The arrays are marked read-only: treat the result as immutable
    (call :func:`generate_trace` for a private copy).
    """
    return freeze_trace(generate_trace(w, seed=seed))


@dataclasses.dataclass(frozen=True)
class SyntheticSource(TraceSource):
    """A :class:`TraceSource` over one synthetic :class:`Workload` profile.

    With an empty transform chain, ``trace(seed)`` delegates straight to
    :func:`cached_trace` — byte-identical arrays, same memoization — so
    wrapping a profile in a source costs nothing and changes nothing.
    Transforms route through the shared :class:`TraceSource` machinery.
    """

    workload: Workload
    transforms: Tuple = ()

    @property
    def name(self) -> str:
        return self.workload.name

    def _build(self, seed: int) -> RequestTrace:
        return cached_trace(self.workload, seed=seed)

    def cache_key(self, seed: int) -> tuple:
        return ("synthetic", dataclasses.astuple(self.workload),
                tuple(t.key for t in self.transforms), seed)

    def trace(self, seed: int = 0) -> RequestTrace:
        if not self.transforms:           # exact legacy path, exact cache
            return cached_trace(self.workload, seed=seed)
        return super().trace(seed)
