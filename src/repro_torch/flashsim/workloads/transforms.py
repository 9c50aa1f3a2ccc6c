"""Composable trace transforms.

Real block traces rarely fit the simulator as-recorded: an hour-long MSR
volume replayed verbatim would idle the device for minutes between
bursts, its LBA footprint is a sparse scatter across a terabyte span,
and a 10^6-row file is far past what a per-PR benchmark cell needs.
Each transform here is a small frozen dataclass mapping
``RequestTrace -> RequestTrace``:

  * :class:`TimeRescale` — scale arrival times to a target IOPS (or by a
    rate factor), preserving relative burst structure;
  * :class:`DenseRemap`  — bijective remap of the touched logical pages
    onto the dense range ``[0, footprint)``, preserving request order
    and intra-request contiguity (what FTL auto-OP sizing and die
    striping want to see);
  * :class:`RWFilter`    — keep only reads or only writes;
  * :class:`Window`      — keep requests with arrivals in ``[start, end)``
    (rebased to 0);
  * :class:`Truncate`    — keep the first N requests in arrival order;
  * :class:`Subsample`   — seeded Bernoulli thinning (per-request keep
    probability), the sampling axis mechanism sweeps use for multi-seed
    confidence intervals on deterministic file traces.

Transforms are applied by :meth:`TraceSource.trace` in chain order; each
receives a seed derived from ``(run seed, chain position, transform
key)``, so chains are deterministic under a fixed seed and repeated
transforms draw independent streams.  ``key`` is the transform's
structural identity inside trace cache keys and the registry grammar.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.flashsim.workloads.base import RequestTrace, touched_pages


def _take(trace: RequestTrace, idx: np.ndarray,
          rebase_time: bool = False) -> RequestTrace:
    """A sub-trace at request indices ``idx`` (file order preserved)."""
    if idx.size == 0:
        raise ValueError(
            "transform selected zero requests — widen the Window/filter "
            "or raise the Subsample fraction"
        )
    arrival = trace.arrival_us[idx].astype(np.float64, copy=True)
    if rebase_time:
        arrival -= float(arrival.min())
    return RequestTrace(
        arrival_us=arrival,
        is_read=trace.is_read[idx].copy(),
        n_pages=trace.n_pages[idx].copy(),
        start_page=trace.start_page[idx].copy(),
    )


@dataclasses.dataclass(frozen=True)
class TimeRescale:
    """Scale arrival times so the trace replays at a different intensity.

    Exactly one of ``factor`` (rate multiplier: 2.0 = twice the IOPS) or
    ``target_iops`` (absolute requests/s, measured rate computed from the
    trace span) must be set.  Gaps scale uniformly, so burst structure
    (the ratio of burst to idle rates) is preserved — only the clock
    speed changes.
    """

    #: Whether ``apply`` consumes the seed (cache-key relevance).
    seeded = False

    factor: Optional[float] = None
    target_iops: Optional[float] = None

    def __post_init__(self):
        if (self.factor is None) == (self.target_iops is None):
            raise ValueError(
                "TimeRescale needs exactly one of factor= or target_iops="
            )
        if self.factor is not None and self.factor <= 0:
            raise ValueError(f"factor must be > 0, got {self.factor}")
        if self.target_iops is not None and self.target_iops <= 0:
            raise ValueError(
                f"target_iops must be > 0, got {self.target_iops}"
            )

    @property
    def key(self) -> str:
        if self.factor is not None:
            return f"rescale({self.factor!r})"
        return f"rescale(iops={self.target_iops!r})"

    def apply(self, trace: RequestTrace, seed: int = 0) -> RequestTrace:
        arrival = trace.arrival_us.astype(np.float64, copy=True)
        lo = float(arrival.min())
        if self.factor is not None:
            factor = self.factor
        else:
            span_s = (float(arrival.max()) - lo) / 1e6
            if span_s <= 0:
                raise ValueError(
                    "TimeRescale(target_iops=...) needs a trace with a "
                    "positive time span"
                )
            measured = len(trace) / span_s
            factor = self.target_iops / measured
        arrival = lo + (arrival - lo) / factor
        return RequestTrace(
            arrival_us=arrival,
            is_read=trace.is_read.copy(),
            n_pages=trace.n_pages.copy(),
            start_page=trace.start_page.copy(),
        )


@dataclasses.dataclass(frozen=True)
class DenseRemap:
    """Remap the touched logical pages onto the dense range [0, footprint).

    Real traces scatter a few hundred MB of touched data across terabyte
    LBA spans.  The remap is a bijection on the *touched* page set (sorted
    order preserved, so spatially-close pages stay close) and keeps every
    request's pages contiguous: a request's interval ``[s, s+n)`` is
    entirely touched, hence consecutive in the sorted unique page array,
    hence mapped to consecutive dense ids.  Downstream this is what makes
    ``PageMapFTL`` auto-OP sizing see the real footprint rather than the
    raw sparse span, and what spreads die striping (``page % n_dies``)
    evenly for strided address patterns.
    """

    #: Whether ``apply`` consumes the seed (cache-key relevance).
    seeded = False

    @property
    def key(self) -> str:
        return "dense"

    def apply(self, trace: RequestTrace, seed: int = 0) -> RequestTrace:
        touched = touched_pages(trace)
        start = np.searchsorted(touched, np.asarray(trace.start_page,
                                                    np.int64))
        return RequestTrace(
            arrival_us=trace.arrival_us.astype(np.float64, copy=True),
            is_read=trace.is_read.copy(),
            n_pages=trace.n_pages.copy(),
            start_page=start.astype(np.int64),
        )


@dataclasses.dataclass(frozen=True)
class RWFilter:
    """Keep only reads (``keep="read"``) or only writes (``keep="write"``)."""

    #: Whether ``apply`` consumes the seed (cache-key relevance).
    seeded = False

    keep: str = "read"

    def __post_init__(self):
        if self.keep not in ("read", "write"):
            raise ValueError(
                f"RWFilter.keep must be 'read' or 'write', got {self.keep!r}"
            )

    @property
    def key(self) -> str:
        return f"rw({self.keep})"

    def apply(self, trace: RequestTrace, seed: int = 0) -> RequestTrace:
        mask = trace.is_read if self.keep == "read" else ~trace.is_read
        return _take(trace, np.flatnonzero(mask))


@dataclasses.dataclass(frozen=True)
class Window:
    """Keep requests whose arrival falls in ``[start_us, end_us)``.

    Arrivals are rebased so the window starts at 0 (the simulator should
    not idle through the cut prefix).
    """

    #: Whether ``apply`` consumes the seed (cache-key relevance).
    seeded = False

    start_us: float = 0.0
    end_us: float = float("inf")

    def __post_init__(self):
        if self.end_us <= self.start_us:
            raise ValueError(
                f"Window needs start_us < end_us, got "
                f"[{self.start_us}, {self.end_us})"
            )

    @property
    def key(self) -> str:
        return f"window({self.start_us!r},{self.end_us!r})"

    def apply(self, trace: RequestTrace, seed: int = 0) -> RequestTrace:
        a = trace.arrival_us
        idx = np.flatnonzero((a >= self.start_us) & (a < self.end_us))
        return _take(trace, idx, rebase_time=True)


@dataclasses.dataclass(frozen=True)
class Truncate:
    """Keep the first ``n`` requests in arrival order (stable on ties)."""

    #: Whether ``apply`` consumes the seed (cache-key relevance).
    seeded = False

    n: int

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"Truncate.n must be >= 1, got {self.n}")

    @property
    def key(self) -> str:
        return f"truncate({self.n})"

    def apply(self, trace: RequestTrace, seed: int = 0) -> RequestTrace:
        if len(trace) <= self.n:
            return trace
        a = trace.arrival_us
        if np.any(np.diff(a) < 0):
            idx = np.sort(np.argsort(a, kind="stable")[: self.n])
        else:
            idx = np.arange(self.n)
        return _take(trace, idx)


@dataclasses.dataclass(frozen=True)
class Subsample:
    """Seeded Bernoulli thinning: keep each request with probability
    ``fraction`` (order preserved, arrivals untouched).

    This is the sampling axis that gives deterministic file traces a
    seed dimension: benchmark cells run the same excerpt under several
    subsample seeds and report mean ± CI, mirroring the multi-seed
    convention of the synthetic cells.
    """

    #: Whether ``apply`` consumes the seed (cache-key relevance).
    seeded = True

    fraction: float

    def __post_init__(self):
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(
                f"Subsample.fraction must be in (0, 1], got {self.fraction}"
            )

    @property
    def key(self) -> str:
        return f"sample({self.fraction!r})"

    def apply(self, trace: RequestTrace, seed: int = 0) -> RequestTrace:
        if self.fraction >= 1.0:
            return trace
        rng = np.random.default_rng(seed)
        keep = rng.random(len(trace)) < self.fraction
        return _take(trace, np.flatnonzero(keep))
