"""Trace schema and the :class:`TraceSource` abstraction.

The workload subsystem feeds the simulator flat per-request arrays
(:class:`RequestTrace`) regardless of where they came from.  Two kinds
of producers exist:

  * the **synthetic** MMPP generator (:mod:`repro_torch.flashsim.workloads.
    synthetic`) — statistically-shaped stand-ins for the paper's twelve
    real-world block traces, parameterized by a :class:`Workload`
    profile;
  * **file-backed** loaders (:mod:`repro_torch.flashsim.workloads.ingest`) —
    MSR-Cambridge CSVs and blktrace text dumps parsed into the same
    arrays.

:class:`TraceSource` unifies them: a source *names* a trace, builds it
on demand (``trace(seed)``), supports composable post-processing
(:meth:`TraceSource.with_transforms`), and carries a structural
``cache_key`` so built traces are memoized process-wide — the
content-hash-keyed extension of the synthetic layer's ``cached_trace``.
The run APIs (``simulate`` / ``compare_mechanisms`` / ``simulate_batch``)
accept a :class:`Workload`, a registry spec string (see
:mod:`repro_torch.flashsim.workloads.registry`), or any :class:`TraceSource`.
"""

from __future__ import annotations

import abc
import dataclasses
from collections import OrderedDict
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Workload:
    """One synthetic trace profile (the generator's six statistical axes)."""

    name: str
    read_ratio: float          # fraction of requests that are reads [0, 1]
    iops: float                # mean arrival rate (requests/s)
    burstiness: float          # >1: bursty MMPP; 1: plain Poisson
    mean_pages: float          # mean request size (16 KiB pages)
    n_requests: int = 20000    # trace length (requests)
    #: Logical address-space footprint (pages).  The paper's read-dominant
    #: profiles roam a large cold span; write-heavy FTL/GC profiles use a
    #: small span so sustained writes overwrite hot data, fill the
    #: over-provisioned capacity, and force garbage collection.
    span_pages: int = 1 << 22

    @property
    def read_dominant(self) -> bool:
        return self.read_ratio >= 0.90


@dataclasses.dataclass
class RequestTrace:
    """Flat arrays describing one trace (generated or externally loaded).

    Requests touch ``n_pages`` consecutive logical pages starting at
    ``start_page``; the simulator stripes logical pages across dies.
    Construction validates the schema (:meth:`validate`), so a malformed
    ingested trace fails loudly instead of corrupting the page-op
    expansion downstream.
    """

    arrival_us: np.ndarray     # (N,) arrival times (us; need not be sorted)
    is_read: np.ndarray        # (N,) bool: True = read, False = write
    n_pages: np.ndarray        # (N,) request length (16 KiB pages)
    start_page: np.ndarray     # (N,) first logical page number

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Schema check; raises ``ValueError`` with the specific defect.

        Enforced invariants: all four arrays 1-D with equal lengths;
        arrivals finite and non-negative; ``is_read`` boolean;
        ``n_pages``/``start_page`` integer dtypes with ``n_pages >= 1``
        and ``start_page >= 0``.
        """
        arrays = {
            "arrival_us": self.arrival_us, "is_read": self.is_read,
            "n_pages": self.n_pages, "start_page": self.start_page,
        }
        for fname, a in arrays.items():
            if not isinstance(a, np.ndarray):
                raise ValueError(
                    f"RequestTrace.{fname} must be a numpy array, "
                    f"got {type(a).__name__}"
                )
            if a.ndim != 1:
                raise ValueError(
                    f"RequestTrace.{fname} must be 1-D, got shape {a.shape}"
                )
        n = self.arrival_us.shape[0]
        for fname, a in arrays.items():
            if a.shape[0] != n:
                raise ValueError(
                    f"RequestTrace arrays must have equal lengths: "
                    f"arrival_us has {n}, {fname} has {a.shape[0]}"
                )
        if n == 0:
            raise ValueError("RequestTrace must hold at least one request")
        if self.is_read.dtype != np.bool_:
            raise ValueError(
                f"RequestTrace.is_read must be bool, got {self.is_read.dtype}"
            )
        for fname in ("n_pages", "start_page"):
            a = arrays[fname]
            if not np.issubdtype(a.dtype, np.integer):
                raise ValueError(
                    f"RequestTrace.{fname} must be an integer dtype, "
                    f"got {a.dtype}"
                )
        if not np.isfinite(self.arrival_us).all():
            raise ValueError("RequestTrace.arrival_us has non-finite entries")
        if self.arrival_us.size and float(self.arrival_us.min()) < 0.0:
            raise ValueError(
                f"RequestTrace.arrival_us must be non-negative "
                f"(min={float(self.arrival_us.min())!r})"
            )
        if int(self.n_pages.min()) < 1:
            raise ValueError(
                f"RequestTrace.n_pages must be >= 1 "
                f"(min={int(self.n_pages.min())})"
            )
        if int(self.start_page.min()) < 0:
            raise ValueError(
                f"RequestTrace.start_page must be >= 0 "
                f"(min={int(self.start_page.min())})"
            )

    def __len__(self) -> int:
        return int(self.arrival_us.shape[0])


def touched_pages(trace: RequestTrace) -> np.ndarray:
    """Sorted unique logical pages the trace touches (its footprint).

    A request covers the interval ``[start_page, start_page + n_pages)``;
    the union of all intervals, flattened and deduplicated.  Shared by
    the dense-footprint remap (:mod:`~repro_torch.flashsim.workloads.
    transforms`) and :func:`~repro_torch.flashsim.workloads.stats.trace_stats`.
    """
    n_pages = np.asarray(trace.n_pages, np.int64)
    starts = np.asarray(trace.start_page, np.int64)
    total = int(n_pages.sum())
    base = np.cumsum(n_pages) - n_pages
    off = np.arange(total, dtype=np.int64) - np.repeat(base, n_pages)
    return np.unique(np.repeat(starts, n_pages) + off)


def freeze_trace(trace: RequestTrace) -> RequestTrace:
    """Mark a trace's arrays read-only (shared/cached traces are immutable)."""
    for a in (trace.arrival_us, trace.is_read, trace.n_pages,
              trace.start_page):
        a.setflags(write=False)
    return trace


#: Process-wide built-trace cache: ``TraceSource.cache_key(seed)`` ->
#: frozen RequestTrace.  The file-backed analogue of the synthetic
#: layer's ``functools.lru_cache`` on ``cached_trace`` — keys embed the
#: source identity (file content hash for file sources) and the
#: transform chain, so a changed file or chain never aliases.  Bounded
#: like its synthetic counterpart: LRU-evicted past ``_TRACE_CACHE_MAX``
#: entries, so long seeded sweeps over large traces don't grow memory
#: without limit.
_TRACE_CACHE: "OrderedDict[tuple, RequestTrace]" = OrderedDict()
_TRACE_CACHE_MAX = 128


def clear_trace_cache() -> None:
    """Drop every memoized source-built trace (test/tooling hook)."""
    _TRACE_CACHE.clear()


class TraceSource(abc.ABC):
    """A named producer of :class:`RequestTrace` objects.

    Subclasses implement :meth:`_build` (construct the raw trace for a
    seed) and :meth:`cache_key`.  :meth:`trace` adds the shared behavior:
    transform application (deterministic per seed) and process-wide
    memoization with read-only arrays — callers must treat results as
    immutable, exactly like ``cached_trace``.
    """

    #: Human-readable identity (registry spec or profile name).
    name: str = "<anonymous>"
    #: Composable post-processing chain, applied in order by ``trace()``.
    transforms: Tuple = ()

    @abc.abstractmethod
    def _build(self, seed: int) -> RequestTrace:
        """Construct the raw (pre-transform) trace for ``seed``."""

    @abc.abstractmethod
    def cache_key(self, seed: int) -> tuple:
        """Structural identity of ``trace(seed)`` — must change whenever
        the built arrays could (source content, parameters, transforms)."""

    def trace(self, seed: int = 0) -> RequestTrace:
        """The (memoized, frozen) trace for ``seed``.

        The raw build — and the longest deterministic (unseeded) prefix
        of the transform chain — is memoized separately through a
        shorter-chain copy of this source, so a seeded chain over an
        expensive build (``"msr:<1M rows>?sample=0.85"``: parse + dense
        remap, then Bernoulli thinning) pays the parse and the remap
        once and re-runs only the seeded tail per seed.
        """
        key = self.cache_key(seed)
        t = _TRACE_CACHE.get(key)
        if t is None:
            chain = self.transforms
            if chain:
                n_det = 0
                for tf in chain:
                    if getattr(tf, "seeded", True):
                        break
                    n_det += 1
                # Recurse on a strictly shorter chain (the all-
                # deterministic case keeps n_det=0 -> raw build, since
                # its cache_key already collapses the seed where legal).
                if n_det == len(chain):
                    n_det = 0
                base = dataclasses.replace(self, transforms=chain[:n_det])
                t = base.trace(seed)
                for j in range(n_det, len(chain)):
                    t = chain[j].apply(
                        t, seed=self._transform_seed(seed, j, chain[j]))
            else:
                t = self._build(seed)
            t = freeze_trace(t)
            _TRACE_CACHE[key] = t
            if len(_TRACE_CACHE) > _TRACE_CACHE_MAX:
                _TRACE_CACHE.popitem(last=False)
        else:
            _TRACE_CACHE.move_to_end(key)
        return t

    @staticmethod
    def _transform_seed(seed: int, index: int, transform) -> int:
        """Per-transform RNG seed: deterministic in (seed, chain position,
        transform identity), so identical chains replay identically and
        repeated transforms in one chain draw independent streams."""
        import zlib

        tag = f"{index}:{getattr(transform, 'key', repr(transform))}"
        return (seed ^ zlib.crc32(tag.encode())) & 0x7FFFFFFF

    def with_transforms(self, *transforms) -> "TraceSource":
        """A copy of this source with ``transforms`` appended to the chain.

        Concrete sources are frozen dataclasses carrying a ``transforms``
        field, so this is a structural copy — the original is untouched.
        """
        return dataclasses.replace(
            self, transforms=tuple(self.transforms) + tuple(transforms)
        )

    # -- conveniences --------------------------------------------------------

    def stats(self, seed: int = 0):
        """Measured :class:`~repro_torch.flashsim.workloads.stats.TraceStats`."""
        from repro_torch.flashsim.workloads.stats import trace_stats

        return trace_stats(self.trace(seed))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        tf = f", transforms={list(self.transforms)!r}" if self.transforms \
            else ""
        return f"{type(self).__name__}({self.name!r}{tf})"
